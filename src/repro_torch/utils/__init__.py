"""Small shared utilities: timing on the tracer."""
from repro_torch.utils.timing import Timer, timed

__all__ = ["Timer", "timed"]
