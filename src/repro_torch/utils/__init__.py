"""Small shared utilities: timing on the tracer, tree helpers."""
from repro_torch.utils.timing import Timer, timed
from repro_torch.utils.trees import tree_bytes, tree_param_count

__all__ = ["Timer", "timed", "tree_bytes", "tree_param_count"]
