"""Roofline analysis of the dry run (the port of ``repro.analysis``; H100
figures in place of the reference's TPU v5e figures)."""
from repro_torch.analysis.roofline import (
    H100,
    CostMode,
    RooflineTerms,
    collective_bytes,
    parse_collectives,
    roofline_terms,
    tally_collectives,
)

__all__ = [
    "H100",
    "CostMode",
    "RooflineTerms",
    "collective_bytes",
    "parse_collectives",
    "roofline_terms",
    "tally_collectives",
]
