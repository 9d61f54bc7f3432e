"""Feature-row zero padding (the reference's ``kernels/padding.py``).

The reference pads Xt's trailing rows to a multiple of its kernel grid's
block so that padded coordinates score exactly 0. The port's kernels need
no padding copy (a row index past p scores 0 without reading memory); the
plain versions use this to read such rows as zeros, as the reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_rows(Xt: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad Xt's leading (feature) axis up to a multiple of ``multiple``."""
    pad_p = -Xt.shape[0] % multiple
    if pad_p:
        Xt = F.pad(Xt, (0, 0, 0, pad_p))
    return Xt
