"""Early input validation at the solver entry points (the reference's
``resilience/validate.py``).

A NaN or Inf anywhere in the design matrix or targets turns a solve into
a silent non-converging run: every sampled score goes NaN, the argmax
picks garbage, and the stall counter never fires. The engine's
``prepare_inputs`` (behind every entry point and path driver) and the
baselines call :func:`validate_inputs` before dispatching, so bad data
raises a clear ``ValueError`` naming the offending operand and its NaN/Inf
counts instead of burning a full ``max_iters`` run.

Cost: one ``isfinite`` reduction per operand per entry call, O(nnz), in
pieces of 64M elements (``isfinite`` makes a bool per element). A small
identity cache (the last 8 validated operands) makes a 100-point path pay
the check once, not per grid point. It holds weak references, so a
validated design is freed with its last user. An operand written in place
after its check is not checked again. ``REPRO_SKIP_INPUT_VALIDATION=1``
disables the check entirely.
"""
from __future__ import annotations

import os
import weakref
from collections import deque
from typing import Dict, Optional, Tuple

import torch

from repro_torch.sparse.matrix import SparseBlockMatrix

ENV_SKIP = "REPRO_SKIP_INPUT_VALIDATION"

# weak references to the operands validated last: a path driver passes the
# same Xt/y objects for every grid point, so the O(nnz) pass runs once
_RECENT: deque = deque(maxlen=8)


def validation_enabled() -> bool:
    return os.environ.get(ENV_SKIP, "0") not in ("1", "true")


def _named_arrays(Xt, y) -> Dict[str, object]:
    arrays: Dict[str, object] = {}
    if isinstance(Xt, SparseBlockMatrix):
        arrays["X.values"] = Xt.values
    elif Xt is not None:
        arrays["X"] = Xt
    if y is not None:
        arrays["y"] = y
    return arrays


def _all_finite(a: torch.Tensor) -> bool:
    """Whether every element of ``a`` is finite."""
    flat = a.reshape(-1)
    if flat.numel() == 0:
        return True
    return bool(torch.stack([torch.isfinite(c).all() for c in flat.split(1 << 26)]).all())


def _nonfinite(a) -> Optional[Tuple[int, int]]:
    """(n_nan, n_inf) when the array has non-finite entries, else None."""
    a = torch.as_tensor(a)
    if not a.is_floating_point() or _all_finite(a):
        return None
    return int(torch.isnan(a).sum()), int(torch.isinf(a).sum())


def _seen(a) -> bool:
    return any(ref() is a for ref in _RECENT)


def validate_inputs(Xt, y=None) -> None:
    """Raise ``ValueError`` if the design matrix or targets contain
    NaN/Inf. ``Xt`` may be a dense feature-major tensor or array, a
    ``SparseBlockMatrix`` (its stored values are checked), or None."""
    if not validation_enabled():
        return
    todo = {name: a for name, a in _named_arrays(Xt, y).items() if not _seen(a)}
    if not todo:
        return
    bad = {}
    for name, a in todo.items():
        counts = _nonfinite(a)
        if counts is not None:
            bad[name] = counts
    if bad:
        detail = ", ".join(
            f"{name}: {n_nan} NaN / {n_inf} Inf" for name, (n_nan, n_inf) in bad.items()
        )
        raise ValueError(
            f"non-finite values in solver inputs ({detail}) — the solver "
            "would run to max_iters without converging; clean or impute "
            f"the data, or set {ENV_SKIP}=1 to skip this check"
        )
    for a in todo.values():
        _RECENT.append(weakref.ref(a))
