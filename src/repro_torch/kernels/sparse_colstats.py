"""K6: the setup pass over the block-ELL layout (paper §4.2),

    zty[f]    = sum_k values[f, k] * y[rows[f, k]]
    znorm2[f] = sum_k values[f, k]^2

for every feature f < p, in one sweep over the stored slots, f32 or bf16
storage, f32 out. The padded tail features are not computed (the
reference computes and slices them off).

Replaces the Pallas kernel ``sparse_colstats_fused`` at
``src/repro/kernels/sparse_colstats/sparse_colstats.py:55`` (entry at :44).

Bound on an H100: bytes. The sweep must read every value slot of the p
features (the padding is found only by reading it), the row of each
stored nonzero, and write two floats per feature: p*nnz_max*4 + nnz*4 +
2*p*4 + m*4 bytes. At the E2006-log1p size (p = 4,272,227, nnz_max 66,
137.3 M nonzeros, m = 16,087, f32) that is about 1.71 GB, about 0.51 ms
at 3.35 TB/s.

Design: one warp per feature, its slots read coalesced; y staged once per
block in shared memory (64.3 KB at m = 16,087; above 224 KB it is read
through L1/L2) and gathered from there; both sums in one read of the
slots. The grid is persistent (as many blocks of 512 threads as can
reside), so each block stages y once and strides over the features.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (values, rows, y, zty, zn2, p, nnz_max, m, dtype, stream)
_ARGTYPES = [_PTR] * 5 + [_I64, _I32, _I32, _I32, _PTR]


def sparse_colstats_plain(values, rows, y, p: int):
    """The plain PyTorch version (the XLA branch of the reference's
    ``sparse/ops.py::sparse_colstats``): f32 sums, the tail sliced off."""
    vals = values.float()
    gathered = y.float().index_select(0, rows.reshape(-1)).view(rows.shape)
    zty = (vals * gathered).sum(dim=2).reshape(-1)[:p]
    znorm2 = (vals * vals).sum(dim=2).reshape(-1)[:p]
    return zty, znorm2


def sparse_colstats(values: torch.Tensor, rows: torch.Tensor, y: torch.Tensor, p: int):
    """``(zty, znorm2)``, each ``(p,)`` f32. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (or raises)."""
    if values.dim() != 3 or rows.shape != values.shape or y.dim() != 1:
        raise ValueError(
            f"need values and rows (nblocks, bs, nnz_max) and y (m,), got "
            f"{tuple(values.shape)}, {tuple(rows.shape)}, {tuple(y.shape)}"
        )
    if not 0 <= p <= values.shape[0] * values.shape[1]:
        raise ValueError(f"p = {p} outside the {values.shape[0] * values.shape[1]} features")
    if values.device.type == "cpu":
        return sparse_colstats_plain(values, rows, y, p)
    if rows.dtype != torch.int32:
        raise TypeError(f"the row slots must be int32, got {rows.dtype}")
    yf = y.float().contiguous()
    dev = _build.require_cuda(values, rows, yf)
    zty = torch.empty(p, dtype=torch.float32, device=dev)
    zn2 = torch.empty(p, dtype=torch.float32, device=dev)
    if p == 0:
        return zty, zn2
    fn = _build.function("sparse_colstats", "sparse_colstats_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(values.data_ptr(), rows.data_ptr(), yf.data_ptr(), zty.data_ptr(),
                 zn2.data_ptr(), p, values.shape[2], yf.numel(), _build.dtype_code(values),
                 _build.stream(dev))
        sparse_colstats.launches += 1
    _build.check("sparse_colstats", err, "sparse_colstats")
    return zty, zn2


sparse_colstats.launches = 0
