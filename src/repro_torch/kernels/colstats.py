"""K1: the fused setup pass over the design matrix (paper §4.2),

    zty[i]    = Xt[i, :] @ y
    znorm2[i] = ||Xt[i, :]||^2

in one sweep over ``Xt (p, m)``, f32 or bf16 in, f32 out.

Replaces the Pallas kernel ``colstats`` at
``src/repro/kernels/colstats/colstats.py:54`` (entry at :39).

Bound on an H100: bytes. The sweep reads Xt once and does 4 flops per
element, far below the 295-flops-per-byte line. At the paper size
(p = 4,272,227, m = 800, f32) it moves p*m*4 + m*4 + 2*p*4 bytes, about
13.7 GB, so no kernel can beat about 4.1 ms at 3.35 TB/s.

Design: one warp per feature row, so each row's m contiguous values are
read by 32 lanes side by side (16-byte loads when the row is aligned and
m is a multiple of the vector width; scalar lane-strided loads
otherwise). ``y`` is staged once per block in shared memory when it fits
(3.2 KB at m = 800), so Xt is the only stream from device memory.
Warp-shuffle sums give both outputs. There is no padding copy: the
reference zero-pads p to a multiple of 256, here rows past p are simply
not in the grid.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def colstats_plain(Xt: torch.Tensor, y: torch.Tensor):
    """The plain PyTorch version (reference ``kernels/colstats/ref.py``)."""
    X = Xt.float()
    return X @ y.float(), torch.einsum("pm,pm->p", X, X)


def colstats(Xt: torch.Tensor, y: torch.Tensor):
    """``(zty, znorm2)``, each ``(p,)`` f32. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (or raises)."""
    if Xt.dim() != 2 or y.shape != (Xt.shape[1],):
        raise ValueError(f"colstats needs Xt (p, m) and y (m,), got {tuple(Xt.shape)}, {tuple(y.shape)}")
    if Xt.device.type == "cpu":
        return colstats_plain(Xt, y)
    yf = y.float().contiguous()
    dev = _build.require_cuda(Xt, yf)
    p, m = Xt.shape
    zty = torch.empty(p, dtype=torch.float32, device=dev)
    zn2 = torch.empty(p, dtype=torch.float32, device=dev)
    if p == 0:
        return zty, zn2
    fn = _build.function("colstats", "colstats_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(Xt.data_ptr(), yf.data_ptr(), zty.data_ptr(), zn2.data_ptr(),
                 p, m, _build.dtype_code(Xt), _build.stream(dev))
        colstats.launches += 1
    _build.check("colstats", err, "colstats")
    return zty, zn2


colstats.launches = 0
