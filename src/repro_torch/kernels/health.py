"""The guarded solve's health check in one launch (``csrc/health.cu``):

    beta_ok = beta and scale hold no NaN or Inf
    co_ok   = the co-state's float leaves hold none
    out     = int32 [beta_ok, co_ok, stall]

It replaces no Pallas kernel: it is the port's form of the reference's
``_health_flags`` (``src/repro/resilience/guards.py:127-135``), which XLA
runs as one jitted program with one device round trip. In eager torch the
same check is ``isfinite`` and ``all`` on each tensor, a stack and a copy:
about 10 launches and a bool temporary of p bytes, every ``check_every``
chunks of the guarded loop.

Bound on an H100: bytes. It reads beta once (and the residual, and a few
scalars) and writes 12 bytes, no arithmetic to speak of. At the paper's
dense width (p = 4,272,227 f32, m = 800) that is 17.09 MB + 3.2 KB, so no
kernel beats about 5.1 us at 3.35 TB/s.

Design: the finiteness test reads bits (exponent all ones), so f32 and
bf16 share one 16-byte load path; a grid-stride pass over every tensor
ORs a block's "bad" bits, and the last block to finish (a ticket in a
scratch buffer kept per device, 0 between launches) reduces the block
partials and writes the three ints, the stall count copied beside the
flags so that one host read serves the check and the loop's stop test.
Up to 8 tensors a launch (beta, scale and six co-state leaves; the
oracles have at most four).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from repro_torch.kernels import _build

MAX_SEGS = 8
_MAX_BLOCKS = 1024  # csrc/health.cu: HEALTH_MAX_BLOCKS
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 4

_scratch: Dict[int, torch.Tensor] = {}  # device index -> partials and ticket


def health_flags_plain(beta: torch.Tensor, scale: torch.Tensor, co_leaves: Sequence[torch.Tensor],
                       stall: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``int32 [beta_ok, co_ok, stall]`` on
    beta's device."""
    beta_ok = torch.isfinite(beta).all() & torch.isfinite(scale).all()
    co_ok = torch.ones((), dtype=torch.bool, device=beta.device)
    for leaf in co_leaves:
        co_ok = co_ok & torch.isfinite(leaf).all()
    return torch.stack([beta_ok.to(torch.int32), co_ok.to(torch.int32),
                        stall.reshape(()).to(torch.int32)])


def _scratch_for(dev: torch.device) -> torch.Tensor:
    buf = _scratch.get(dev.index)
    if buf is None:
        # the block partials, then the ticket: zero once, reset by each launch
        buf = _scratch[dev.index] = torch.zeros(2 * _MAX_BLOCKS + 1, dtype=torch.int32,
                                                device=dev)
    return buf


def health_flags(beta: torch.Tensor, scale: torch.Tensor, co_leaves: Sequence[torch.Tensor],
                 stall: torch.Tensor) -> torch.Tensor:
    """``int32 [beta_ok, co_ok, stall]``: beta ``(p,)`` and the co-state's
    float leaves in f32 or bf16, ``scale`` 0-d, ``stall`` 0-d int32. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (or
    raises)."""
    if beta.device.type == "cpu":
        return health_flags_plain(beta, scale, co_leaves, stall)
    segs = [(beta, 0), (scale, 0)] + [(leaf, 1) for leaf in co_leaves]
    if len(segs) > MAX_SEGS:
        raise ValueError(f"health_flags takes at most {MAX_SEGS - 2} co-state leaves, "
                         f"got {len(co_leaves)}")
    if stall.dtype != torch.int32 or stall.numel() != 1:
        raise TypeError(f"stall must be a 0-d int32 tensor, got {stall.dtype} {tuple(stall.shape)}")
    dev = _build.require_cuda(stall, *(t for t, _ in segs))
    codes = [_build.dtype_code(t) for t, _ in segs]
    out = torch.empty(3, dtype=torch.int32, device=dev)
    n = len(segs)
    ptrs = (ctypes.c_void_p * n)(*(t.data_ptr() for t, _ in segs))
    sizes = (ctypes.c_longlong * n)(*(t.numel() for t, _ in segs))
    bf16 = (ctypes.c_int * n)(*codes)
    groups = (ctypes.c_int * n)(*(g for _, g in segs))
    fn = _build.function("health", "health_flags_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(ctypes.addressof(ptrs), ctypes.addressof(sizes), ctypes.addressof(bf16),
                 ctypes.addressof(groups), n, stall.data_ptr(), out.data_ptr(),
                 _scratch_for(dev).data_ptr(), _build.stream(dev))
        health_flags.launches += 1
    _build.check("health", err, "health_flags")
    return out


health_flags.launches = 0
