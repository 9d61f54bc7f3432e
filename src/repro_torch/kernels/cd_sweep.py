"""One sweep of coordinate descent in one launch (the baselines' CD,
Friedman et al.'s Glmnet update on the lasso's penalized form): for each
position t of the sweep's order, j = order[t] (cyclic: j = t),

    rho   = z_j . R + a_j ||z_j||^2
    a_new = S_lam(rho) / max(||z_j||^2, 1e-12)
    d     = a_new - a_j;   R <- R - d z_j;   a_j <- a_new
    max_delta = max(max_delta, |d|)

``alpha`` and ``R`` (f32) are updated in place; the design ``Xt (p, m)``
is f32 or bf16, widened to f32 on load; ``max_delta`` comes back as a
0-d f32 tensor.

Replaces no ``pallas_call``: the reference runs the sweep as an XLA
``fori_loop`` of ``coord_update`` (``src/repro/core/baselines.py:70-96``).
No library call computes it, and as eager ops it is ~15 launches a
coordinate, so the plain version below is the CPU's route only.

Bound on an H100: the sweep moves p*m*e bytes of columns (e = 4 f32, 2
bf16), p*4 of ||z||^2, p*8 of alpha (read and written), p*8 of the order
when one is given, and 8*m of the residual (59.6 MB at Pyrim's m = 74, p
= 201,376: 18 us at 3.35 TB/s). It is also a chain of p dependent
reductions, one a coordinate: each dot needs the residual the update
before it left. One SM runs the chain, so the kernel sits far from its
byte bound; ``chain_floor`` times p dependent warp sums alone, the
chain's own floor.

Design: one block, one launch a sweep (``sweep_plan``):

- the residual in registers, 4 entries a thread on 32 to 1024 threads (m
  up to 4,096; one warp at m <= 128, whose butterfly sum needs no block
  barrier); a block of several warps adds the warps' partials in warp
  order, so every thread holds the same bits and the sweep is
  deterministic;
- the columns stream through a ring of up to 16 stages in shared memory,
  filled by 4-byte ``cp.async`` copies up to 15 columns ahead of the
  chain (a column's load depends on nothing before it; only its dot
  does). 4-byte copies because a row of m floats starts at m*4*j bytes,
  16-byte aligned only for some j (Pyrim's 296-byte rows), and a bf16 row
  of odd m starts mid-word; the order's entries ride the same ring two
  stages ahead, and ||z_j||^2 beside the column;
- a_j is read from device memory in the chain, when its position comes,
  never prefetched with the column: a stochastic order repeats rows, and
  a copy taken a stage ahead would miss the update in between. The
  position before's store is not yet ordered before the read by the
  barrier, so a row repeated back to back takes the value it wrote;
- past the registers (m > 4,096) the residual lives in shared memory
  where it fits (m up to 57,344) and in place in device memory past that,
  the columns read straight from device memory: the same chain, slower;
- rho, the division and R -= d z_j are separate ``_rn`` intrinsics in the
  plain version's op order (no FMA contraction), and S_lam(rho) / max(n2,
  1e-12) stays a division.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float]
             + [ctypes.c_int] * 5 + [ctypes.c_longlong, ctypes.c_void_p])
_FLOOR_ARGTYPES = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]

SMEM_BYTES = 224 * 1024  # the dynamic shared memory a block may take (OPTIN_SMEM_BYTES)
MAX_SLOTS = 16  # the column ring's stages at most (CD_MAX_SLOTS)
ORDER_RING = 32  # order entries staged ahead (CD_ORDER_RING)
RING_MAX_M = 4 * 1024  # 4 residual entries a thread, at most 1024 threads (CD_RPT)
ROUTES = {"ring": 0, "direct": 1}  # csrc/cd_sweep.cu's route codes


class SweepPlan(NamedTuple):
    route: str  # 'ring' (R in registers), 'direct' (R in smem or device memory)
    threads: int
    slots: int  # the column ring's stages (0: no ring)
    slot_words: int  # 4-byte words a stage takes
    smem_bytes: int  # dynamic shared memory

    @property
    def residual_on_chip(self) -> bool:
        return self.route != "direct" or self.smem_bytes > 0


def _slot_words(m: int, esize: int) -> int:
    """Words of a stage: the row's bytes from its 4-byte aligned floor (a
    bf16 row may start mid-word), in whole 16-byte chunks."""
    words = -(-m * esize // 4) + (1 if esize == 2 else 0)
    return -(-words // 4) * 4


def sweep_plan(m: int, dtype: torch.dtype = torch.float32) -> SweepPlan:
    """The kernel's route for a residual of ``m`` and a design of ``dtype``:
    the residual in registers on the fewest threads that hold it, the ring
    as deep as shared memory allows (2 to 16 stages); past 4,096 the
    residual in shared memory (where it fits) or in device memory."""
    esize = 4 if dtype == torch.float32 else 2
    if m <= RING_MAX_M:
        threads = 32
        while threads * 4 < m:
            threads *= 2
        sw = _slot_words(m, esize)
        for slots in range(MAX_SLOTS, 1, -1):
            smem = slots * sw * 4 + (-(-slots // 2) * 2) * 4 + ORDER_RING * 8
            if smem <= SMEM_BYTES:
                return SweepPlan("ring", threads, slots, sw, smem)
    staged = -(-m // 4) * 4 * 4
    return SweepPlan("direct", 1024, 0, 0, staged if staged <= SMEM_BYTES else 0)


def sweep_bytes(p: int, m: int, dtype: torch.dtype, ordered: bool) -> int:
    """The bytes a sweep must move: each column, ||z||^2, alpha read and
    written and (when one is given) the order once, the residual read and
    written once."""
    esize = 4 if dtype == torch.float32 else 2
    return p * m * esize + p * 4 + p * 8 + (p * 8 if ordered else 0) + 8 * m


def _check(Xt, alpha, R, zn2, order):
    if Xt.dim() != 2:
        raise ValueError(f"cd_sweep needs Xt (p, m), got {tuple(Xt.shape)}")
    p, m = Xt.shape
    if alpha.shape != (p,) or R.shape != (m,) or zn2.shape != (p,):
        raise ValueError(
            f"cd_sweep needs alpha ({p},), R ({m},) and zn2 ({p},), got "
            f"{tuple(alpha.shape)}, {tuple(R.shape)}, {tuple(zn2.shape)}")
    for name, t in (("alpha", alpha), ("R", R), ("zn2", zn2)):
        if t.dtype != torch.float32:
            raise TypeError(f"cd_sweep keeps {name} in float32, got {t.dtype}")
    if order is not None and (order.shape != (p,) or order.dtype != torch.int64):
        raise ValueError(f"the order is a ({p},) int64 tensor, got {tuple(order.shape)} "
                         f"{order.dtype}")


def cd_sweep_plain(Xt: torch.Tensor, alpha: torch.Tensor, R: torch.Tensor,
                   zn2: torch.Tensor, lam: float, order: Optional[torch.Tensor] = None):
    """The plain PyTorch version: the reference's ``coord_update`` one
    coordinate at a time, in f32 (the design widened), ``alpha`` and ``R``
    updated in place. Returns ``max_delta``, a 0-d f32 tensor."""
    _check(Xt, alpha, R, zn2, order)
    p = Xt.shape[0]
    lam = _build.f32(lam)
    n2_floor = torch.clamp_min(zn2, 1e-12)
    max_delta = torch.zeros((), dtype=torch.float32, device=R.device)
    rows = range(p) if order is None else order.tolist()
    for j in rows:
        zj = Xt[j].float()
        aj = alpha[j]  # a view: read before the row's store below
        rho = torch.dot(zj, R) + aj * zn2[j]
        a_new = torch.sign(rho) * torch.clamp_min(torch.abs(rho) - lam, 0.0) / n2_floor[j]
        d = a_new - aj
        R.sub_(d * zj)
        alpha[j] = a_new
        max_delta = torch.maximum(max_delta, torch.abs(d))
    return max_delta


def cd_sweep(Xt: torch.Tensor, alpha: torch.Tensor, R: torch.Tensor, zn2: torch.Tensor,
             lam: float, order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One sweep, ``alpha`` and ``R`` updated in place; returns
    ``max_delta`` (0-d f32). ``order``: the sweep's (p,) int64 rows, None
    for cyclic. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (or raises)."""
    _check(Xt, alpha, R, zn2, order)
    if Xt.device.type == "cpu":
        return cd_sweep_plain(Xt, alpha, R, zn2, lam, order)
    ops = (Xt, alpha, R, zn2) + (() if order is None else (order,))
    dev = _build.require_cuda(*ops)
    if Xt.data_ptr() % 4:
        raise ValueError("cd_sweep copies the design in 4-byte words: Xt must be 4-byte aligned")
    p, m = Xt.shape
    max_delta = torch.zeros((), dtype=torch.float32, device=dev)
    if p == 0:
        return max_delta
    pl = sweep_plan(m, Xt.dtype)
    fn = _build.function("cd_sweep", "cd_sweep_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(Xt.data_ptr(), alpha.data_ptr(), R.data_ptr(), zn2.data_ptr(),
                 None if order is None else order.data_ptr(), max_delta.data_ptr(), p, m,
                 _build.f32(lam), _build.dtype_code(Xt), ROUTES[pl.route], pl.threads,
                 pl.slots, pl.slot_words, pl.smem_bytes, _build.stream(dev))
        cd_sweep.launches += 1
    _build.check("cd_sweep", err, "cd_sweep")
    return max_delta


cd_sweep.launches = 0


def chain_floor(n: int, device="cuda") -> torch.Tensor:
    """Launch ``n`` dependent warp sums on one warp (the chain a sweep's
    dots sit on, without their loads): a timing yardstick, not a path
    kernel, so it has no launch count."""
    dev = torch.device(device)
    out = torch.empty((), dtype=torch.float32, device=dev)
    fn = _build.function("cd_sweep", "cd_chain_floor_launch", _FLOOR_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(n, out.data_ptr(), _build.stream(dev))
    _build.check("cd_sweep", err, "cd_chain_floor")
    return out
