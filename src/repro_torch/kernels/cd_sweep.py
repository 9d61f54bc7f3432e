"""One sweep of coordinate descent (the baselines' CD, Friedman et al.'s
Glmnet update on the lasso's penalized form): for each position t of the
sweep's order, j = order[t] (cyclic: j = t),

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
coordinate, so the plain versions below are the CPU's route only.

Two sweeps compute that function bit for bit (the one difference: the sign
of a zero that the unscreened sweep writes over a zero it leaves at zero).

**The unscreened sweep** (``cd_sweep_unscreened``, the card's yardstick):
one block walks all p positions, a chain of p dependent reductions (each
dot needs the residual the update before it left):

- the residual in registers, 4 entries a thread on 32 to 1024 threads (m
  up to 4,096; one warp at m <= 128, whose butterfly sum needs no block
  barrier); a block of several warps adds the warps' partials in warp
  order, so every thread holds the same bits and the sweep is
  deterministic;
- the columns stream through a ring of up to 16 stages in shared memory,
  filled by 4-byte ``cp.async`` copies up to 15 columns ahead of the
  chain. 4-byte copies because a row of m floats starts at m*4*j bytes,
  16-byte aligned only for some j (Pyrim's 296-byte rows), and a bf16 row
  of odd m starts mid-word; the order's entries ride the same ring two
  stages ahead, and ||z_j||^2 beside the column;
- a_j is read from device memory in the chain, when its position comes,
  never prefetched with the column: a stochastic order repeats rows. A
  row repeated back to back takes the value the position before wrote;
- past the registers (m > 4,096) the residual lives in shared memory
  where it fits (m up to 57,344) and in place in device memory past that,
  the columns read straight from device memory;
- rho, the division and R -= d z_j are separate ``_rn`` intrinsics in the
  plain version's op order (no FMA contraction).

**The screened sweep** (``cd_sweep``, the path's): almost no coordinate
can move in a sweep (a warm Pyrim sweep moves 30 of its 201,376), and a
position t whose a_j = 0 leaves everything as it was whenever the chain's
|z_j . R_t| <= lam. Two kernels:

- ``cd_score``: one grid-wide pass, a warp a row, computes c_j = z_j . R_0
  and q_j = ||z_j||^2 (f32) and writes row j's headroom h_j and norm bound
  nz_j. It is hand-written rather than ``torch.mv`` because the same pass
  also gives q_j (the screen relies on no caller's zn2), rounds h_j and
  nz_j in the safe direction in f64, and reads a bf16 design without a
  widened copy: one read of Xt, 8 bytes written a row.
- ``cd_walk``: one block walks the order from a position. Each turn its
  threads test a window of 4 positions a thread against the running bound
  B and ballot the survivors (a_j != 0, or B > h_j); the first survivor
  runs on H's threads (``sweep_plan(m)``: the same element-to-thread map,
  the same warp-order sums, the same ``cd_step``, shared device functions).
  A survivor's column is read straight from device memory: survivors come
  about one to a window, so a ring of columns copied ahead of the chain
  (as H's) found nothing to overlap and cost 0.01-0.15 ms a sweep on the
  shapes measured (``scripts/cd_sweep_breakdown.py``). a_j is read at its
  position, with the back-to-back forwarding above.

The screen. Let u = 2^-24 and G = 2 (m + 64) u (at least twice the
relative error gamma of any f32 dot or sum of squares of m terms, in any
order: the chain's 4 fmas a thread, 5 butterfly levels and up to 32 warp
partials are at most m + 64 roundings a term). The score pass bounds
||R_0|| <= rn and ||z_j|| <= nz_j by rounding sqrt((sum + m 2^-149) / (1 -
G)) up (2^-149 an element covers an underflowed square), and |c_j - z_j .
R_0| <= G nz_j rn + m 2^-149. The walker keeps B >= ||R_t - R_0||, the
drift of the chain's own (rounded) residual since the walk began. After a
move d of a row of norm bound nz, grow(B) = (B + (1 + 2^-22) |d| nz +
2^-22 rn + m 2^-126) (1 + 2^-21), rounded up (the kernel in f32 with
round-up intrinsics, the plain version in f64): each element of R -= d z
rounds by at most u |d z_i| + u/(1-u) |R_i|, ||R_t|| <= rn + B, and 2^-126
m covers underflow. On the ring route the chain also sums ||R - R_0||^2
beside each survivor's dot (R in registers beside R_0); its bound D (as
nz_j's, times 1 + 2^-22 for the f32 differences) gives B <- min(grow(B),
grow(D)) (D alone when d = 0): the moves' directions partly cancel, so D
is often far below the moves' sum (on an H100 it cuts the dense-width
10-point path's survivors 4.3x and its sweeps' device time by 40%, the
Pyrim path's survivors by 12%; ``scripts/cd_sweep_breakdown.py``). Then
the chain's dot at t is at most

    |z_j . R_t| + G nz_j ||R_t|| + m 2^-149
        <= |c_j| + nz_j B + rho_j,   rho_j = nz_j (2 G rn + G B) + m 2^-148,

which is <= lam when B <= h_j = ((lam - |c_j| - m 2^-148) / nz_j - 2 G
rn) / (1 + G), lowered by 2^-40 of its terms' size for the f64 arithmetic
and rounded down to f32. rho_j so covers the score pass's rounding (G nz_j
rn), the chain's own dot (G nz_j ||R_t||), the residual updates' rounding
(in B: the drift is that of the rounded R) and the square roots (rounded
up). With a_j = 0, rho = dot + 0 =
dot, |rho| <= lam gives a_new = +-0, d = +-0, R and max_delta unchanged:
skipping is exact. A NaN h_j (a non-finite zn2_j or c_j) never skips.

Re-base: B grows with the moves, so as they pile up more positions
survive that then stay at zero (idle survivors). After ``rebase_threshold(p, m)`` idle
survivors the walk ends at its position; the score pass runs again on the
current R and a new walk starts after it with B = 0. Walker launches =
sweeps + re-bases; each walk ends with one host read of its position (the
sweep's stopping read rides the last).

Bound on an H100 (unscreened and screened alike): a sweep must read each
column once (p*m*e bytes, e = 4 f32, 2 bf16), ||z||^2 (p*4), alpha read
and written (p*8), the order when one is given (p*8) and the residual (8*m;
59.6 MB at Pyrim's m = 74, p = 201,376: 18 us at 3.35 TB/s); the screened
sweep also writes and reads its scores (p*4, ``screened_bytes``); the
walker alone needs far less (``walk_bytes``: the survivors' columns and the
chunks' least headrooms).
``chain_floor`` times p dependent warp sums alone: the unscreened chain's
own floor.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float]
             + [ctypes.c_int] * 5 + [ctypes.c_longlong, ctypes.c_void_p])
_SCORE_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                            ctypes.c_double, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_void_p])
_WALK_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float]
                  + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
_FLOOR_ARGTYPES = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]

SMEM_BYTES = 224 * 1024  # the dynamic shared memory a block may take (OPTIN_SMEM_BYTES)
MAX_SLOTS = 16  # the column ring's stages at most (CD_MAX_SLOTS)
ORDER_RING = 32  # order entries staged ahead (CD_ORDER_RING)
RING_MAX_M = 4 * 1024  # 4 residual entries a thread, at most 1024 threads (CD_RPT)
ROUTES = {"ring": 0, "direct": 1}  # csrc/cd_sweep.cu's route codes
WALK_MIN_THREADS = 512  # the walker's block at least: 4 window positions a thread (CW_E)
WINDOW_PER_THREAD = 4  # CW_E
SCORE_BLOCKS = 132 * 8  # the score pass's grid: 8 blocks of 256 threads an SM
CHUNK = 256  # rows of a score chunk (CW_CHUNK): its least headroom lets a cyclic walk skip it
# Re-base cost model (H100 80GB HBM3, 700 W): a score pass (its bytes at
# the 2.9 TB/s it reached at the paper's dense width, plus ~30 us of launches
# and the walk's host read) against an idle survivor's turn of the chain
# (~2 us at m = 74 and 800); a walk ends after that many idle survivors.
REBASE_FIXED_S = 30e-6
REBASE_BYTES_PER_S = 2.9e12
IDLE_SURVIVOR_S = 2.0e-6
_U = 2.0 ** -24


class SweepPlan(NamedTuple):
    route: str  # 'ring' (R in registers), 'direct' (R in smem or device memory)
    threads: int
    slots: int  # the column ring's stages (0: no ring)
    slot_words: int  # 4-byte words a stage takes
    smem_bytes: int  # dynamic shared memory

    @property
    def residual_on_chip(self) -> bool:
        return self.route != "direct" or self.smem_bytes > 0


class WalkPlan(NamedTuple):
    route: str  # as the unscreened sweep's for the same m and dtype
    threads: int  # the block: the window's testers
    chain_threads: int  # the first threads, which run a survivor: sweep_plan(m).threads
    smem_bytes: int  # dynamic shared memory: the direct route's staged residual


def _slot_words(m: int, esize: int) -> int:
    """Words of a stage: the row's bytes from its 4-byte aligned floor (a
    bf16 row may start mid-word), in whole 16-byte chunks."""
    words = -(-m * esize // 4) + (1 if esize == 2 else 0)
    return -(-words // 4) * 4


def _esize(dtype: torch.dtype) -> int:
    return 4 if dtype == torch.float32 else 2


def sweep_plan(m: int, dtype: torch.dtype = torch.float32) -> SweepPlan:
    """The unscreened kernel's route for a residual of ``m`` and a design of
    ``dtype``: the residual in registers on the fewest threads that hold
    it, the ring as deep as shared memory allows (2 to 16 stages); past
    4,096 the residual in shared memory (where it fits) or in device memory."""
    esize = _esize(dtype)
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


def walk_plan(m: int, dtype: torch.dtype = torch.float32) -> WalkPlan:
    """The walker's route: the unscreened sweep's route and chain threads
    (so a survivor's arithmetic is its bits), in a block of at least
    ``WALK_MIN_THREADS`` testers; on the ring route R stays in registers
    and the walker takes no dynamic shared memory."""
    pl = sweep_plan(m, dtype)
    if pl.route == "ring":
        return WalkPlan("ring", max(pl.threads, WALK_MIN_THREADS), pl.threads, 0)
    return WalkPlan("direct", 1024, 1024, pl.smem_bytes)


def rebase_threshold(p: int, m: int, dtype: torch.dtype = torch.float32) -> int:
    """The idle survivors after which a walk ends for a re-base: a score
    pass's cost (``REBASE_*``) over an idle survivor's (``IDLE_SURVIVOR_S``)."""
    score_s = REBASE_FIXED_S + p * m * _esize(dtype) / REBASE_BYTES_PER_S
    return max(16, math.ceil(score_s / IDLE_SURVIVOR_S))


def sweep_bytes(p: int, m: int, dtype: torch.dtype, ordered: bool) -> int:
    """The bytes a sweep must move: each column, ||z||^2, alpha read and
    written and (when one is given) the order once, the residual read and
    written once."""
    return p * m * _esize(dtype) + p * 4 + p * 8 + (p * 8 if ordered else 0) + 8 * m


def screened_bytes(p: int, m: int, dtype: torch.dtype, ordered: bool) -> int:
    """A screened sweep's bound: ``sweep_bytes`` and its scores (written
    by the score pass, read by the walk: p*4)."""
    return sweep_bytes(p, m, dtype, ordered) + p * 4


def walk_bytes(p: int, m: int, dtype: torch.dtype, survivors: int, walks: int,
               ordered: bool) -> int:
    """The walker's own bytes over a sweep's walks on this data: a cyclic
    walk must read each chunk's least headroom (an ordered one the order,
    each position's headroom and a_j); each survivor's column, ||z||^2, nz
    and headroom read and a_j read and written; R read and written a walk."""
    scan = p * 16 if ordered else -(-p // CHUNK) * 4
    return scan + survivors * (m * _esize(dtype) + 20) + walks * 8 * m


def score_bytes(p: int, m: int, dtype: torch.dtype) -> int:
    """The score pass's bytes: each column, zn2 and R read, the headroom
    and the norm bound written."""
    return p * m * _esize(dtype) + p * 4 + m * 4 + p * 8


class ScreenStats:
    """What the screened sweeps did since ``reset``: sweeps, walks (walker
    launches, or plain walks on the CPU), re-bases (walks - sweeps),
    positions (p a sweep), survivors (positions whose update ran) and idle
    survivors (run with a_j = 0 and left at 0)."""

    FIELDS = ("sweeps", "walks", "rebases", "positions", "survivors", "idle")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        for f in self.FIELDS:
            setattr(self, f, 0)

    def snapshot(self) -> dict:
        return {f: getattr(self, f) for f in self.FIELDS}

    def _add(self, p: int, walks: int, survivors: int, idle: int) -> None:
        self.sweeps += 1
        self.walks += walks
        self.rebases += walks - 1
        self.positions += p
        self.survivors += survivors
        self.idle += idle


STATS = ScreenStats()


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


def _update_plain(Xt, alpha, R, zn2, n2_floor, lam: float, j: int) -> torch.Tensor:
    """Coordinate j's update (the reference's ``coord_update``) in f32,
    ``alpha`` and ``R`` in place; returns d (0-d)."""
    zj = Xt[j].float()
    aj = alpha[j]  # a view: read before the row's store below
    rho = torch.dot(zj, R) + aj * zn2[j]
    a_new = torch.sign(rho) * torch.clamp_min(torch.abs(rho) - lam, 0.0) / n2_floor[j]
    d = a_new - aj
    R.sub_(d * zj)
    alpha[j] = a_new
    return d


def cd_sweep_plain(Xt: torch.Tensor, alpha: torch.Tensor, R: torch.Tensor,
                   zn2: torch.Tensor, lam: float, order: Optional[torch.Tensor] = None):
    """The unscreened sweep's plain PyTorch version: the reference's
    ``coord_update`` at every position, in f32 (the design widened),
    ``alpha`` and ``R`` updated in place. Returns ``max_delta`` (0-d f32)."""
    _check(Xt, alpha, R, zn2, order)
    lam = _build.f32(lam)
    n2_floor = torch.clamp_min(zn2, 1e-12)
    max_delta = torch.zeros((), dtype=torch.float32, device=R.device)
    rows = range(Xt.shape[0]) if order is None else order.tolist()
    for j in rows:
        d = _update_plain(Xt, alpha, R, zn2, n2_floor, lam, j)
        max_delta = torch.maximum(max_delta, torch.abs(d))
    return max_delta


def screen_gamma(m: int) -> float:
    """G: twice the relative rounding of an f32 dot of m terms and the
    chain's sums (see the module docstring)."""
    return 2.0 * (m + 64) * _U


def _norm_up(q64: torch.Tensor, m: int, G: float) -> torch.Tensor:
    return torch.sqrt((q64 + m * 2.0 ** -149) / (1.0 - G)) * (1.0 + 2.0 ** -50)


def _f32_rounded(x64: torch.Tensor, up: bool) -> torch.Tensor:
    """x64 (f64) as f32, rounded up or down (NaN stays NaN)."""
    x = x64.float()
    inf = torch.full_like(x, math.inf if up else -math.inf)
    off = x.double() < x64 if up else x.double() > x64
    return torch.where(off, torch.nextafter(x, inf), x)


def cd_score_plain(Xt: torch.Tensor, R: torch.Tensor, zn2: torch.Tensor,
                   alpha: torch.Tensor, lam: float):
    """The score pass's plain version: ``(head, nz, rn, cmin)``, row j's
    headroom h_j (f32, rounded down; NaN where zn2_j is not finite), its
    norm bound nz_j (f32, rounded up), the bound rn on ||R|| (a float) and
    each chunk of ``CHUNK`` rows' least headroom of a row with a_j = 0
    (-inf if a row has a_j != 0 or a NaN headroom)."""
    m = Xt.shape[1]
    G = screen_gamma(m)
    X = Xt.float()
    c = torch.mv(X, R).double()
    q = (X * X).sum(1).double()
    rn = float(_norm_up(torch.dot(R, R).double(), m, G))
    nz = _f32_rounded(_norm_up(q, m, G), up=True)
    t1 = (_build.f32(lam) - c.abs() - m * 2.0 ** -148) / nz.double()
    t2 = 2.0 * G * rn
    h = (t1 - t2) / (1.0 + G) - 2.0 ** -40 * (t1.abs() + t2)
    h = _f32_rounded(torch.where(torch.isfinite(zn2), h, torch.full_like(h, math.nan)), up=False)
    v = torch.where((alpha == 0) & ~torch.isnan(h), h, torch.full_like(h, -math.inf))
    pad = -v.numel() % CHUNK
    cmin = torch.cat([v, v.new_full((pad,), math.inf)]).view(-1, CHUNK).amin(1)
    return h, nz, rn, cmin


def _grow(B: float, d: float, nzj: float, rn: float, m: int) -> float:
    """B after a move d of a row of norm bound nzj (``cw_grow``, in f64)."""
    return (B + abs(d) * nzj * (1.0 + 2.0 ** -22) + rn * 2.0 ** -22 + m * 2.0 ** -126) * (
        1.0 + 2.0 ** -21)


_PLAIN_WINDOW = 1024  # positions the plain walk tests at once


def _walk_plain(Xt, alpha, R, zn2, n2_floor, lam, order, head, nz, rn, pos, limit, max_delta):
    """The walker's plain version from position ``pos``: the next survivor by
    a vectorised test of a window, its update as ``cd_sweep_plain``'s.
    Returns the next position, max_delta, the survivors and the idle ones."""
    p, m = Xt.shape
    hpos = (head if order is None else head[order]).double()
    G = screen_gamma(m)
    R0 = R.clone()
    B, surv, idle = 0.0, 0, 0
    while pos < p:
        end = min(p, pos + _PLAIN_WINDOW)
        rows = (torch.arange(pos, end, device=alpha.device) if order is None
                else order[pos:end])
        alive = torch.nonzero((alpha[rows] != 0) | ~(hpos[pos:end] >= B))
        if alive.numel() == 0:
            pos = end
            continue
        t = pos + int(alive[0, 0])
        j = t if order is None else int(order[t])
        a_old = float(alpha[j])
        diff = (R - R0).double()
        D = float(_norm_up(torch.dot(diff, diff), m, G)) * (1.0 + 2.0 ** -22)
        d = _update_plain(Xt, alpha, R, zn2, n2_floor, lam, j)
        max_delta = torch.maximum(max_delta, torch.abs(d))
        dv, nzj = float(d), float(nz[j])
        if dv != 0.0:
            B = _grow(B, dv, nzj, rn, m)
        B = min(B, _grow(D, dv, nzj, rn, m) if dv != 0.0 else D)
        surv += 1
        idle += a_old == 0.0 and float(alpha[j]) == 0.0
        pos = t + 1
        if limit and idle >= limit:
            break
    return pos, max_delta, surv, idle


def cd_sweep_screened_plain(Xt: torch.Tensor, alpha: torch.Tensor, R: torch.Tensor,
                            zn2: torch.Tensor, lam: float, order: Optional[torch.Tensor] = None,
                            *, rebase_after: Optional[int] = None) -> torch.Tensor:
    """The screened sweep's plain version: the score pass and the walks of
    ``cd_sweep`` in PyTorch, the same screen and re-base rule; bit for bit
    ``cd_sweep_plain`` (zeros' signs aside). Returns ``max_delta``."""
    _check(Xt, alpha, R, zn2, order)
    p, m = Xt.shape
    lam = _build.f32(lam)
    limit = rebase_threshold(p, m, Xt.dtype) if rebase_after is None else rebase_after
    n2_floor = torch.clamp_min(zn2, 1e-12)
    max_delta = torch.zeros((), dtype=torch.float32, device=R.device)
    pos, walks, surv, idle = 0, 0, 0, 0
    while pos < p:
        head, nz, rn, _ = cd_score_plain(Xt, R, zn2, alpha, lam)
        pos, max_delta, s, i = _walk_plain(Xt, alpha, R, zn2, n2_floor, lam, order, head, nz,
                                           rn, pos, limit, max_delta)
        walks, surv, idle = walks + 1, surv + s, idle + i
    if p:
        STATS._add(p, walks, surv, idle)
    return max_delta


def _operands(Xt, alpha, R, zn2, order):
    ops = (Xt, alpha, R, zn2) + (() if order is None else (order,))
    dev = _build.require_cuda(*ops)
    if Xt.data_ptr() % 4:
        raise ValueError("cd_sweep copies the design in 4-byte words: Xt must be 4-byte aligned")
    return dev


def cd_score(Xt: torch.Tensor, R: torch.Tensor, zn2: torch.Tensor, alpha: torch.Tensor,
             lam: float, head: torch.Tensor, nz: torch.Tensor, cmin: torch.Tensor,
             r0n: torch.Tensor) -> None:
    """One launch of the score pass on the card: ``head`` and ``nz`` (p,)
    f32, ``cmin`` (ceil(p / CHUNK),) f32 and ``r0n`` (0-d f64) written
    (``cd_score_plain``'s values, up to the dots' rounding)."""
    dev = _build.require_cuda(Xt, R, zn2, alpha, head, nz, cmin, r0n)
    p, m = Xt.shape
    fn = _build.function("cd_sweep", "cd_score_launch", _SCORE_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(Xt.data_ptr(), R.data_ptr(), zn2.data_ptr(), alpha.data_ptr(), head.data_ptr(),
                 nz.data_ptr(), cmin.data_ptr(), r0n.data_ptr(), p, m, _build.f32(lam),
                 screen_gamma(m), _build.dtype_code(Xt),
                 max(1, min(SCORE_BLOCKS, -(-p // CHUNK))), _build.stream(dev))
        cd_score.launches += 1
    _build.check("cd_sweep", err, "cd_score")


cd_score.launches = 0


def cd_walk(Xt: torch.Tensor, alpha: torch.Tensor, R: torch.Tensor, zn2: torch.Tensor,
            order: Optional[torch.Tensor], head: torch.Tensor, nz: torch.Tensor,
            cmin: torch.Tensor, r0n: torch.Tensor, max_delta: torch.Tensor, io: torch.Tensor,
            lam: float, limit: int) -> None:
    """One launch of the walker from position ``io[0]`` (int64 (3,): the
    position, then the survivors and idle survivors it adds to); ``alpha``,
    ``R`` and ``max_delta`` updated in place. No host read."""
    dev = _operands(Xt, alpha, R, zn2, order)
    p, m = Xt.shape
    wp = walk_plan(m, Xt.dtype)
    fn = _build.function("cd_sweep", "cd_walk_launch", _WALK_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(Xt.data_ptr(), alpha.data_ptr(), R.data_ptr(), zn2.data_ptr(),
                 None if order is None else order.data_ptr(), head.data_ptr(), nz.data_ptr(),
                 cmin.data_ptr(), r0n.data_ptr(), max_delta.data_ptr(), io.data_ptr(), p, m,
                 _build.f32(lam), _build.dtype_code(Xt), ROUTES[wp.route], wp.threads,
                 wp.chain_threads, wp.smem_bytes, limit, _build.stream(dev))
        cd_walk.launches += 1
    _build.check("cd_sweep", err, "cd_walk")


cd_walk.launches = 0


def cd_sweep(Xt: torch.Tensor, alpha: torch.Tensor, R: torch.Tensor, zn2: torch.Tensor,
             lam: float, order: Optional[torch.Tensor] = None, *,
             rebase_after: Optional[int] = None) -> torch.Tensor:
    """One screened sweep, ``alpha`` and ``R`` updated in place; returns
    ``max_delta`` (0-d f32). ``order``: the sweep's (p,) int64 rows, None
    for cyclic; ``rebase_after``: idle survivors before a re-base (None: the
    cost model's, 0: never). A CPU tensor takes the plain version; a CUDA
    tensor launches the score pass and the walker, once a walk, with one
    host read a walk (or raises)."""
    _check(Xt, alpha, R, zn2, order)
    if Xt.device.type == "cpu":
        return cd_sweep_screened_plain(Xt, alpha, R, zn2, lam, order, rebase_after=rebase_after)
    dev = _operands(Xt, alpha, R, zn2, order)
    p, m = Xt.shape
    max_delta = torch.zeros((), dtype=torch.float32, device=dev)
    if p == 0:
        return max_delta
    limit = rebase_threshold(p, m, Xt.dtype) if rebase_after is None else rebase_after
    head = torch.empty(p, dtype=torch.float32, device=dev)
    nz = torch.empty(p, dtype=torch.float32, device=dev)
    cmin = torch.empty(-(-p // CHUNK), dtype=torch.float32, device=dev)
    r0n = torch.empty((), dtype=torch.float64, device=dev)
    io = torch.zeros(3, dtype=torch.int64, device=dev)
    walks = 0
    while True:
        cd_score(Xt, R, zn2, alpha, lam, head, nz, cmin, r0n)
        cd_walk(Xt, alpha, R, zn2, order, head, nz, cmin, r0n, max_delta, io, lam, limit)
        walks += 1
        pos, surv, idle = io.tolist()  # the walk's one host read
        if pos >= p:
            break
    STATS._add(p, walks, surv, idle)
    return max_delta


def cd_sweep_unscreened(Xt: torch.Tensor, alpha: torch.Tensor, R: torch.Tensor,
                        zn2: torch.Tensor, lam: float,
                        order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One unscreened sweep (every position), ``alpha`` and ``R`` updated in
    place; returns ``max_delta`` (0-d f32). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (or raises)."""
    _check(Xt, alpha, R, zn2, order)
    if Xt.device.type == "cpu":
        return cd_sweep_plain(Xt, alpha, R, zn2, lam, order)
    dev = _operands(Xt, alpha, R, zn2, order)
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
        cd_sweep_unscreened.launches += 1
    _build.check("cd_sweep", err, "cd_sweep")
    return max_delta


cd_sweep_unscreened.launches = 0


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
