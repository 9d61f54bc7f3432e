"""K4 and K7: K fused FW iterations per launch, on the dense and on the
block-ELL layout, and the replay of their step records into the
coefficient state.

``dense_fused_chunk`` and ``sparse_fused_chunk`` run K = ``idx.shape[0]``
lasso FW iterations: each scores its kappa pregathered coordinates (rows
of ``Xt``; or the features' block-ELL slots) against the live residual,
takes the first max of ``|score|`` in sample order, runs the closed-form
line search (eq. 8), updates the residual (eq. 10) and the S/F recursions
with the exact refresh every ``refresh_every`` steps; steps at ``k0 + s >=
max_iters`` write their record but change no state. Each returns
``(i_star (K,), lam (K,), delta_t (K,), no_progress (K,), resid_out (m,),
(S, F, Q))``. ``fused_replay`` then applies the records to ``beta`` and
the stopping statistics with ``step_tail.apply_coeff_update``'s op sequence.

The elastic-net's chunk (an oracle with ``fused_kind = 'en'``, given
``alpha_s``, the chunk-start alpha values ``scale * beta[idx]`` in f32)
selects on the shifted score ``sel = raw + l2 * a_i``. Beta stays outside
the chunk, so ``a_i`` comes from the alpha ledger: the running product P of
``(1 - lam)`` and K slots ``(i*_t, c_t)``, each slot rescaled by ``(1 - lam)``
every step and slot t set to ``lam_t * delta_t``, so that ``a_i = P *
alpha_s + (the slots with i*_t == i)``. The winner's ``a_i`` then feeds the
EN line search and the Q = ||alpha||^2 recursion; Q's exact refresh needs
beta and is the engine's, after the replay. The ledger reassociates the
unfused ``scale * beta`` products, so an EN chunk matches the unfused EN
steps to rounding, not bit for bit (as the reference's does).

Replaces the Pallas kernel ``_fused_kernel`` at
``src/repro/kernels/fused_step/fused_step.py:259``, through its entries
``dense_fused_chunk`` (:310, ``layout='dense'``) and ``sparse_fused_chunk``
(:376, ``layout='sparse'``, with ``scatter_vmem`` at :83), the alpha ledger
(:137-139, :158-162, :226-230) included. ``fused_replay`` replaces the
reference's XLA ``fori_loop`` ``_fused_replay`` (``src/repro/core/engine.py:387``).

Bounds on an H100: bytes. A dense step reads its kappa rows once, their
indices and pregathered statistics, and y, the residual and the winner's
row: kappa*m*4 + kappa*16 + 3*m*4 bytes, 137.4 MB at the paper size (kappa
= 42,723, m = 800), 41.0 us at 3.35 TB/s; a chunk of K = 8 about 0.33 ms.
A sparse step reads kappa features' nnz_max value slots and the rows of
their nnz stored nonzeros instead of rows: kappa*nnz_max*4 + nnz*4 +
kappa*16 + 3*m*4 bytes, about 17.7 MB at the E2006-log1p size (kappa =
42,723, nnz_max 66, about 32 nonzeros a feature, m = 16,087), 5.3 us; a
chunk of 8 about 42 us. Each step adds one grid barrier. The replay moves
a few bytes per record (and 2*p*4 on the rare renorm), so it is bound by
its launch.

Design. The TPU runs the (K, kappa) grid in order on one core and carries
the winner and the residual in VMEM. Hopper blocks run in no order and
carry nothing, and one block cannot read a step's bytes alone. So each
chunk is one persistent cooperative grid (every block resident, sized by
the occupancy calculator, launched with ``cudaLaunchCooperativeKernel``)
with one grid sync per step (``csrc/fused_step.cu``): each block scores
its share of the coordinates, one warp a coordinate, against its own
shared-memory copy of the residual, keeps a first-max carry (K2's
comparator: NaN largest, ties to the first in sample order) and writes it
to a partial buffer indexed by step parity; after the sync every block
reduces all partials in the same order, so every block holds the same
winner, computes the line search and the S/F recursions redundantly with
``_rn`` intrinsics in the op order of ``core/fw_lasso.py`` (identical
scalars everywhere), and updates its own residual with the winner read
from device memory: dense, K3's op order over the winner's row; sparse,
``out = (1-lam) r + lam y`` over m, then the winner's nonzero slots added
as ``out[rows] += (-lam * delta_t) * vals``
(``step_tail.sparse_residual_update``'s op order). The double-buffered
partials need no second sync. Block 0 writes the records, the final
residual and (S, F, Q). Both layouts share that end of a step.

K4 scores with K2's ``warp_row_score``, a row at a time from device
memory. K7 scores ~10 features a warp a step, each a few hundred bytes
at a random place: fetched one after the other, each feature is a chain
of memory latencies (its id, then its slots, then the gather), and the
warp's bookkeeping per feature costs as much again. So K7
(``sparse_ring_chunk_kernel``, one block of 1024 threads an SM) gives
every warp a contiguous run of each step's positions and streams its
features, two at a time, through a ring of ``RING_DEPTH`` stages of its
own in shared memory (``csrc/common.cuh``'s ``SlotRing``, through which
K5 scores too): the ids are loaded 32 at a time and handed out by
shuffles; a feature's value slots arrive by 16-byte ``cp.async`` (a
feature starts at byte 4*nnz_max*f, 16-byte aligned only for some f, so a
stage holds the chunks that cover it and where in them it starts), four
ticks ahead, and its row slots two ticks ahead, a chunk of 4 rows only
where one of its 4 values is nonzero (zero-filled otherwise, as K6 does),
so the rows of padding (about half of the 66 slots at the E2006-log1p
size) are not read. Half h of the warp scores feature h of the pair: lane
q sums ``slot_dot``'s lane-q and lane-(q+16) partials in order, adds them
and finishes ``warp_sum``'s butterfly in the half, the same additions of
the same operands, so the scores keep their bits. The ring runs on across
the step boundary: the first pairs of step s+1 are in flight during step
s's grid sync, reduction and O(m) residual pass. ``plan`` sizes the ring
beside the residual (a feature in pieces of 96, 64 or 32 slots where a
whole one does not fit); where none fits (m near ``M_MAX_SPARSE``), K7
scores from device memory as K4 does, with K5's ``warp_slot_score``.

The ledger lives at the front of each block's dynamic shared memory, K
slots (``ledger_bytes(K)``, 12 bytes a slot), so a chunk takes any K whose
ledger fits beside the residual (``chunk_fits``); each block updates its
copy on thread 0 with the step's scalars, which every block computes
alike. A scoring warp adds the ledger's slots of its coordinate
in slot order to ``P * alpha_s``; the partials carry only ``(|sel|, raw,
position)``, and thread 0 recomputes the winner's ``a_i`` and ``sel`` from
the same ledger, the same bits. The EN code is a template flag of each
chunk kernel, so the lasso's instantiations compile none of it. Each
instantiation has its own wrapper (``dense_fused_chunk[_en]``,
``sparse_fused_chunk[_en]``), whose ``launches`` attribute counts it. An
EN record also carries the step's sampled gap, its gap scale and Q, the
inputs of its stall test.

``m`` is capped by shared memory: the dense layout keeps y beside the
residual (two (m,) f32 vectors a block, ``M_MAX``); the sparse layout
reads y through L2 and keeps the residual alone (``M_MAX_SPARSE``; at
m = 16,087 that is 64.3 KB a block); the EN ledger adds its bytes. Both
chunks run in f32. The engine routes a bf16 design, or a state past its
layout's shared memory (``chunk_fits``), to K unfused steps instead
(``core.vertex.use_fused_kernel``).

``fused_replay`` is one block launched once per chunk. Its first warp
loads the records in one parallel round (a lane a record, then the
record's ``beta`` in a second), walks them in registers with ``_rn``
intrinsics (a coordinate that wins twice in the chunk is forwarded from
lane to lane) and writes each distinct coordinate once; the whole block
multiplies ``beta`` only when the scale underflows (the unfused step
multiplies it by exactly 1 on every other step), the walk waiting at that
record. It matches its plain version, the loop over
``apply_coeff_update``, bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fw_grad import sampled_scores_plain
from repro_torch.kernels.residual_update import residual_update_plain
from repro_torch.kernels.step_tail import apply_coeff_update, sparse_residual_update
from repro_torch.kernels.sparse_grad import (  # noqa: F401 (K7's ring, re-exported)
    RING_DEPTH,
    SMEM_BYTES,
    RingPlan,
    ring_plan,
    sparse_sampled_scores_plain,
)

M_MAX = 24_576  # two (m,) f32 vectors in a block's shared memory: 192 KB
M_MAX_SPARSE = 57_344  # one (m,) f32 vector: 224 KB
# record row: lam, delta_t, raw, sel, stall flag, then the elastic-net's
# sampled gap, its gap_scale and Q before the step (0, 0, 0 for the lasso)
REC = 8
PARTIAL_BYTES = 16  # one block's (|score|, score, position) per step parity

_PTR, _I32, _I64, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# the arguments both chunk entry points end with: (y, r0, s0, f0, q0, delta, idx,
# zty_s, zn2_s, m, K, kappa, k0, max_iters, refresh_every, eps_den, gap_rtol, i_star,
# recs, no_prog, r_out, s_out, partials, blocks, alpha_s, l2, stream); alpha_s null:
# the lasso's chunk
_CHUNK_TAIL = ([_PTR] * 9 + [_I32, _I32, _I64, _I64, _I64, _I32, _F32, _F32]
               + [_PTR] * 6 + [_I32, _PTR, _F32, _PTR])
# the matrix's arguments first: (X, p), or (values, rows, n_feat, nnz_max, threads, depth,
# slots, stride)
_DENSE_ARGTYPES = [_PTR, _I64] + _CHUNK_TAIL
_SPARSE_ARGTYPES = [_PTR, _PTR, _I64] + [_I32] * 5 + _CHUNK_TAIL
# (beta, p, scale, maxabs, step_inf, stall, i_star, lam, lam_stride, dt, dt_stride,
#  no_prog, K, k0, max_iters, renorm_threshold, eps_den, tol, f_out, stall_out, stream)
_REPLAY_ARGTYPES = ([_PTR, _I64] + [_PTR] * 6 + [_I64, _PTR, _I64, _PTR, _I32, _I64, _I64]
                    + [_F32] * 3 + [_PTR] * 3)

_grid_blocks: Dict[tuple, int] = {}

def ledger_bytes(K: int) -> int:
    """The elastic-net chunk's alpha ledger at the front of a block's
    dynamic shared memory: K slot ids (int64), K slot values and P (f32),
    rounded up to 16 bytes (``ledger_bytes`` of ``csrc/fused_step.cu``)."""
    return -(-(12 * K + 4) // 16) * 16


def _vec_bytes(m: int) -> int:
    return 4 * (-(-m // 4) * 4)  # an (m,) f32 vector, rounded up to 16 bytes


def chunk_fits(sparse: bool, m: int, ledger: int = 0) -> bool:
    """Whether a chunk's shared memory holds its state at m: the residual
    (and, dense, y beside it) up to ``M_MAX_SPARSE`` (``M_MAX``), plus
    ``ledger`` bytes (``ledger_bytes(K)`` for the elastic-net's chunk),
    within ``SMEM_BYTES``."""
    if sparse:
        return m <= M_MAX_SPARSE and _vec_bytes(m) + ledger <= SMEM_BYTES
    return m <= M_MAX and _vec_bytes(m) + 4 * m + ledger <= SMEM_BYTES


def plan(m: int, nnz_max: int, ledger: int = 0) -> RingPlan:
    """K7's ring (``sparse_grad.ring_plan``, the ring K5 scores through) for
    a residual of ``m`` and ``nnz_max`` slots a feature, beside ``ledger``
    bytes of the elastic-net's ledger; where none fits, ``RingPlan(512, 0,
    0, 0)``: 512-thread blocks score the features from device memory.
    Raises where the residual and the ledger do not fit (``chunk_fits``)."""
    if not chunk_fits(True, m, ledger):
        raise ValueError(
            f"the sparse fused chunk keeps the (m,) f32 residual and {ledger} ledger bytes in "
            f"shared memory: m <= {M_MAX_SPARSE} and {SMEM_BYTES} bytes, got m = {m}"
        )
    return ring_plan(m, nnz_max, ledger)



def _check_oracle(oracle, kind: str, idx, alpha_s):
    """The chunk runs ``kind``'s algebra ('lasso', or 'en' with its
    ``alpha_s``); another oracle raises."""
    got = getattr(oracle, "fused_kind", None)
    if got != kind or oracle.fused_needs_alpha != (kind == "en"):
        raise NotImplementedError(
            f"the fused chunks run the lasso's and the elastic-net's algebra; this one "
            f"fused_kind={kind!r}, not fused_kind={got!r} with fused_needs_alpha="
            f"{getattr(oracle, 'fused_needs_alpha', None)}"
        )
    if kind == "en" and (alpha_s is None or alpha_s.shape != idx.shape):
        raise ValueError(f"the elastic-net's chunk needs alpha_s of idx's shape "
                         f"{tuple(idx.shape)}")


def _check_chunk(m, y, resid, idx, zty_s, zn2_s):
    if y.shape != (m,) or resid.shape != y.shape:
        raise ValueError(
            f"need y (m,), resid (m,) with m = {m}, got {tuple(y.shape)}, {tuple(resid.shape)}"
        )
    if idx.dim() != 2 or idx.numel() == 0 or zty_s.shape != idx.shape or zn2_s.shape != idx.shape:
        raise ValueError(
            f"need idx, zty_s, zn2_s of one shape (K, kappa), got {tuple(idx.shape)}, "
            f"{tuple(zty_s.shape)}, {tuple(zn2_s.shape)}"
        )


def _chunk_plain(score, update, y, resid, scal, idx, zty_s, zn2_s, k0: int, delta, *,
                 oracle, eps_den, gap_rtol, refresh_every: int, max_iters: int, alpha_s=None):
    """The chunk's plain version on either layout (reference
    ``kernels/fused_step/ref.py:21-98``): ``score(ids, resid)`` gives a
    step's scores, ``update(resid, y, i_star, lam, delta_t)`` its eq. 10.
    With the unfused step's own score and update functions it runs that
    step's ops in its order, so a lasso chunk on CPU tensors replays
    fuse_steps=1 bit for bit. An oracle that needs alpha (the elastic-net)
    selects on the shifted score from the alpha ledger, ``alpha_s`` its
    chunk-start alpha values."""
    K = idx.shape[0]
    y = y.float()
    resid = resid.float()
    delta = torch.as_tensor(delta, dtype=torch.float32, device=y.device)
    scal3 = tuple(scal)
    needs_alpha = oracle.fused_needs_alpha
    if needs_alpha:  # the ledger: P = prod(1 - lam), slots (i*_t, c_t)
        P = torch.ones((), dtype=torch.float32, device=y.device)
        ladd = torch.zeros(K, dtype=torch.float32, device=y.device)
        lidx = torch.full((K,), -1, dtype=idx.dtype, device=y.device)
    recs = []
    for s in range(K):
        ids = idx[s]
        raw = score(ids, resid)
        if needs_alpha:
            corr = torch.where(lidx[None, :] == ids[:, None], ladd[None, :], 0.0).sum(dim=1)
            a = P * alpha_s[s] + corr
            sel = raw + oracle.fused_score_shift(a)
        else:
            sel = raw
        j = torch.argmax(sel.abs()).view(1)
        i_star = ids.index_select(0, j).view(())
        g_raw = raw.index_select(0, j).view(())
        g_sel = sel.index_select(0, j).view(())
        a_star = a.index_select(0, j).view(()) if needs_alpha else None
        zty_i = zty_s[s].index_select(0, j).view(())
        zn2_i = zn2_s[s].index_select(0, j).view(())
        delta_t = -delta * torch.sign(g_sel)
        lam, no_progress, g_lin = oracle.fused_line_search(
            scal3, g_raw, g_sel, a_star, delta_t, zty_i, zn2_i, eps_den, gap_rtol
        )
        recs.append((i_star, lam, delta_t, no_progress))
        k = k0 + s
        if k < max_iters:
            resid = update(resid, y, i_star, lam, delta_t)
            s_quad, f_lin, q = oracle.fused_scalar_update(
                scal3, g_lin, a_star, lam, delta_t, zty_i, zn2_i
            )
            if k % refresh_every == refresh_every - 1:  # exact S/F refresh
                v = y - resid
                s_quad, f_lin = torch.dot(v, v), torch.dot(v, y)
            scal3 = (s_quad, f_lin, q)
            if needs_alpha:
                one_m = 1.0 - lam
                P = P * one_m
                ladd = ladd * one_m
                ladd[s] = lam * delta_t
                lidx[s] = i_star
    i_stars, lams, delta_ts, no_progs = (torch.stack(c) for c in zip(*recs))
    return i_stars, lams, delta_ts, no_progs, resid, scal3


def dense_fused_chunk_plain(Xt, y, resid, scal, idx, zty_s, zn2_s, k0: int, delta, **kw):
    """The plain version of K4: the unfused 'kernels' step's scores (K2's
    plain version) and eq. 10 (K3's)."""

    def update(r, yv, i_star, lam, delta_t):
        return residual_update_plain(r, yv, Xt.index_select(0, i_star.view(1)).view(-1),
                                     lam, delta_t)

    return _chunk_plain(lambda ids, r: sampled_scores_plain(Xt, r, ids, 1), update,
                        y, resid, scal, idx, zty_s, zn2_s, k0, delta, **kw)


def sparse_fused_chunk_plain(values, rows, y, resid, scal, idx, zty_s, zn2_s, k0: int, delta,
                             **kw):
    """The plain version of K7: the unfused sparse step's scores (K5's plain
    version at width 1) and eq. 10 (``step_tail.sparse_residual_update``)."""
    nnz = values.shape[-1]

    def update(r, yv, i_star, lam, delta_t):
        col_vals = values.reshape(-1, nnz).index_select(0, i_star.view(1)).view(-1)
        col_rows = rows.reshape(-1, nnz).index_select(0, i_star.view(1)).view(-1)
        return sparse_residual_update(r, yv, col_vals, col_rows, lam, delta_t)

    return _chunk_plain(lambda ids, r: sparse_sampled_scores_plain(values, rows, r, ids, 1),
                        update, y, resid, scal, idx, zty_s, zn2_s, k0, delta, **kw)


def _blocks(layout: str, dev: torch.device, m: int, shape: tuple = (), slots: int = 0) -> int:
    """The cooperative grid of a layout ('dense' or 'sparse') at m, of the
    lasso's instantiation (``slots`` 0) or the elastic-net's with a ledger
    of ``slots`` = K slots; for 'sparse', ``shape`` is ``(nnz_max, *plan)``."""
    key = (layout, dev.index, m, shape, slots)
    if key not in _grid_blocks:
        fn = _build.function("fused_step", f"{layout}_fused_chunk_blocks",
                             [_I32] * (2 + len(shape)) + [_PTR])
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = fn(m, *shape, slots, ctypes.addressof(out))
        _build.check("fused_step", err, f"{layout}_fused_chunk occupancy query")
        _grid_blocks[key] = out.value
    return _grid_blocks[key]


def _launch_chunk(layout: str, head: tuple, shape: tuple, y, resid, scal, idx, zty_s, zn2_s,
                  k0: int, delta, *, eps_den, gap_rtol, refresh_every: int, max_iters: int,
                  alpha_s=None, l2: float = 0.0):
    """Launch the cooperative chunk kernel of ``layout`` with its leading
    arguments ``head + shape`` (the matrix's pointers and sizes, then what
    ``_blocks`` takes); ``alpha_s`` given, the elastic-net's instantiation
    with ``l2``. Returns the chunk's records and final state."""
    m = y.shape[0]
    K, kappa = idx.shape
    dev = y.device
    s0, f0, q0 = (torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(()) for x in scal)
    delta = torch.as_tensor(delta, dtype=torch.float32, device=dev).reshape(())
    idx = idx.long()
    en = alpha_s is not None
    _build.require_cuda(y, resid, s0, f0, q0, delta, idx, zty_s, zn2_s,
                        *((alpha_s,) if en else ()))
    blocks = _blocks(layout, dev, m, shape, K if en else 0)
    i_star = torch.empty(K, dtype=torch.int64, device=dev)
    recs = torch.empty((K, REC), dtype=torch.float32, device=dev)
    no_prog = torch.empty(K, dtype=torch.bool, device=dev)
    r_out = torch.empty(m, dtype=torch.float32, device=dev)
    s_out = torch.empty(3, dtype=torch.float32, device=dev)
    partials = torch.empty(2 * blocks * PARTIAL_BYTES, dtype=torch.uint8, device=dev)
    argtypes = _DENSE_ARGTYPES if layout == "dense" else _SPARSE_ARGTYPES
    fn = _build.function("fused_step", f"{layout}_fused_chunk_launch", argtypes)
    with torch.cuda.device(dev):
        err = fn(*head, *shape, y.data_ptr(), resid.data_ptr(), s0.data_ptr(), f0.data_ptr(),
                 q0.data_ptr(), delta.data_ptr(), idx.data_ptr(), zty_s.data_ptr(),
                 zn2_s.data_ptr(), m, K, kappa, int(k0), int(max_iters), int(refresh_every),
                 _build.f32(eps_den), _build.f32(gap_rtol), i_star.data_ptr(), recs.data_ptr(),
                 no_prog.data_ptr(), r_out.data_ptr(), s_out.data_ptr(), partials.data_ptr(),
                 blocks, alpha_s.data_ptr() if en else None, _build.f32(l2), _build.stream(dev))
    _build.check("fused_step", err, f"{layout}_fused_chunk (cooperative)")
    return i_star, recs[:, 0], recs[:, 1], no_prog, r_out, (s_out[0], s_out[1], s_out[2])


def _check_f32(*tensors):
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("the fused chunk runs in float32")


def dense_fused_chunk(Xt: torch.Tensor, y: torch.Tensor, resid: torch.Tensor, scal,
                      idx: torch.Tensor, zty_s: torch.Tensor, zn2_s: torch.Tensor, k0: int,
                      delta, *, oracle, eps_den: float, gap_rtol: float, refresh_every: int,
                      max_iters: int):
    """K fused lasso FW steps over the dense feature-major ``Xt``. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (or
    raises). ``scal`` is the chunk-start (S, F, Q) as 0-d tensors, ``delta``
    a 0-d tensor, ``k0`` the global iteration count at the chunk start,
    ``oracle`` one with ``fused_kind = 'lasso'``."""
    return _dense_chunk(dense_fused_chunk, "lasso", Xt, y, resid, scal, idx, zty_s, zn2_s, k0,
                        delta, None, oracle=oracle, eps_den=eps_den, gap_rtol=gap_rtol,
                        refresh_every=refresh_every, max_iters=max_iters)


def dense_fused_chunk_en(Xt: torch.Tensor, y: torch.Tensor, resid: torch.Tensor, scal,
                         idx: torch.Tensor, zty_s: torch.Tensor, zn2_s: torch.Tensor, k0: int,
                         delta, *, alpha_s: torch.Tensor, oracle, eps_den: float,
                         gap_rtol: float, refresh_every: int, max_iters: int):
    """K fused elastic-net FW steps over the dense ``Xt``, in K4's EN
    instantiation (the alpha ledger): ``dense_fused_chunk``'s arguments, an
    ``oracle`` with ``fused_kind = 'en'``, and ``alpha_s``, the chunk-start
    alpha values at ``idx`` in f32."""
    return _dense_chunk(dense_fused_chunk_en, "en", Xt, y, resid, scal, idx, zty_s, zn2_s, k0,
                        delta, alpha_s, oracle=oracle, eps_den=eps_den, gap_rtol=gap_rtol,
                        refresh_every=refresh_every, max_iters=max_iters)


def _dense_chunk(wrapper, kind, Xt, y, resid, scal, idx, zty_s, zn2_s, k0, delta, alpha_s, *,
                 oracle, **kw):
    """``dense_fused_chunk`` or (kind 'en') ``dense_fused_chunk_en``: the
    plain version on a CPU tensor, else one launch, counted on ``wrapper``."""
    if Xt.dim() != 2:
        raise ValueError(f"need Xt (p, m), got {tuple(Xt.shape)}")
    _check_chunk(Xt.shape[1], y, resid, idx, zty_s, zn2_s)
    _check_oracle(oracle, kind, idx, alpha_s)
    if Xt.device.type == "cpu":
        return dense_fused_chunk_plain(Xt, y, resid, scal, idx, zty_s, zn2_s, k0, delta,
                                       oracle=oracle, alpha_s=alpha_s, **kw)
    p, m = Xt.shape
    ledger = ledger_bytes(idx.shape[0]) if alpha_s is not None else 0
    if not chunk_fits(False, m, ledger):
        raise ValueError(
            f"the dense fused chunk keeps two (m,) f32 vectors and {ledger} ledger bytes in "
            f"shared memory: m <= {M_MAX} and {SMEM_BYTES} bytes, got m = {m}"
        )
    _check_f32(Xt, y, resid, zty_s, zn2_s, *(() if alpha_s is None else (alpha_s,)))
    _build.require_cuda(Xt, y)
    out = _launch_chunk("dense", (Xt.data_ptr(), p), (), y, resid, scal, idx, zty_s, zn2_s, k0,
                        delta, alpha_s=alpha_s, l2=oracle.l2 if alpha_s is not None else 0.0,
                        **kw)
    wrapper.launches += 1
    return out


def sparse_fused_chunk(values: torch.Tensor, rows: torch.Tensor, y: torch.Tensor,
                       resid: torch.Tensor, scal, idx: torch.Tensor, zty_s: torch.Tensor,
                       zn2_s: torch.Tensor, k0: int, delta, *, oracle, eps_den: float,
                       gap_rtol: float, refresh_every: int, max_iters: int):
    """K fused lasso FW steps over the block-ELL ``values``/``rows``
    ``(nblocks, bs, nnz_max)``; ``idx`` holds feature ids (< p, drawn by the
    engine; a padded feature scores 0). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (or raises: ``values`` and
    ``rows`` must start on 16-byte boundaries, as every array the port
    allocates does). The other arguments and the returns are
    ``dense_fused_chunk``'s."""
    return _sparse_chunk(sparse_fused_chunk, "lasso", values, rows, y, resid, scal, idx, zty_s,
                         zn2_s, k0, delta, None, oracle=oracle, eps_den=eps_den,
                         gap_rtol=gap_rtol, refresh_every=refresh_every, max_iters=max_iters)


def sparse_fused_chunk_en(values: torch.Tensor, rows: torch.Tensor, y: torch.Tensor,
                          resid: torch.Tensor, scal, idx: torch.Tensor, zty_s: torch.Tensor,
                          zn2_s: torch.Tensor, k0: int, delta, *, alpha_s: torch.Tensor, oracle,
                          eps_den: float, gap_rtol: float, refresh_every: int, max_iters: int):
    """K fused elastic-net FW steps over the block-ELL layout, in K7's EN
    instantiation (the alpha ledger): ``sparse_fused_chunk``'s arguments
    and ``dense_fused_chunk_en``'s ``oracle`` and ``alpha_s``."""
    return _sparse_chunk(sparse_fused_chunk_en, "en", values, rows, y, resid, scal, idx, zty_s,
                         zn2_s, k0, delta, alpha_s, oracle=oracle, eps_den=eps_den,
                         gap_rtol=gap_rtol, refresh_every=refresh_every, max_iters=max_iters)


def _sparse_chunk(wrapper, kind, values, rows, y, resid, scal, idx, zty_s, zn2_s, k0, delta,
                  alpha_s, *, oracle, **kw):
    """``sparse_fused_chunk`` or (kind 'en') ``sparse_fused_chunk_en``: the
    plain version on a CPU tensor, else one launch, counted on ``wrapper``."""
    if values.dim() != 3 or rows.shape != values.shape:
        raise ValueError(
            f"need values and rows (nblocks, bs, nnz_max), got {tuple(values.shape)}, "
            f"{tuple(rows.shape)}"
        )
    _check_chunk(y.shape[0], y, resid, idx, zty_s, zn2_s)
    _check_oracle(oracle, kind, idx, alpha_s)
    if values.device.type == "cpu":
        return sparse_fused_chunk_plain(values, rows, y, resid, scal, idx, zty_s, zn2_s, k0,
                                        delta, oracle=oracle, alpha_s=alpha_s, **kw)
    m = y.shape[0]
    nblocks, bs, nnz = values.shape
    pl = plan(m, nnz, ledger_bytes(idx.shape[0]) if alpha_s is not None else 0)
    _check_f32(values, y, resid, zty_s, zn2_s, *(() if alpha_s is None else (alpha_s,)))
    if rows.dtype != torch.int32:
        raise TypeError(f"the row slots must be int32, got {rows.dtype}")
    _build.require_cuda(values, rows, y)
    if pl.depth and (values.data_ptr() % 16 or rows.data_ptr() % 16):
        raise ValueError(f"{wrapper.__name__} needs values and rows on 16-byte boundaries")
    out = _launch_chunk("sparse", (values.data_ptr(), rows.data_ptr(), nblocks * bs),
                        (nnz, *pl), y, resid, scal, idx, zty_s, zn2_s, k0, delta,
                        alpha_s=alpha_s, l2=oracle.l2 if alpha_s is not None else 0.0, **kw)
    wrapper.launches += 1
    return out


def fused_replay_plain(beta, scale, maxabs, step_inf, stall, i_stars, lams, delta_ts,
                       no_progs, k0: int, cfg):
    """The plain version: the unfused step's own ``apply_coeff_update``,
    record by record, skipping records at k >= cfg.max_iters. Updates
    ``beta`` in place; returns ``(beta, scale, maxabs, step_inf, stall)``."""
    for t in range(min(i_stars.shape[0], cfg.max_iters - k0)):
        i_star = i_stars[t]
        a_star = scale * beta.index_select(0, i_star.view(1)).view(())
        beta, scale, maxabs, step_inf, stall = apply_coeff_update(
            beta, scale, maxabs, stall, a_star, i_star, lams[t], delta_ts[t], no_progs[t], cfg
        )
    return beta, scale, maxabs, step_inf, stall


def fused_replay(beta: torch.Tensor, scale: torch.Tensor, maxabs: torch.Tensor,
                 step_inf: torch.Tensor, stall: torch.Tensor, i_stars: torch.Tensor,
                 lams: torch.Tensor, delta_ts: torch.Tensor, no_progs: torch.Tensor,
                 k0: int, cfg):
    """Apply a chunk's records to ``beta`` (in place) and the stopping
    statistics; ``cfg`` gives max_iters, renorm_threshold, eps_den and tol.
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel. Returns ``(beta, scale, maxabs, step_inf, stall)``."""
    K = i_stars.shape[0]
    if (beta.dim() != 1 or i_stars.dim() != 1 or lams.shape != (K,)
            or delta_ts.shape != (K,) or no_progs.shape != (K,)):
        raise ValueError("need beta (p,) and records i_stars, lams, delta_ts, no_progs (K,)")
    if beta.device.type == "cpu":
        return fused_replay_plain(beta, scale, maxabs, step_inf, stall, i_stars, lams,
                                  delta_ts, no_progs, k0, cfg)
    if beta.dtype != torch.float32 or lams.dtype != torch.float32 or delta_ts.dtype != torch.float32:
        raise TypeError("the replay runs in float32")
    dev = beta.device
    scale, maxabs, step_inf = (t.float().reshape(()) for t in (scale, maxabs, step_inf))
    stall = stall.to(torch.int32).reshape(())
    i_stars = i_stars.long().contiguous()
    no_progs = no_progs.to(torch.bool).contiguous()
    _build.require_cuda(beta, scale, maxabs, step_inf, stall, i_stars, no_progs)
    if lams.device != dev or delta_ts.device != dev:
        raise ValueError("the records must lie on beta's device")
    f_out = torch.empty(3, dtype=torch.float32, device=dev)
    stall_out = torch.empty((), dtype=torch.int32, device=dev)
    fn = _build.function("fused_step", "fused_replay_launch", _REPLAY_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(beta.data_ptr(), beta.shape[0], scale.data_ptr(), maxabs.data_ptr(),
                 step_inf.data_ptr(), stall.data_ptr(), i_stars.data_ptr(), lams.data_ptr(),
                 lams.stride(0), delta_ts.data_ptr(), delta_ts.stride(0), no_progs.data_ptr(),
                 K, int(k0), int(cfg.max_iters), _build.f32(cfg.renorm_threshold),
                 _build.f32(cfg.eps_den), _build.f32(cfg.tol), f_out.data_ptr(), stall_out.data_ptr(), _build.stream(dev))
        fused_replay.launches += 1
    _build.check("fused_step", err, "fused_replay")
    return beta, f_out[0], f_out[1], f_out[2], stall_out


dense_fused_chunk.launches = 0
dense_fused_chunk_en.launches = 0
sparse_fused_chunk.launches = 0
sparse_fused_chunk_en.launches = 0
fused_replay.launches = 0
