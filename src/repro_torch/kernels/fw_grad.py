"""K2: the sampled linear-minimization oracle (paper eq. 9).

``sampled_scores`` computes, for sampled aligned blocks ``blk`` of width
``bs`` over the feature-major ``Xt (p, m)``,

    scores[i*bs + t] = -Xt[blk[i]*bs + t, :] @ r

and ``fw_vertex`` reduces them to ``(i_star, g_star)``: the global index
of the first max of ``|score|`` in sample order (``jnp.argmax``'s rule),
with indices ``>= p_valid`` masked to -1, and its score.

Replaces the Pallas kernel ``sampled_scores`` at
``src/repro/kernels/fw_grad/fw_grad.py:79`` (entry at :46) and the XLA
argmax of ``fw_vertex`` at ``src/repro/kernels/fw_grad/ops.py:27``.

Bound on an H100: bytes. The scores read kappa rows of m values once
(2 flops each). At the paper size with uniform sampling (kappa = 42,723,
m = 800, f32) that is kappa*m*4 + m*4 + kappa*8 + kappa*4 bytes, about
137 MB, so about 41 us a step at 3.35 TB/s. The argmax reads n scores and
their sampled block ids (n*4 + nb*8 + 12 bytes): 0.15 us at kappa =
42,723, so it is bound by its launch and its latency there, and 5.2 us at
n = 4,272,256 ('full' sampling at the paper size, blocks of 128).

Design of the scores: rows are drawn at random, but each row is m
contiguous values, so the scores are a gather-GEMV with one warp per
sampled row, reading the row with coalesced 16-byte loads against ``r``
staged in shared memory. A row index ``>= p`` scores exactly 0 without
reading memory, which replaces the reference's padded copy of Xt for
block sampling (``core/vertex.py:136-137``, a second 13.7 GB at the paper
size).

Design of the argmax: one grid-wide launch. ``argmax_grid`` cuts the n
scores into contiguous ranges of a multiple of 4, about 8 a thread, at
most two blocks of 256 threads per SM (21 blocks at kappa = 42,723; 264
at n = p on an H100, 63 scores a thread). Each block reads its range
with 16-byte loads, walks the sampled blocks alongside (no division in
the loop; with width 1 the index is ``blk[j]``), keeps the first max
under the comparator of ``jnp.argmax`` (NaN largest, then the lower
position) and writes it to a partial; the last block to finish, by a
ticket counter, reduces the partials and resets the counter. That
comparator is a total order, so the result is bit-exact with
``argmax_plain`` whichever block is last. The result stays in device
memory. The partials and the counter live in a scratch buffer allocated
once per device and reused by every launch in stream order (the one-lane
launches, and the lanes' ticket route past ``LANE_CLUSTER_MAX_N``): two
streams must not run them on one device at once.

The elastic-net's shifted argmax (``vertex_argmax_shifted``): the argmax
of the selected scores ``sel = raw + l2 * (scale * beta[idx])`` (a
``ScoreShift``), which the reference runs in XLA after K2's scores
(``src/repro/core/vertex.py:243-249``; ``src/repro/sparse/ops.py:56-88``).
The same launch, in an instantiation of its own: each thread gathers
``beta[idx]`` beside each score it reads and forms ``sel`` with ``_rn``
intrinsics in the reference's order; the first max of ``|sel|`` under the
same total order wins (an index ``>= p_valid`` never wins, its shift read
at ``p_valid - 1``, as the reference's clipped gather). It returns
``(i_star, g_raw, g_sel)``, so an elastic-net step stays four launches.
Bound: the one-lane bytes plus n*4 of ``beta`` gathers (n*2 bf16), 0.33 us
at kappa = 42,723.

Lanes (``sampled_scores_lanes``, ``vertex_argmax_lanes``): L delta lanes
of the batched engine in one launch each, the counterpart of the
reference's vmapped ``pallas_call`` under ``jax.vmap`` of its step
(``src/repro/core/engine.py:721-736``). The grid gains a second axis,
one row of blocks for each lane in ``lanes`` (an int32 list of the lanes
that step; a frozen lane launches no block). A lane's blocks run exactly
the one-lane launch on its operands: the scores stage their lane's
residual and read its sampled ids (``blk (L, nb)``, or one ``(nb,)``
shared by the lanes, 'full' sampling). So each lane's scores have the
bits of the one-lane launch. A lane not in ``lanes`` gets ``i_star = -1``
and ``g_star = 0``; its scores are not written. The scores of the lanes
are one ``(L, n4)`` buffer, n rounded up to 4 so that every lane's row
starts on 16 bytes, returned as the ``(L, n)`` view. Bound: L_active * n
* m * itemsize + L * m * 4 + L * n * 12 bytes for the scores (13 lanes at
the paper's size: 1.777 GB, 0.53 ms at 3.35 TB/s); L times the one-lane
bytes for the argmax (the shifted one: + n*4 + 4 a lane).

The lane argmax (``vertex_argmax_lanes``, and ``vertex_argmax_shifted_lanes``
for the elastic-net) has two routes, each bit for bit the plain version
and each lane's one-lane launch. The cluster route (n up to
``LANE_CLUSTER_MAX_N`` a lane): one thread-block cluster of
``LANE_CLUSTER`` CTAs a lane, each CTA a contiguous range of the lane's
scores with 16-byte loads of the scores and ids; the CTAs' winners meet in
rank 0's shared memory through distributed shared memory, behind the
cluster barrier, so no ticket, partials or scratch are needed. Past the
cap ('full' sampling), the ticket route: a row of the grid-wide launch's
blocks for each lane, with a ticket and partials of its own in the
scratch buffer (``_argmax_scratch``); there the clusters' few CTAs a lane
are slower (``scripts/lane_argmax_ab.py``). On the cluster route, with
the shift and the lanes' support bitmap (``ScoreShift.support``,
``pack_support``: a fine bit a coefficient and a summary bit each 64, a
superset of beta's nonzeros that the batched engine keeps where
``vertex.lane_support`` builds one), a lane reads ``beta[idx]`` only
under a set summary bit (staged in shared memory) and a set fine bit, and
sets the winner's bits in place; an infinite or NaN scale reads beta
everywhere. The ticket route reads beta everywhere and takes no bitmap.

The owned scores (``sampled_scores_owned``, ``sampled_scores_lanes_owned``):
the distributed backend's scores on a rank's tile of the mesh (the
``OWNED`` instantiation), which replaces the reference's XLA mask of its
partial scores (``src/repro/distributed/backend.py:78-90``). The tile holds
the global rows ``[off, off + p_local)``; the sampled ids stay global. A
position whose row the tile owns is scored against its local row, exactly
as the one-device kernel scores it; any other writes +0.0. So the
``all_reduce`` that sums the ranks' buffers completes every score, its
other terms exact zeros. Bound: the one-device bytes for the owned rows,
plus n*4 written for the others.

Each instantiation has its own wrapper, whose ``launches`` attribute
counts the launches of its kernel.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.padding import pad_rows

_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (X, r, blk, scores, p, m, n, bs, lane_ids, n_run, r_stride, blk_stride, sc_stride, dtype,
#  stream)
_SCORES_ARGTYPES = [_PTR] * 4 + [_I64, _I32, _I64, _I32, _PTR, _I32] + [_I64] * 3 + [_I32, _PTR]
# (X, r, blk, scores, p_local, m, n, bs, off, lane_ids, n_run, r_stride, blk_stride,
#  sc_stride, dtype, stream)
_OWNED_ARGTYPES = ([_PTR] * 4 + [_I64, _I32, _I64, _I32, _I64, _PTR, _I32] + [_I64] * 3
                   + [_I32, _PTR])
_F32 = ctypes.c_float
# (scores, blk, n, bs, p_valid, blocks, chunk, scratch, lane_cap, i_star, g_star, lane_ids,
#  n_run, n_lanes, sc_stride, blk_stride, beta, beta_stride, beta_dtype, scale, l2, g_sel,
#  stream)
_ARGMAX_ARGTYPES = ([_PTR, _PTR, _I64, _I32, _I64, _I32, _I64, _PTR, _I32, _PTR, _PTR, _PTR]
                    + [_I32, _I32, _I64, _I64, _PTR, _I64, _I32, _PTR, _F32, _PTR, _PTR])
# (scores, blk, n, bs, p_valid, i_star, g_star, lane_ids, n_run, n_lanes, sc_stride,
#  blk_stride, beta, beta_stride, beta_dtype, scale, l2, g_sel, support, sup_stride, stream)
_CLUSTER_ARGTYPES = ([_PTR, _PTR, _I64, _I32, _I64, _PTR, _PTR, _PTR, _I32, _I32, _I64, _I64]
                     + [_PTR, _I64, _I32, _PTR, _F32, _PTR, _PTR, _I64, _PTR])
_NO_SHIFT = (None, 0, 0, None, 0.0, None)
ARGMAX_THREADS = 256  # AM_THREADS of csrc/fw_grad.cu
ARGMAX_PER_THREAD = 8  # scores a thread, below the cap
ARGMAX_BLOCKS_PER_SM = 2
# the lane argmax's cluster route: CTAs a lane (LANE_CLUSTER of
# csrc/fw_grad.cu), and the most scores a lane for which it is taken (past
# it, the grid-wide ticket route)
LANE_CLUSTER = 16
LANE_CLUSTER_MAX_N = 1 << 18
LANE_ROUTES = ("cluster", "ticket")
_scratch = {}  # device index -> (the argmax's scratch buffer, SM count, lanes it holds)


def argmax_grid(n: int, sms: int):
    """``(blocks, chunk)`` of ``vertex_argmax`` for n scores on a card of
    ``sms`` SMs: every block takes ``chunk`` (a multiple of 4) contiguous
    scores, the last one the rest, none empty."""
    if n < 1:
        raise ValueError("vertex_argmax needs at least one score")
    blocks = min(ARGMAX_BLOCKS_PER_SM * sms, -(-n // (ARGMAX_THREADS * ARGMAX_PER_THREAD)))
    chunk = -(-n // (4 * blocks)) * 4
    return -(-n // chunk), chunk


def lane_route(n: int) -> str:
    """The lane argmax's route for n scores a lane: one cluster a lane up to
    ``LANE_CLUSTER_MAX_N``, the grid-wide ticket route past it."""
    return "cluster" if n <= LANE_CLUSTER_MAX_N else "ticket"


def argmax_scratch_bytes(lanes: int, sms: int) -> int:
    """The argmax's scratch for ``lanes`` lanes on a card of ``sms`` SMs: a
    ticket counter a lane (u32, zero between launches) in whole 16-byte
    units, then each lane's partials (int64 position, f32 value) for the
    largest grid."""
    return 16 * -(-lanes // 4) + 12 * lanes * ARGMAX_BLOCKS_PER_SM * sms


def _argmax_scratch(dev: torch.device, lanes: int = 1):
    """The device's scratch buffer for at least ``lanes`` lanes, its SM count
    and the lanes it holds. A larger lane count replaces the buffer with a
    zeroed one (stream-ordered, as every launch that used the old one)."""
    got = _scratch.get(dev.index)
    if got is None or got[2] < lanes:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        cap = max(lanes, 1)
        buf = torch.zeros(argmax_scratch_bytes(cap, sms), dtype=torch.uint8, device=dev)
        got = _scratch[dev.index] = (buf, sms, cap)
    return got


class ScoreShift(NamedTuple):
    """The elastic-net's per-coordinate shift of the selected scores,
    ``l2 * (scale * beta[idx])`` (the reference's ``score_extra``):
    ``beta (p,)`` and ``scale ()`` in the state's dtype, or ``(L, p)`` and
    ``(L,)`` for lanes. Called with indices (< p) it gives the f32 addend,
    so it serves as the reference's ``extra_fn``; the kernels read its
    fields. ``support`` (lanes only; None: none) is the lanes' support
    bitmap, ``pack_support``'s layout, a superset of beta's nonzeros: the
    lane kernel reads beta only where a bit is set and sets the winner's
    bit in place."""

    beta: torch.Tensor
    scale: torch.Tensor
    l2: float
    support: Optional[torch.Tensor] = None

    def __call__(self, idx: torch.Tensor) -> torch.Tensor:
        return self.l2 * (self.scale.float() * self.beta.index_select(0, idx).float())

    def lane(self, lane: int) -> "ScoreShift":
        """Lane ``lane``'s shift, from a lane-stacked one."""
        return ScoreShift(self.beta[lane], self.scale[lane], self.l2)


SUMMARY_SPAN = 64  # coefficients a summary bit of the support bitmap covers


def support_fine_words(p: int) -> int:
    """The fine words of a support bitmap row over p coefficients, a whole
    number of 16 bytes (csrc/fw_grad.cu's support_fine_words)."""
    return -(-p // 128) * 4


def support_words(p: int) -> int:
    """32-bit words of a support bitmap row over p coefficients: the fine
    words, then the summary words, each level a whole number of 16 bytes."""
    return support_fine_words(p) + -(-(-(-p // SUMMARY_SPAN)) // 128) * 4


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """``(L, 32 w)`` uint8 0/1 to ``(L, w)`` int32 words, bit i % 32 of word
    i // 32 (bits to little-endian bytes to words)."""
    L = bits.shape[0]
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8,
                           device=bits.device)
    return (bits.view(L, -1, 8) * weights).sum(-1, dtype=torch.uint8).view(torch.int32)


def pack_support(beta: torch.Tensor) -> torch.Tensor:
    """The support bitmap of ``beta (L, p)``: ``(L, support_words(p))``
    int32 rows, plain torch. The fine words first: bit i % 32 of word i //
    32 set where ``beta[:, i] != 0`` (a zero of either sign clears it); then
    the summary words: bit g % 32 of word g // 32 set where any of the
    coefficients ``[64 g, 64 g + 64)`` has its fine bit. Each level is
    padded with zero words to a whole number of 16 bytes."""
    L, p = beta.shape
    fine_bits = support_fine_words(p) * 32
    groups = -(-p // SUMMARY_SPAN)
    bits = torch.zeros((L, max(fine_bits, groups * SUMMARY_SPAN)), dtype=torch.uint8,
                       device=beta.device)
    bits[:, :p] = beta != 0
    summary = torch.zeros((L, (support_words(p) - support_fine_words(p)) * 32),
                          dtype=torch.uint8, device=beta.device)
    summary[:, :groups] = bits[:, :groups * SUMMARY_SPAN].view(L, groups, SUMMARY_SPAN).amax(-1)
    return torch.cat([_pack_bits(bits[:, :fine_bits]), _pack_bits(summary)], dim=1)


def _bit_words(idx: torch.Tensor) -> torch.Tensor:
    """int32 words with bit ``idx % 32`` set."""
    bit = torch.bitwise_left_shift(torch.ones_like(idx), idx & 31)
    return torch.where(bit >= 2**31, bit - 2**32, bit).to(torch.int32)


def mark_support(support: torch.Tensor, i_star: torch.Tensor, p_valid: int) -> None:
    """Set, in place, the fine and summary bits of ``i_star[l]`` in each
    lane's row of ``support`` where ``0 <= i_star[l] < p_valid`` (the lane
    kernel's update of its bitmap, for the plain route)."""
    lanes = torch.nonzero((i_star >= 0) & (i_star < p_valid)).view(-1)
    idx = i_star.index_select(0, lanes)
    group = idx // SUMMARY_SPAN
    for words, bits in ((idx >> 5, _bit_words(idx)),
                        (support_fine_words(p_valid) + (group >> 5), _bit_words(group))):
        support[lanes, words] = support[lanes, words] | bits


def block_indices(blk: torch.Tensor, block_size: int) -> torch.Tensor:
    """Global row index of every sampled coordinate, in sample order."""
    offs = torch.arange(block_size, device=blk.device, dtype=blk.dtype)
    return (blk[:, None] * block_size + offs[None, :]).reshape(-1)


def sampled_scores_plain(Xt, r, blk, block_size: int):
    """The plain PyTorch version (reference ``kernels/fw_grad/ref.py``):
    rows past p read as the reference's zero padding."""
    idx = block_indices(blk.long(), block_size)
    rows = pad_rows(Xt, block_size).index_select(0, idx)
    return -(rows.float() @ r.float())


def argmax_plain(scores, blk, block_size: int, p_valid: int):
    """The plain version of ``vertex_argmax`` (the reference's XLA argmax)."""
    idx = block_indices(blk.long(), block_size)
    mag = torch.where(idx < p_valid, scores.abs(), -1.0)
    j = torch.argmax(mag).view(1)
    return idx.index_select(0, j).view(()), scores.index_select(0, j).view(())


def argmax_shifted_plain(scores, blk, block_size: int, p_valid: int, shift):
    """The plain version of ``vertex_argmax_shifted``, the reference's ops:
    ``sel = scores + shift(idx)`` (an index past p gathered at p - 1, as
    ``jnp.take`` clips), the first max of ``|sel|`` with indices ``>=
    p_valid`` masked to -1. ``shift`` is a ``ScoreShift`` (or any callable
    of the indices giving the f32 addend). Returns ``(i_star, g_raw, g_sel)``."""
    idx = block_indices(blk.long(), block_size)
    sel = scores + shift(idx.clamp_max(p_valid - 1))
    mag = torch.where(idx < p_valid, sel.abs(), -1.0)
    j = torch.argmax(mag).view(1)
    return (idx.index_select(0, j).view(()), scores.index_select(0, j).view(()),
            sel.index_select(0, j).view(()))


def _shift_args(shift: ScoreShift, p_valid: int, lanes: bool):
    """The shift's arguments of ``vertex_argmax_launch``: (beta, its row
    stride, its dtype code, scale as f32, l2); ``beta`` must hold p_valid
    coefficients a row."""
    if not isinstance(shift, ScoreShift):
        raise TypeError(f"the shifted argmax kernel reads a ScoreShift, got {type(shift)}")
    beta = shift.beta
    if beta.dim() != (2 if lanes else 1) or beta.shape[-1] != p_valid:
        raise ValueError(f"the shift's beta must be ({'L, ' if lanes else ''}p_valid = "
                         f"{p_valid}), got {tuple(beta.shape)}")
    scale = shift.scale.float().contiguous()
    return (beta, beta.shape[-1] if lanes else 0, _build.dtype_code(beta), scale,
            _build.f32(shift.l2))



def _check(Xt, r, blk):
    if Xt.dim() != 2 or r.shape != (Xt.shape[1],) or blk.dim() != 1 or blk.numel() == 0:
        raise ValueError(
            f"need Xt (p, m), r (m,), blk (nb >= 1,), got {tuple(Xt.shape)}, "
            f"{tuple(r.shape)}, {tuple(blk.shape)}"
        )


def sampled_scores(Xt: torch.Tensor, r: torch.Tensor, blk: torch.Tensor, block_size: int = 1):
    """Scores ``(nb * block_size,)`` f32 of the sampled coordinates. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel."""
    _check(Xt, r, blk)
    if Xt.device.type == "cpu":
        return sampled_scores_plain(Xt, r, blk, block_size)
    rf = r.float().contiguous()
    blk = blk.long().contiguous()
    dev = _build.require_cuda(Xt, rf, blk)
    p, m = Xt.shape
    n = blk.numel() * block_size
    scores = torch.empty(n, dtype=torch.float32, device=dev)
    fn = _build.function("fw_grad", "sampled_scores_launch", _SCORES_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(Xt.data_ptr(), rf.data_ptr(), blk.data_ptr(), scores.data_ptr(),
                 p, m, n, block_size, None, 1, 0, 0, 0, _build.dtype_code(Xt),
                 _build.stream(dev))
        sampled_scores.launches += 1
    _build.check("fw_grad", err, "sampled_scores")
    return scores


def vertex_argmax(scores: torch.Tensor, blk: torch.Tensor, block_size: int, p_valid: int):
    """``(i_star, g_star)`` as 0-d device tensors (int64, f32) from the
    sampled scores. A CPU tensor takes the plain version."""
    if scores.device.type == "cpu":
        return argmax_plain(scores, blk, block_size, p_valid)
    blk = blk.long().contiguous()
    if scores.dtype != torch.float32 or scores.numel() != blk.numel() * block_size or blk.numel() == 0:
        raise ValueError("vertex_argmax needs f32 scores of length nb * block_size, nb >= 1")
    dev = _build.require_cuda(scores, blk)
    i_star = torch.empty((), dtype=torch.int64, device=dev)
    g_star = torch.empty((), dtype=torch.float32, device=dev)
    scratch, sms, cap = _argmax_scratch(dev)
    blocks, chunk = argmax_grid(scores.numel(), sms)
    fn = _build.function("fw_grad", "vertex_argmax_launch", _ARGMAX_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(scores.data_ptr(), blk.data_ptr(), scores.numel(), block_size, p_valid,
                 blocks, chunk, scratch.data_ptr(), cap, i_star.data_ptr(), g_star.data_ptr(),
                 None, 1, 1, 0, 0, *_NO_SHIFT, _build.stream(dev))
        vertex_argmax.launches += 1
    _build.check("fw_grad", err, "vertex_argmax")
    return i_star, g_star


def vertex_argmax_shifted(scores: torch.Tensor, blk: torch.Tensor, block_size: int,
                          p_valid: int, shift: ScoreShift):
    """``(i_star, g_raw, g_sel)`` as 0-d device tensors (int64, f32, f32):
    the first max of ``|scores + shift(idx)|`` (``ScoreShift``'s ``beta (p_valid,)``
    and ``scale ()``). A CPU tensor takes the plain version; a CUDA tensor
    launches the shifted instantiation of the argmax kernel (or raises)."""
    if scores.device.type == "cpu":
        return argmax_shifted_plain(scores, blk, block_size, p_valid, shift)
    blk = blk.long().contiguous()
    if (scores.dtype != torch.float32 or scores.numel() != blk.numel() * block_size
            or blk.numel() == 0):
        raise ValueError("vertex_argmax_shifted needs f32 scores of length nb * block_size, "
                         "nb >= 1")
    beta, beta_stride, beta_code, scale, l2 = _shift_args(shift, p_valid, lanes=False)
    dev = _build.require_cuda(scores, blk, beta, scale)
    i_star = torch.empty((), dtype=torch.int64, device=dev)
    g_raw = torch.empty((), dtype=torch.float32, device=dev)
    g_sel = torch.empty((), dtype=torch.float32, device=dev)
    scratch, sms, cap = _argmax_scratch(dev)
    blocks, chunk = argmax_grid(scores.numel(), sms)
    fn = _build.function("fw_grad", "vertex_argmax_launch", _ARGMAX_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(scores.data_ptr(), blk.data_ptr(), scores.numel(), block_size, p_valid,
                 blocks, chunk, scratch.data_ptr(), cap, i_star.data_ptr(), g_raw.data_ptr(),
                 None, 1, 1, 0, 0, beta.data_ptr(), beta_stride, beta_code, scale.data_ptr(),
                 l2, g_sel.data_ptr(), _build.stream(dev))
        vertex_argmax_shifted.launches += 1
    _build.check("fw_grad", err, "vertex_argmax_shifted")
    return i_star, g_raw, g_sel


def owned_plain(scores: torch.Tensor, rows: torch.Tensor, off: int, p_local: int):
    """``scores`` where the global ``rows`` lie in ``[off, off + p_local)``,
    +0.0 elsewhere."""
    own = (rows >= off) & (rows < off + p_local)
    return torch.where(own, scores, torch.zeros((), dtype=scores.dtype, device=scores.device))


def sampled_scores_owned_plain(Xt, r, blk, block_size: int, off: int):
    """The plain version of ``sampled_scores_owned``: the plain scores of the
    owned rows (their local rows, clipped into the tile for the others)
    masked to +0.0 off the tile."""
    p_local = Xt.shape[0]
    idx = block_indices(blk.long(), block_size)
    loc = (idx - off).clamp(0, p_local - 1)
    scores = -(Xt.index_select(0, loc).float() @ r.float())
    return owned_plain(scores, idx, off, p_local)


def sampled_scores_owned(Xt: torch.Tensor, r: torch.Tensor, blk: torch.Tensor,
                         block_size: int, off: int):
    """Scores ``(nb * block_size,)`` f32 of the sampled global coordinates on
    a rank's tile ``Xt (p_local, m)`` of the global rows ``[off, off +
    p_local)``: an owned coordinate's score, +0.0 for any other. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel's
    ``OWNED`` instantiation (or raises)."""
    _check(Xt, r, blk)
    if Xt.device.type == "cpu":
        return sampled_scores_owned_plain(Xt, r, blk, block_size, off)
    rf = r.float().contiguous()
    blk = blk.long().contiguous()
    dev = _build.require_cuda(Xt, rf, blk)
    p_local, m = Xt.shape
    n = blk.numel() * block_size
    scores = torch.empty(n, dtype=torch.float32, device=dev)
    fn = _build.function("fw_grad", "sampled_scores_owned_launch", _OWNED_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(Xt.data_ptr(), rf.data_ptr(), blk.data_ptr(), scores.data_ptr(), p_local, m, n,
                 block_size, int(off), None, 1, 0, 0, 0, _build.dtype_code(Xt),
                 _build.stream(dev))
        sampled_scores_owned.launches += 1
    _build.check("fw_grad", err, "sampled_scores_owned")
    return scores


def fw_vertex(Xt, r, blk, block_size: int = 1, p_valid: int | None = None):
    """The sampled FW vertex ``(i_star, g_star)``; ``p_valid`` defaults to p."""
    p_valid = Xt.shape[0] if p_valid is None else p_valid
    scores = sampled_scores(Xt, r, blk, block_size)
    return vertex_argmax(scores, blk, block_size, p_valid)


# --------------------------------------------------------------------------
# Lanes: one launch for L delta lanes
# --------------------------------------------------------------------------


def lane_list(lanes) -> list:
    """The lanes to run, as host ints (a tensor or a sequence)."""
    return lanes.tolist() if isinstance(lanes, torch.Tensor) else [int(x) for x in lanes]


def lane_blk(blk: torch.Tensor, lane: int) -> torch.Tensor:
    """Lane ``lane``'s sampled ids: its row of ``(L, nb)``, or the shared
    ``(nb,)``."""
    return blk if blk.dim() == 1 else blk[lane]


def check_lanes(r, blk, lanes):
    if r.dim() != 2 or blk.dim() not in (1, 2) or blk.shape[-1] == 0 or (
            blk.dim() == 2 and blk.shape[0] != r.shape[0]):
        raise ValueError(
            f"need r (L, m) and blk (L, nb >= 1) or (nb >= 1,), got {tuple(r.shape)}, "
            f"{tuple(blk.shape)}"
        )
    if lanes.dim() != 1 or lanes.dtype != torch.int32:
        raise ValueError(f"need lanes, the int32 ids of the lanes that run, got {lanes}")


def argmax_shifted(scores, blk, block_size: int, p_valid: int, shift: ScoreShift,
                   use_kernel: bool = True):
    """``(i_star, g_raw, g_sel)``, the argmax of the shifted scores:
    ``vertex_argmax_shifted`` with ``use_kernel`` (the kernel on a CUDA
    tensor), the plain version otherwise."""
    fn = vertex_argmax_shifted if use_kernel else argmax_shifted_plain
    return fn(scores, blk, block_size, p_valid, shift)


def sampled_scores_lanes_plain(Xt, r, blk, block_size: int, lanes):
    """The plain version: ``sampled_scores_plain`` once per listed lane, on
    a copy of its residual row (an operand of its own, as the one-lane call
    gets). Rows of lanes not listed are zero."""
    n = blk.shape[-1] * block_size
    scores = torch.zeros((r.shape[0], n), dtype=torch.float32, device=r.device)
    for lane in lane_list(lanes):
        scores[lane] = sampled_scores_plain(Xt, r[lane].clone(), lane_blk(blk, lane), block_size)
    return scores


def argmax_lanes_plain(scores, blk, block_size: int, p_valid: int, lanes):
    """The plain version: ``argmax_plain`` once per listed lane; a lane not
    listed gets ``(-1, 0)``."""
    L = scores.shape[0]
    i_star = torch.full((L,), -1, dtype=torch.int64, device=scores.device)
    g_star = torch.zeros(L, dtype=torch.float32, device=scores.device)
    for lane in lane_list(lanes):
        i, g = argmax_plain(scores[lane], lane_blk(blk, lane), block_size, p_valid)
        i_star[lane] = i
        g_star[lane] = g
    return i_star, g_star


def argmax_shifted_lanes_plain(scores, blk, block_size: int, p_valid: int, lanes,
                               shift: ScoreShift):
    """The plain version: ``argmax_shifted_plain`` once per listed lane with
    its row of the shift; a lane not listed gets ``(-1, 0, 0)``."""
    L = scores.shape[0]
    i_star = torch.full((L,), -1, dtype=torch.int64, device=scores.device)
    g_raw = torch.zeros(L, dtype=torch.float32, device=scores.device)
    g_sel = torch.zeros(L, dtype=torch.float32, device=scores.device)
    for lane in lane_list(lanes):
        i, gr, gs = argmax_shifted_plain(scores[lane], lane_blk(blk, lane), block_size, p_valid,
                                         shift.lane(lane))
        i_star[lane] = i
        g_raw[lane] = gr
        g_sel[lane] = gs
    return i_star, g_raw, g_sel


def sampled_scores_lanes(Xt: torch.Tensor, r: torch.Tensor, blk: torch.Tensor,
                         block_size: int, lanes: torch.Tensor) -> torch.Tensor:
    """Scores ``(L, nb * block_size)`` f32 of each listed lane's sampled
    coordinates against its residual row ``r[lane]``, in one launch (rows
    of lanes not listed are not written; no lane listed, no launch). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel."""
    _check(Xt, r[0], lane_blk(blk, 0))
    check_lanes(r, blk, lanes)
    if Xt.device.type == "cpu":
        return sampled_scores_lanes_plain(Xt, r, blk, block_size, lanes)
    rf = r.float().contiguous()
    blk = blk.long().contiguous()
    dev = _build.require_cuda(Xt, rf, blk, lanes)
    L, m = rf.shape
    p = Xt.shape[0]
    n = blk.shape[-1] * block_size
    n4 = -(-n // 4) * 4
    scores = torch.empty((L, n4), dtype=torch.float32, device=dev)
    if lanes.numel() == 0:
        return scores[:, :n]
    fn = _build.function("fw_grad", "sampled_scores_launch", _SCORES_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(Xt.data_ptr(), rf.data_ptr(), blk.data_ptr(), scores.data_ptr(), p, m, n,
                 block_size, *_build.lane_ids_arg(lanes), m,
                 blk.shape[1] if blk.dim() == 2 else 0, n4, _build.dtype_code(Xt),
                 _build.stream(dev))
        sampled_scores_lanes.launches += 1
    _build.check("fw_grad", err, "sampled_scores_lanes")
    return scores[:, :n]


def sampled_scores_lanes_owned_plain(Xt, r, blk, block_size: int, lanes, off: int):
    """The plain version: ``sampled_scores_owned_plain`` once per listed lane,
    on a copy of its residual row. Rows of lanes not listed are zero."""
    n = blk.shape[-1] * block_size
    scores = torch.zeros((r.shape[0], n), dtype=torch.float32, device=r.device)
    for lane in lane_list(lanes):
        scores[lane] = sampled_scores_owned_plain(Xt, r[lane].clone(), lane_blk(blk, lane),
                                                  block_size, off)
    return scores


def sampled_scores_lanes_owned(Xt: torch.Tensor, r: torch.Tensor, blk: torch.Tensor,
                               block_size: int, lanes: torch.Tensor, off: int) -> torch.Tensor:
    """``sampled_scores_lanes`` on a rank's tile (``sampled_scores_owned``'s
    rule a lane), in one launch of the lane ``OWNED`` instantiation; rows of
    lanes not listed are not written. A CPU tensor takes the plain version."""
    _check(Xt, r[0], lane_blk(blk, 0))
    check_lanes(r, blk, lanes)
    if Xt.device.type == "cpu":
        return sampled_scores_lanes_owned_plain(Xt, r, blk, block_size, lanes, off)
    rf = r.float().contiguous()
    blk = blk.long().contiguous()
    dev = _build.require_cuda(Xt, rf, blk, lanes)
    L, m = rf.shape
    p_local = Xt.shape[0]
    n = blk.shape[-1] * block_size
    n4 = -(-n // 4) * 4
    scores = torch.empty((L, n4), dtype=torch.float32, device=dev)
    if lanes.numel() == 0:
        return scores[:, :n]
    fn = _build.function("fw_grad", "sampled_scores_owned_launch", _OWNED_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(Xt.data_ptr(), rf.data_ptr(), blk.data_ptr(), scores.data_ptr(), p_local, m, n,
                 block_size, int(off), *_build.lane_ids_arg(lanes), m,
                 blk.shape[1] if blk.dim() == 2 else 0, n4, _build.dtype_code(Xt),
                 _build.stream(dev))
        sampled_scores_lanes_owned.launches += 1
    _build.check("fw_grad", err, "sampled_scores_lanes_owned")
    return scores[:, :n]


def _support_args(shift: ScoreShift, L: int, p_valid: int, dev):
    """The bitmap's arguments (pointer, row stride in words) of the lane
    launches: none without one; else ``(L, support_words(p_valid))`` int32
    rows on the operands' device."""
    sup = shift.support
    if sup is None:
        return None, 0
    words = support_words(p_valid)
    if (sup.dtype != torch.int32 or sup.shape != (L, words) or sup.stride(1) != 1
            or sup.stride(0) % 4 or sup.data_ptr() % 16 or sup.device != dev):
        raise ValueError(f"the shift's support must be int32 ({L}, {words}) rows on {dev}, "
                         "each on 16 bytes, got "
                         f"{sup.dtype} {tuple(sup.shape)} on {sup.device}")
    return sup.data_ptr(), sup.stride(0)


def _argmax_lanes_launch(name, scores, blk, block_size: int, p_valid: int, lanes, shift,
                         route=None):
    """Launch the lane argmax (``shift`` None) or its shifted instantiation
    on CUDA tensors on ``route`` (default ``lane_route(n)``); returns the
    kernel's outputs ``(i_star, g_star)`` or ``(i_star, g_raw, g_sel)``. A
    support bitmap is taken by the cluster route only."""
    blk = blk.long().contiguous()
    L, n = scores.shape
    if (scores.dtype != torch.float32 or n != blk.shape[-1] * block_size or scores.stride(1) != 1
            or scores.stride(0) % 4 or scores.data_ptr() % 16):
        raise ValueError(f"{name} needs f32 scores (L, nb * block_size) whose rows start on 16 "
                         "bytes (as sampled_scores_lanes returns them)")
    dev = _build.require_cuda(blk, lanes)
    if scores.device != dev:
        raise ValueError(f"kernel operands must share one CUDA device, got {scores.device}")
    if n < 1:
        raise ValueError("vertex_argmax needs at least one score")
    route = lane_route(n) if route is None else route
    if route not in LANE_ROUTES:
        raise ValueError(f"route must be one of {LANE_ROUTES}, got {route!r}")
    if route == "ticket" and shift is not None and shift.support is not None:
        raise ValueError(f"the ticket route ({n} scores a lane) keeps no support bitmap: "
                         "vertex.lane_support builds one only for the cluster route")
    i_star = torch.empty(L, dtype=torch.int64, device=dev)
    g_star = torch.empty(L, dtype=torch.float32, device=dev)
    shift_args, g_sel = _NO_SHIFT, None
    if shift is not None:
        beta, beta_stride, beta_code, scale, l2 = _shift_args(shift, p_valid, lanes=True)
        if beta.shape[0] != L or scale.shape != (L,):
            raise ValueError(f"the shift's beta and scale must hold the {L} lanes")
        _build.require_cuda(beta, scale)
        g_sel = torch.empty(L, dtype=torch.float32, device=dev)
        shift_args = (beta.data_ptr(), beta_stride, beta_code, scale.data_ptr(), l2,
                      g_sel.data_ptr())
    wrapper = vertex_argmax_lanes if shift is None else vertex_argmax_shifted_lanes
    common = (*_build.lane_ids_arg(lanes), L, scores.stride(0),
              blk.shape[1] if blk.dim() == 2 else 0, *shift_args)
    if route == "cluster":
        sup = (None, 0) if shift is None else _support_args(shift, L, p_valid, dev)
        fn = _build.function("fw_grad", "vertex_argmax_lanes_cluster_launch", _CLUSTER_ARGTYPES)
        with torch.cuda.device(dev):
            err = fn(scores.data_ptr(), blk.data_ptr(), n, block_size, p_valid,
                     i_star.data_ptr(), g_star.data_ptr(), *common, *sup, _build.stream(dev))
            wrapper.launches += 1
    else:
        scratch, sms, cap = _argmax_scratch(dev, max(lanes.numel(), 1))
        blocks, chunk = argmax_grid(n, sms)
        fn = _build.function("fw_grad", "vertex_argmax_launch", _ARGMAX_ARGTYPES)
        with torch.cuda.device(dev):
            err = fn(scores.data_ptr(), blk.data_ptr(), n, block_size, p_valid, blocks, chunk,
                     scratch.data_ptr(), cap, i_star.data_ptr(), g_star.data_ptr(), *common,
                     _build.stream(dev))
            wrapper.launches += 1
    _build.check("fw_grad", err, name)
    return (i_star, g_star) if shift is None else (i_star, g_star, g_sel)


def vertex_argmax_lanes(scores: torch.Tensor, blk: torch.Tensor, block_size: int,
                        p_valid: int, lanes: torch.Tensor, route=None):
    """``(i_star (L,), g_star (L,))`` (int64, f32) of each listed lane's
    scores row in one launch; a lane not listed gets ``(-1, 0)``. A CPU
    tensor takes the plain version. ``route`` ('cluster' or 'ticket')
    overrides ``lane_route`` (the card's tests and timings compare them)."""
    check_lanes(scores, blk, lanes)
    if scores.device.type == "cpu":
        return argmax_lanes_plain(scores, blk, block_size, p_valid, lanes)
    return _argmax_lanes_launch("vertex_argmax_lanes", scores, blk, block_size, p_valid, lanes,
                                None, route)


def vertex_argmax_shifted_lanes(scores: torch.Tensor, blk: torch.Tensor, block_size: int,
                                p_valid: int, lanes: torch.Tensor, shift: ScoreShift,
                                route=None):
    """``(i_star, g_raw, g_sel)``, each ``(L,)``: each listed lane's
    ``vertex_argmax_shifted`` on its scores row and its row of the
    lane-stacked ``shift`` (``beta (L, p_valid)``, ``scale (L,)``), in one
    launch of the shifted lane instantiation; a lane not listed gets ``(-1,
    0, 0)``. With ``shift.support`` the kernel reads beta only where a bit
    is set and sets each winner's bit in place (on the CPU, the plain
    version, which ignores the bitmap, then ``mark_support``); the ticket
    route takes none. ``route`` as ``vertex_argmax_lanes``'s."""
    check_lanes(scores, blk, lanes)
    if scores.device.type == "cpu":
        out = argmax_shifted_lanes_plain(scores, blk, block_size, p_valid, lanes, shift)
        if shift.support is not None:
            mark_support(shift.support, out[0], p_valid)
        return out
    return _argmax_lanes_launch("vertex_argmax_shifted_lanes", scores, blk, block_size, p_valid,
                                lanes, shift, route)


sampled_scores.launches = 0
vertex_argmax.launches = 0
sampled_scores_lanes.launches = 0
vertex_argmax_lanes.launches = 0
vertex_argmax_shifted.launches = 0
vertex_argmax_shifted_lanes.launches = 0
sampled_scores_owned.launches = 0
sampled_scores_lanes_owned.launches = 0
