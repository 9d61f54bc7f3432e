"""K5: the sampled scores over the block-ELL layout (paper eq. 9 on the
sparse design of ``repro_torch.sparse``).

``sparse_sampled_scores`` computes, for sampled aligned blocks ``blk`` of
width ``block_size`` over the features of ``values``/``rows``
``(nblocks, bs, nnz_max)``,

    scores[i*w + t] = -sum_k values[f, k] * r[rows[f, k]],  f = blk[i]*w + t

with the arrays read as ``(nblocks * bs, nnz_max)`` feature rows. Padded
slots (value 0 at row 0) and padded tail features score exactly 0; the
caller masks indices ``>= p`` out of the argmax (``fw_grad.vertex_argmax``).

Replaces the Pallas kernel ``sparse_sampled_scores`` at
``src/repro/kernels/sparse_grad/sparse_grad.py:87`` (entry at :64). Where
the reference scores sparse 'uniform' sampling with an XLA gather
(``src/repro/sparse/ops.py:106``, ``core/vertex.py:252-283``), the port runs
this kernel at width 1 instead: the same arrays viewed as ``(p_padded, 1,
nnz_max)`` make feature ids into block ids, so one kernel computes the
function of that five-op chain. At width ``bs`` the ids are block ids
('block' and 'full' sampling, the reference's own K5 path).

Bound on an H100: bytes. A score must read its feature's ``nnz_max``
value slots (4 bytes each in f32; the padding is found only by reading
it), but a row index and a residual gather only for each stored nonzero,
so a launch moves at least n*nnz_max*4 + nnz*4 + n*4 + nb*8 + m*4 bytes
for the nnz nonzeros of the n scored features. At the E2006-log1p size
(kappa = 42,723 uniform, nnz_max 66, about 32 nonzeros a feature,
m = 16,087) that is about 17.4 MB, about 5.2 us at 3.35 TB/s.

Design: K7's scoring (``csrc/common.cuh``'s ``SlotRing``) without
the chunk's grid barrier and step machinery. One warp per feature makes
each feature a chain of memory latencies (its id, its slots, then the
gather), so instead one block of 1024 threads an SM gives every warp a
contiguous run of the score positions and streams its features, two at a
time, through a ring of ``RING_DEPTH`` stages of its own in shared memory:
ids loaded 32 at a time and handed out by shuffles; a feature's value
slots by 16-byte ``cp.async`` four ticks ahead, its row slots two ticks
ahead and only beside a stored nonzero (zero-filled otherwise, so the
padding's rows are not read); half h of the warp scores feature h of the
pair, lane q summing ``slot_dot``'s lane-q and lane-(q+16) partials and
finishing ``warp_sum``'s butterfly in the half: the same additions of the
same operands as the warp-per-feature score, so the scores keep their
bits. The residual is staged once a block by 16-byte ``cp.async``, in
flight with the ring's first pieces. ``ring_plan`` sizes the ring beside
the residual (a feature in pieces of 96, 64 or 32 slots where a whole one
does not fit). The two
widths run the same kernel: width 1 at arbitrary ids ('uniform'), width
``bs`` over whole aligned blocks ('block', 'full'), where a warp's run is
a stretch of contiguous features.

Two routes are chosen from the inputs: bf16 values, or a residual that
leaves no room for a ring (m past about 37,000 at nnz_max 66), run the
warp-per-feature kernel, each block staging the residual once (through
L1/L2 above 224 KB) and its warps striding over the features. Sums in f32
from f32 or bf16 storage; a feature past the padded arrays scores 0
without a read.

Lanes (``sparse_sampled_scores_lanes``): L delta lanes of the batched
engine in one launch, on either route. The grid gains a row of blocks for
each lane in ``lanes`` (int32; a frozen lane launches none), each row an
equal share of the persistent grid (one lane: the whole grid, as before),
each block staging its own lane's residual (64 KB at m = 16,087; a lane's
row that does not start on 16 bytes, m odd, is staged by 4-byte copies).
A feature's score does not depend on which warp or block computes it, so
each lane's scores have the bits of the one-lane launch. Scores are one
``(L, n4)`` buffer, n rounded up to 4, returned as the ``(L, n)`` view.
The ring was the route to extend rather than to replace: the change is
the lane's offsets and its share of the grid, and the ring itself, whose
bits ``K5_SHA256`` pins, is untouched. Bound: L_active times the one-lane
bytes.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fw_grad import (block_indices, check_lanes, lane_blk, lane_list,
                                         owned_plain)

_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (values, rows, r, blk, scores, n, bs, nnz_max, n_feat, m, depth, slots, stride, lane_ids,
#  n_run, r_stride, blk_stride, sc_stride, dtype, stream)
_ARGTYPES = ([_PTR] * 5 + [_I64, _I32, _I32, _I64] + [_I32] * 4 + [_PTR, _I32] + [_I64] * 3
             + [_I32, _PTR])

# (values, rows, r, blk, scores, n, bs, nnz_max, n_feat, m, off, depth, slots, stride,
#  lane_ids, n_run, r_stride, blk_stride, sc_stride, dtype, stream)
_OWNED_ARGTYPES = ([_PTR] * 5 + [_I64, _I32, _I32, _I64, _I32, _I64] + [_I32] * 3
                   + [_PTR, _I32] + [_I64] * 3 + [_I32, _PTR])

# The ring of K5 and K7 (csrc/common.cuh, SlotRing), sized by `ring_plan`
SMEM_BYTES = 224 * 1024  # OPTIN_SMEM_BYTES of csrc/common.cuh: a block's dynamic shared memory
RING_DEPTH = 4  # ring stages a warp (RING_DEPTH of csrc/common.cuh)
WHOLE_MAX = 124  # the most slots a piece holds whole: 32 chunks of 16 bytes from any offset
PIECE_SLOTS = (96, 64, 32)  # a piece's slots when a feature takes several, larger first
META_BYTES = 16  # a piece's Meta


class RingPlan(NamedTuple):
    threads: int  # the block: 1024 with a ring (one an SM), 512 without (as many as fit)
    depth: int  # ring stages a warp (RING_DEPTH); 0: no ring, features scored from device memory
    slots: int  # slots of a piece: nnz_max (up to WHOLE_MAX), or one of PIECE_SLOTS below it
    stride: int  # floats a piece's values (and its rows) take: slots + 3, whole 16-byte chunks

    def smem_bytes(self, m: int) -> int:
        """Dynamic shared memory a block takes: the residual (m floats,
        rounded up to 16 bytes), then each warp's stages of two pieces (a
        pair of features) and their Metas."""
        return (4 * (-(-m // 4) * 4)
                + self.threads // 32 * self.depth * 2 * (2 * self.stride * 4 + META_BYTES))


NO_RING = RingPlan(512, 0, 0, 0)


def ring_plan(m: int, nnz_max: int, extra: int = 0) -> RingPlan:
    """The ring for a residual of ``m`` and ``nnz_max`` slots a feature:
    one 1024-thread block an SM, each warp with ``RING_DEPTH`` stages of a
    pair's pieces beside the residual, a piece the whole feature (up to
    ``WHOLE_MAX`` slots) or else the largest of ``PIECE_SLOTS`` that fits
    with ``extra`` bytes beside it (K7's elastic-net ledger). Where none
    fits, ``NO_RING``: 512-thread blocks score the features from device
    memory."""
    whole = (nnz_max,) if 1 <= nnz_max <= WHOLE_MAX else ()
    for slots in whole + tuple(x for x in PIECE_SLOTS if x < nnz_max):
        pl = RingPlan(1024, RING_DEPTH, slots, -(-(slots + 3) // 4) * 4)
        if pl.smem_bytes(m) + extra <= SMEM_BYTES:
            return pl
    return NO_RING


def scores_plan(dtype: torch.dtype, m: int, nnz_max: int) -> RingPlan:
    """K5's route on the card: the ring (``ring_plan``) for f32 values where
    one fits beside the residual, else ``NO_RING``, the warp-per-feature
    kernel (bf16 values, or m past about 37,000 at nnz_max 66)."""
    return ring_plan(m, nnz_max) if dtype == torch.float32 else NO_RING


def sparse_sampled_scores_plain(values, rows, r, blk, block_size: int):
    """The plain PyTorch version (reference ``kernels/sparse_grad/ref.py``)."""
    nnz = values.shape[-1]
    feat = block_indices(blk.long(), block_size)
    vals = values.reshape(-1, nnz).index_select(0, feat).float()
    idx = rows.reshape(-1, nnz).index_select(0, feat)
    gathered = r.float().index_select(0, idx.reshape(-1)).view(idx.shape)
    return -(vals * gathered).sum(dim=1)


def _check(values, rows, r, blk):
    if (values.dim() != 3 or rows.shape != values.shape or r.dim() != 1 or blk.dim() != 1
            or blk.numel() == 0):
        raise ValueError(
            f"need values and rows (nblocks, bs, nnz_max), r (m,), blk (nb >= 1,), got "
            f"{tuple(values.shape)}, {tuple(rows.shape)}, {tuple(r.shape)}, {tuple(blk.shape)}"
        )


def sparse_sampled_scores(values: torch.Tensor, rows: torch.Tensor, r: torch.Tensor,
                          blk: torch.Tensor, block_size: int) -> torch.Tensor:
    """Scores ``(nb * block_size,)`` f32 of the sampled features. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (or
    raises: with a ring, ``values`` and ``rows`` must start on 16-byte
    boundaries, as every array the port allocates does)."""
    _check(values, rows, r, blk)
    if values.device.type == "cpu":
        return sparse_sampled_scores_plain(values, rows, r, blk, block_size)
    if rows.dtype != torch.int32:
        raise TypeError(f"the row slots must be int32, got {rows.dtype}")
    rf = r.float().contiguous()
    blk = blk.long().contiguous()
    dev = _build.require_cuda(values, rows, rf, blk)
    nblocks, bs0, nnz = values.shape
    n = blk.numel() * block_size
    pl = scores_plan(values.dtype, rf.numel(), nnz)
    if pl.depth and (values.data_ptr() % 16 or rows.data_ptr() % 16):
        raise ValueError("sparse_sampled_scores needs values and rows on 16-byte boundaries")
    if pl.depth and rf.data_ptr() % 16:  # the ring stages r by 16-byte copies
        rf = rf.clone()
    scores = torch.empty(n, dtype=torch.float32, device=dev)
    fn = _build.function("sparse_grad", "sparse_sampled_scores_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(values.data_ptr(), rows.data_ptr(), rf.data_ptr(), blk.data_ptr(),
                 scores.data_ptr(), n, block_size, nnz, nblocks * bs0, rf.numel(), pl.depth,
                 pl.slots, pl.stride, None, 1, 0, 0, 0, _build.dtype_code(values),
                 _build.stream(dev))
        sparse_sampled_scores.launches += 1
    _build.check("sparse_grad", err, "sparse_sampled_scores")
    return scores


def sparse_sampled_scores_lanes_plain(values, rows, r, blk, block_size: int, lanes):
    """The plain version: ``sparse_sampled_scores_plain`` once per listed
    lane, on a copy of its residual row. Rows of lanes not listed are zero."""
    n = blk.shape[-1] * block_size
    scores = torch.zeros((r.shape[0], n), dtype=torch.float32, device=r.device)
    for lane in lane_list(lanes):
        scores[lane] = sparse_sampled_scores_plain(values, rows, r[lane].clone(),
                                                   lane_blk(blk, lane), block_size)
    return scores


def sparse_sampled_scores_lanes(values: torch.Tensor, rows: torch.Tensor, r: torch.Tensor,
                                blk: torch.Tensor, block_size: int,
                                lanes: torch.Tensor) -> torch.Tensor:
    """Scores ``(L, nb * block_size)`` f32 of each listed lane's sampled
    features (``blk (L, nb)``, or ``(nb,)`` shared) against its residual row
    ``r[lane]``, in one launch; rows of lanes not listed are not written. A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (or raises)."""
    _check(values, rows, r[0], lane_blk(blk, 0))
    check_lanes(r, blk, lanes)
    if values.device.type == "cpu":
        return sparse_sampled_scores_lanes_plain(values, rows, r, blk, block_size, lanes)
    if rows.dtype != torch.int32:
        raise TypeError(f"the row slots must be int32, got {rows.dtype}")
    rf = r.float().contiguous()
    blk = blk.long().contiguous()
    dev = _build.require_cuda(values, rows, rf, blk, lanes)
    nblocks, bs0, nnz = values.shape
    L, m = rf.shape
    n = blk.shape[-1] * block_size
    n4 = -(-n // 4) * 4
    pl = scores_plan(values.dtype, m, nnz)
    if pl.depth and (values.data_ptr() % 16 or rows.data_ptr() % 16 or rf.data_ptr() % 16):
        raise ValueError("sparse_sampled_scores_lanes needs values, rows and r on 16-byte "
                         "boundaries")
    scores = torch.empty((L, n4), dtype=torch.float32, device=dev)
    if lanes.numel() == 0:  # every lane frozen: nothing to score, no launch
        return scores[:, :n]
    fn = _build.function("sparse_grad", "sparse_sampled_scores_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(values.data_ptr(), rows.data_ptr(), rf.data_ptr(), blk.data_ptr(),
                 scores.data_ptr(), n, block_size, nnz, nblocks * bs0, m, pl.depth, pl.slots,
                 pl.stride, *_build.lane_ids_arg(lanes), m,
                 blk.shape[1] if blk.dim() == 2 else 0, n4, _build.dtype_code(values),
                 _build.stream(dev))
        sparse_sampled_scores_lanes.launches += 1
    _build.check("sparse_grad", err, "sparse_sampled_scores_lanes")
    return scores[:, :n]


# --------------------------------------------------------------------------
# Owned scores: a rank's tile of the mesh (the distributed backend)
# --------------------------------------------------------------------------


def sparse_sampled_scores_owned_plain(values, rows, r, blk, block_size: int, off: int):
    """The plain version of ``sparse_sampled_scores_owned``: the plain scores
    of the owned features (their local features, clipped into the tile for
    the others) masked to +0.0 off the tile."""
    n_feat = values.shape[0] * values.shape[1]
    feat = block_indices(blk.long(), block_size)
    loc = (feat - off).clamp(0, n_feat - 1)
    scores = sparse_sampled_scores_plain(values, rows, r, loc, 1)
    return owned_plain(scores, feat, off, n_feat)


def _owned_launch(wrapper, values, rows, rf, blk, block_size, off, lanes, n4):
    """One launch of K5's ``OWNED`` instantiation (``lanes`` None: one lane)."""
    dev = _build.require_cuda(values, rows, rf, blk, *(() if lanes is None else (lanes,)))
    if rows.dtype != torch.int32:
        raise TypeError(f"the row slots must be int32, got {rows.dtype}")
    nblocks, bs0, nnz = values.shape
    m = rf.shape[-1]
    n = blk.shape[-1] * block_size
    pl = scores_plan(values.dtype, m, nnz)
    if pl.depth and (values.data_ptr() % 16 or rows.data_ptr() % 16):
        raise ValueError(f"{wrapper.__name__} needs values and rows on 16-byte boundaries")
    if pl.depth and rf.data_ptr() % 16:
        if lanes is not None:
            raise ValueError(f"{wrapper.__name__} needs r on 16-byte boundaries")
        rf = rf.clone()
    if lanes is None:
        scores = torch.empty(n, dtype=torch.float32, device=dev)
        lane_args = (None, 1, 0, 0, 0)
    else:
        scores = torch.empty((rf.shape[0], n4), dtype=torch.float32, device=dev)
        if lanes.numel() == 0:
            return scores[:, :n]
        lane_args = (*_build.lane_ids_arg(lanes), m, blk.shape[1] if blk.dim() == 2 else 0, n4)
    fn = _build.function("sparse_grad", "sparse_sampled_scores_owned_launch", _OWNED_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(values.data_ptr(), rows.data_ptr(), rf.data_ptr(), blk.data_ptr(),
                 scores.data_ptr(), n, block_size, nnz, nblocks * bs0, m, int(off), pl.depth,
                 pl.slots, pl.stride, *lane_args, _build.dtype_code(values), _build.stream(dev))
        wrapper.launches += 1
    _build.check("sparse_grad", err, wrapper.__name__)
    return scores if lanes is None else scores[:, :n]


def sparse_sampled_scores_owned(values: torch.Tensor, rows: torch.Tensor, r: torch.Tensor,
                                blk: torch.Tensor, block_size: int, off: int) -> torch.Tensor:
    """K5 on a rank's tile of the mesh: ``values``/``rows`` hold the local
    features of the global range ``[off, off + n_feat)`` and ``blk`` global
    ids; an owned feature's score is the one-device kernel's on its local
    feature, any other +0.0 (the reference's masked K5 call,
    ``src/repro/distributed/backend.py:110-130``). A CPU tensor takes the
    plain version; a CUDA tensor launches K5's ``OWNED`` instantiation, on
    K5's route (the ring, or the warp-per-feature kernel)."""
    _check(values, rows, r, blk)
    if values.device.type == "cpu":
        return sparse_sampled_scores_owned_plain(values, rows, r, blk, block_size, off)
    return _owned_launch(sparse_sampled_scores_owned, values, rows, r.float().contiguous(),
                         blk.long().contiguous(), block_size, off, None, 0)


def sparse_sampled_scores_lanes_owned_plain(values, rows, r, blk, block_size: int, lanes,
                                            off: int):
    """The plain version: ``sparse_sampled_scores_owned_plain`` once per
    listed lane, on a copy of its residual row. Rows of lanes not listed are
    zero."""
    n = blk.shape[-1] * block_size
    scores = torch.zeros((r.shape[0], n), dtype=torch.float32, device=r.device)
    for lane in lane_list(lanes):
        scores[lane] = sparse_sampled_scores_owned_plain(values, rows, r[lane].clone(),
                                                         lane_blk(blk, lane), block_size, off)
    return scores


def sparse_sampled_scores_lanes_owned(values: torch.Tensor, rows: torch.Tensor, r: torch.Tensor,
                                      blk: torch.Tensor, block_size: int, lanes: torch.Tensor,
                                      off: int) -> torch.Tensor:
    """``sparse_sampled_scores_lanes`` on a rank's tile
    (``sparse_sampled_scores_owned``'s rule a lane), one launch of K5's lane
    ``OWNED`` instantiation; rows of lanes not listed are not written."""
    _check(values, rows, r[0], lane_blk(blk, 0))
    check_lanes(r, blk, lanes)
    if values.device.type == "cpu":
        return sparse_sampled_scores_lanes_owned_plain(values, rows, r, blk, block_size, lanes,
                                                       off)
    n = blk.shape[-1] * block_size
    return _owned_launch(sparse_sampled_scores_lanes_owned, values, rows, r.float().contiguous(),
                         blk.long().contiguous(), block_size, off, lanes, -(-n // 4) * 4)


sparse_sampled_scores.launches = 0
sparse_sampled_scores_lanes.launches = 0
sparse_sampled_scores_owned.launches = 0
sparse_sampled_scores_lanes_owned.launches = 0
