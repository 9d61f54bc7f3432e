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
ticket counter, reduces the partials and resets the counter. That comparator is a total order, so
the result is bit-exact with ``argmax_plain`` whichever block is last.
The result stays in device memory. The partials and the counter live in
a scratch buffer allocated once per device and reused by every launch in
stream order: two streams must not run ``vertex_argmax`` on one device
at once.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.padding import pad_rows

_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (X, r, blk, scores, p, m, n, bs, dtype, stream)
_SCORES_ARGTYPES = [_PTR] * 4 + [_I64, _I32, _I64, _I32, _I32, _PTR]
# (scores, blk, n, bs, p_valid, blocks, chunk, scratch, i_star, g_star, stream)
_ARGMAX_ARGTYPES = [_PTR, _PTR, _I64, _I32, _I64, _I32, _I64, _PTR, _PTR, _PTR, _PTR]
ARGMAX_THREADS = 256  # AM_THREADS of csrc/fw_grad.cu
ARGMAX_PER_THREAD = 8  # scores a thread, below the cap
ARGMAX_BLOCKS_PER_SM = 2
_scratch = {}  # device index -> (the argmax's scratch buffer, SM count)


def argmax_grid(n: int, sms: int):
    """``(blocks, chunk)`` of ``vertex_argmax`` for n scores on a card of
    ``sms`` SMs: every block takes ``chunk`` (a multiple of 4) contiguous
    scores, the last one the rest, none empty."""
    if n < 1:
        raise ValueError("vertex_argmax needs at least one score")
    blocks = min(ARGMAX_BLOCKS_PER_SM * sms, -(-n // (ARGMAX_THREADS * ARGMAX_PER_THREAD)))
    chunk = -(-n // (4 * blocks)) * 4
    return -(-n // chunk), chunk


def _argmax_scratch(dev: torch.device):
    """The device's scratch buffer (16 bytes for the ticket counter, zero
    between launches, then room for the partials of the largest grid) and
    its SM count."""
    got = _scratch.get(dev.index)
    if got is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        buf = torch.zeros(16 + 12 * ARGMAX_BLOCKS_PER_SM * sms, dtype=torch.uint8, device=dev)
        got = _scratch[dev.index] = (buf, sms)
    return got


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
                 p, m, n, block_size, _build.dtype_code(Xt), _build.stream(dev))
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
    scratch, sms = _argmax_scratch(dev)
    blocks, chunk = argmax_grid(scores.numel(), sms)
    fn = _build.function("fw_grad", "vertex_argmax_launch", _ARGMAX_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(scores.data_ptr(), blk.data_ptr(), scores.numel(), block_size, p_valid,
                 blocks, chunk, scratch.data_ptr(), i_star.data_ptr(), g_star.data_ptr(),
                 _build.stream(dev))
        vertex_argmax.launches += 1
    _build.check("fw_grad", err, "vertex_argmax")
    return i_star, g_star


def fw_vertex(Xt, r, blk, block_size: int = 1, p_valid: int | None = None):
    """The sampled FW vertex ``(i_star, g_star)``; ``p_valid`` defaults to p."""
    p_valid = Xt.shape[0] if p_valid is None else p_valid
    scores = sampled_scores(Xt, r, blk, block_size)
    return vertex_argmax(scores, blk, block_size, p_valid)


sampled_scores.launches = 0
vertex_argmax.launches = 0
