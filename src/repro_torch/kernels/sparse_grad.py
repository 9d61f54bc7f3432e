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

Design: one warp per sampled feature. Its ``nnz_max`` value and row slots
are contiguous, so the lanes read them coalesced; the residual is gathered
from a shared-memory copy (64.3 KB at m = 16,087; above 224 KB it is read
through L1/L2). The grid is persistent (as many blocks of 512 threads as
the occupancy calculator lets reside), so each block stages the residual
once and its warps stride over the sampled features. Sums in f32 from f32
or bf16 storage; a feature past the padded arrays scores 0 without a read.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fw_grad import block_indices

_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (values, rows, r, blk, scores, n, bs, nnz_max, n_feat, m, dtype, stream)
_ARGTYPES = [_PTR] * 5 + [_I64, _I32, _I32, _I64, _I32, _I32, _PTR]


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
    tensor takes the plain version; a CUDA tensor launches the kernel."""
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
    scores = torch.empty(n, dtype=torch.float32, device=dev)
    fn = _build.function("sparse_grad", "sparse_sampled_scores_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(values.data_ptr(), rows.data_ptr(), rf.data_ptr(), blk.data_ptr(),
                 scores.data_ptr(), n, block_size, nnz, nblocks * bs0, rf.numel(),
                 _build.dtype_code(values), _build.stream(dev))
        sparse_sampled_scores.launches += 1
    _build.check("sparse_grad", err, "sparse_sampled_scores")
    return scores


sparse_sampled_scores.launches = 0
