"""Solver-facing ops over ``SparseBlockMatrix`` (the reference's
``sparse/ops.py``): the sparse twins of the scoring, setup and residual
primitives, and the matvecs behind warm starts and the certified gap.
Each costs O(touched slots) = O(kappa * nnz_max), not O(kappa * m).

The scores and the setup pass dispatch to the Hopper kernels K5
(``kernels/sparse_grad``) and K6 (``kernels/sparse_colstats``) when
``use_kernel`` is on, which on CPU tensors means their plain versions;
otherwise they run the plain PyTorch ops on any device. The uniform
width-1 scores (``sparse_gather_*``) run K5 at width 1 too, where the
reference has an XLA gather. The residual update, the column accessors and
the matvecs are plain PyTorch ops, as the reference leaves them to XLA
outside any Pallas kernel. The reference's TPU knobs (``interpret``,
``gather_mode``) have no counterpart here: ``FWConfig`` keeps them so a
reference config carries across, and nothing reads them.

Scores and statistics accumulate in f32 whatever the storage dtype;
selected scores and statistics come back in the storage dtype, as the
reference returns them.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels.fw_grad import argmax_plain, argmax_shifted, vertex_argmax
from repro_torch.kernels.sparse_colstats import sparse_colstats as _colstats_kernel
from repro_torch.kernels.sparse_colstats import sparse_colstats_plain
from repro_torch.kernels.sparse_grad import sparse_sampled_scores as _scores_kernel
from repro_torch.kernels.sparse_grad import sparse_sampled_scores_lanes
from repro_torch.kernels.sparse_grad import sparse_sampled_scores_plain
# the reference's names of the kernel entries this module imports
# (``repro.sparse.ops``'s imports of K5, its plain twin and K6)
from repro_torch.kernels.sparse_grad import sparse_sampled_scores  # noqa: F401
from repro_torch.kernels.sparse_grad import (  # noqa: F401
    sparse_sampled_scores_plain as sparse_sampled_scores_ref)
from repro_torch.kernels.sparse_colstats import (  # noqa: F401
    sparse_colstats as sparse_colstats_fused)
from repro_torch.kernels.step_tail import sparse_residual_update  # noqa: F401 (eq. 10)
from repro_torch.sparse.matrix import SparseBlockMatrix

ExtraFn = Callable[[torch.Tensor], torch.Tensor]


def _scores(mat: SparseBlockMatrix, w, blk, width: int, use_kernel: bool):
    fn = _scores_kernel if use_kernel else sparse_sampled_scores_plain
    return fn(mat.values, mat.rows, w, blk, width)


def _vertex(mat: SparseBlockMatrix, scores, blk, width: int, use_kernel: bool,
            extra_fn: Optional[ExtraFn]):
    """(i_star, g_raw, g_sel) over the scored features, indices >= p masked
    out and ties to the first in sample order: K2's argmax (or its plain
    version), with a score shift (a ``ScoreShift``) its shifted
    instantiation (or the shifted plain argmax)."""
    if extra_fn is None:
        i_star, g = (vertex_argmax if use_kernel else argmax_plain)(scores, blk, width, mat.p)
        g = g.to(mat.dtype)
        return i_star, g, g
    i_star, g_raw, g_sel = argmax_shifted(scores, blk, width, mat.p, extra_fn, use_kernel)
    return i_star, g_raw.to(mat.dtype), g_sel.to(mat.dtype)


def sparse_block_scores(mat: SparseBlockMatrix, resid: torch.Tensor, blk: torch.Tensor, *,
                        use_kernel: bool = True) -> torch.Tensor:
    """FW scores ``-z_i^T R`` (f32) of the features of the sampled blocks
    ``blk``, through K5 at width ``mat.block_size`` or its plain version."""
    return _scores(mat, resid, blk, mat.block_size, use_kernel)


def sparse_scores_lanes(mat: SparseBlockMatrix, w: torch.Tensor, blk: torch.Tensor, width: int,
                        lanes: torch.Tensor) -> torch.Tensor:
    """Scores ``(L, nb * width)`` (f32) of the batched lanes' sampled ids
    ``blk`` against their co-gradients ``w (L, m)``: K5's lane kernel, one
    launch for the lanes listed in ``lanes`` (its plain version on the CPU)."""
    return sparse_sampled_scores_lanes(mat.values, mat.rows, w, blk, width, lanes)


def sparse_fw_vertex_general(mat: SparseBlockMatrix, w: torch.Tensor, blk: torch.Tensor, *,
                             use_kernel: bool = True, extra_fn: Optional[ExtraFn] = None):
    """(i_star, g_raw, g_sel) over the sampled blocks, padding masked.
    ``g_sel`` carries the oracle's per-coordinate shift ``extra_fn(idx)``
    (None: the two coincide)."""
    scores = sparse_block_scores(mat, w, blk, use_kernel=use_kernel)
    return _vertex(mat, scores, blk, mat.block_size, use_kernel, extra_fn)


def sparse_fw_vertex(mat: SparseBlockMatrix, resid: torch.Tensor, blk: torch.Tensor, *,
                     use_kernel: bool = True):
    """(i_star, g_star) over the sampled blocks, the lasso's reduction."""
    i_star, g_star, _ = sparse_fw_vertex_general(mat, resid, blk, use_kernel=use_kernel)
    return i_star, g_star


def sparse_gather_scores(mat: SparseBlockMatrix, w: torch.Tensor, idx: torch.Tensor, *,
                         use_kernel: bool = True) -> torch.Tensor:
    """Raw f32 scores ``-z_i^T w`` at arbitrary sampled features ``idx``
    ('uniform' sampling): K5 at width 1, or its plain version."""
    return _scores(mat, w, idx, 1, use_kernel)


def sparse_gather_vertex_general(mat: SparseBlockMatrix, w: torch.Tensor, idx: torch.Tensor, *,
                                 extra_fn: Optional[ExtraFn] = None, use_kernel: bool = True):
    """(i_star, g_raw, g_sel) at arbitrary sampled features, with the
    optional score shift (see ``sparse_fw_vertex_general``)."""
    scores = sparse_gather_scores(mat, w, idx, use_kernel=use_kernel)
    return _vertex(mat, scores, idx, 1, use_kernel, extra_fn)


def sparse_gather_vertex(mat: SparseBlockMatrix, resid: torch.Tensor, idx: torch.Tensor, *,
                         use_kernel: bool = True):
    """(i_star, g_star) at arbitrary sampled features (lasso form)."""
    i_star, g_star, _ = sparse_gather_vertex_general(mat, resid, idx, use_kernel=use_kernel)
    return i_star, g_star


def sparse_colstats(mat: SparseBlockMatrix, y: torch.Tensor, *, use_kernel: bool = True):
    """One pass over the stored slots: ``z_i^T y`` and ``||z_i||^2`` for the
    p features (§4.2), through K6 or its plain version; f32 sums, returned
    in the storage dtype."""
    fn = _colstats_kernel if use_kernel else sparse_colstats_plain
    zty, znorm2 = fn(mat.values, mat.rows, y, mat.p)
    return zty.to(mat.dtype), znorm2.to(mat.dtype)


def sparse_column(mat: SparseBlockMatrix, i):
    """(values, rows) ELL slots of feature ``i`` (a 0-d device index: no
    sync), the z_star that eq. 10 touches."""
    i = torch.as_tensor(i, device=mat.device).view(1)
    return (mat.values.reshape(-1, mat.nnz_max).index_select(0, i).view(-1),
            mat.rows.reshape(-1, mat.nnz_max).index_select(0, i).view(-1))


def sparse_column_dense(mat: SparseBlockMatrix, i) -> torch.Tensor:
    """Dense (m,) column z_i: the ELL slots scatter-added into zeros
    (padded slots add 0.0 at row 0)."""
    vals, rows = sparse_column(mat, i)
    return torch.zeros(mat.m, dtype=mat.dtype, device=mat.device).index_add_(0, rows, vals)


def sparse_matvec(mat: SparseBlockMatrix, beta: torch.Tensor) -> torch.Tensor:
    """X @ alpha for a coefficient vector of length p (warm starts). Only
    the features with a nonzero coefficient are read (a zero coefficient
    adds exact zeros), so the sums equal the reference's full sweep; finding
    them reads ``beta`` on the host once.

    The sums run in one fixed order on every device (a CUDA ``index_add_``
    adds colliding rows with atomics in no fixed order): the stored
    contributions are sorted stably by row, so each row's come in feature
    order, and one ``segment_reduce`` adds each row's run from 0, one
    after the other: the bits of a sequential scatter-add, on the CPU and
    on the card. (Given as one column along axis 0, the card reduces
    each segment in a loop of one thread; a 1-D input takes a reduction
    tree per row, whose bits differ from the CPU's.) The memory is
    O(stored contributions) and the launches a handful, whatever the
    active set. Slots holding a zero are left out: an exact 0 added to a
    sum that starts at +0 changes no bit."""
    nz = torch.nonzero(beta).view(-1)
    vals = mat.values.reshape(-1, mat.nnz_max).index_select(0, nz).float()
    rows = mat.rows.reshape(-1, mat.nnz_max).index_select(0, nz)
    stored = vals != 0
    contrib = (vals * beta.float().index_select(0, nz)[:, None])[stored]
    rows, order = torch.sort(rows[stored].long(), stable=True)
    lengths = torch.bincount(rows, minlength=mat.m)
    out = torch.segment_reduce(contrib[order, None], "sum", lengths=lengths, axis=0)
    return out.view(-1).to(beta.dtype)


def sparse_transpose_matvec(mat: SparseBlockMatrix, r: torch.Tensor, *,
                            use_kernel: bool = True) -> torch.Tensor:
    """Xt @ r over all p features, O(total slots): the certification and
    grid pass (duality gap, lambda_grid), never the hot loop. K6's sweep
    (its znorm2 discarded) or, with ``use_kernel`` off, a plain sum that
    computes the products alone."""
    if use_kernel:
        return sparse_colstats(mat, r)[0]
    gathered = r.float().index_select(0, mat.rows.reshape(-1)).view(mat.rows.shape)
    return (mat.values.float() * gathered).sum(dim=2).reshape(-1)[:mat.p].to(mat.dtype)
