"""The distributed backend's collectives (the reference's
``distributed/backend.py``): what ``core.vertex`` dispatches to when
``cfg.backend == 'distributed'``, each rank running the engine's step on
its tile with the vocabulary of ``distributed.shard``:

    matrix   feature blocks over "model", samples over "data" (a dense
             (p_local, m_local) tile, or a local SparseBlockMatrix whose ELL
             rows are LOCAL sample indices);
    w, v, y  the rank's (m_local,) sample slice, the same on the ranks of
             its data coordinate;
    beta,    REPLICATED length-p vectors (O(p) a rank);
    stats
    scalars  replicated: every rank computes the same line search from the
             same reduced inputs, through the same kernels, so every rank
             reaches the same stop decision.

Every collective is one ``all_reduce(SUM)`` of a buffer in which the
ranks' other contributions are exact zeros (the reference's psum design),
so one code path runs on NCCL and on gloo (which takes CUDA tensors for
``all_reduce`` and ``broadcast`` only). A step on a mesh (the lasso, the
classic rule): the owned scores on the rank's tile (K2's or K5's ``OWNED``
instantiation: +0.0 where the tile does not own the id), one all_reduce
over both axes of the ``(kappa,)`` scores, the single-device argmax kernel
on them at ``p_valid = p``, the winner's column on its owner
(``owned_column``, zeros elsewhere), one all_reduce over "model" of the
``(m_local,)`` column, and the step tail reading that column (the
``GIVEN`` instantiations of ``kernels/step_tail``). The oracles' sample-axis
dots complete over "data" through ``vertex.mdot``/``msum``/``mrowdot``
where the samples are split. On a mesh with one data slice every sum adds
exact zeros to the single-device value, so a uniform-sampling run there is
the single-device run bit for bit.

The reference's all_gather over "model" (``_gather_model``) is an
all_reduce of a zero-padded ``(n_model * p_local,)`` buffer in which each
rank writes its own slice.

The mesh's process groups are bound for each dispatch by the drivers
(``on_mesh``), as the reference's shard_map binds its axis names; the
config carries only the mesh's shape (``cfg.dist``). A collective over an
axis of one rank is skipped (an identity, as a psum over an axis of size
1 is), so a ``(1, 1)`` mesh calls no collective at all.

Collectives are counted on the active tracer as ``dist/collectives/<site>``.
The reference counts each site once per compiled program, at trace time;
the port has no trace, so it counts a site once a dispatch (the first time
the site runs inside ``on_mesh``), whether or not its axis has one rank.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.solver_config import FWConfig
from repro_torch.kernels import colstats as _colstats
from repro_torch.kernels import fw_grad, sparse_colstats, sparse_grad
from repro_torch.kernels import step_tail as _step_tail
from repro_torch.obs import trace as obs_trace
from repro_torch.sparse import ops as sparse_ops
from repro_torch.sparse.matrix import SparseBlockMatrix

_mesh = None  # the mesh of the dispatch under way (a distributed.shard.Mesh)
_sites: Optional[set] = None  # the sites counted in that dispatch


@contextlib.contextmanager
def on_mesh(mesh):
    """Bind ``mesh`` for the block (one dispatch): the distributed ops
    inside it reduce over its groups, and count each collective site once."""
    global _mesh, _sites
    prev = _mesh, _sites
    _mesh, _sites = mesh, set()
    try:
        yield
    finally:
        _mesh, _sites = prev


def _count(name: str) -> None:
    if _sites is not None:
        if name in _sites:
            return
        _sites.add(name)
    obs_trace.get_tracer().counter(f"dist/collectives/{name}", 1)


def current_mesh(cfg: FWConfig):
    """The mesh bound by ``on_mesh``, checked against ``cfg.dist``'s shape."""
    spec = cfg.dist if cfg is not None and cfg.backend == "distributed" else None
    if spec is None or _mesh is None:
        raise ValueError("the distributed backend's ops need cfg.backend='distributed' with "
                         "cfg.dist, inside distributed.backend.on_mesh (the drivers of "
                         "repro_torch.distributed bind the operand's mesh)")
    if (spec.n_data, spec.n_model) != (_mesh.n_data, _mesh.n_model):
        raise ValueError(f"cfg.dist is a ({spec.n_data}, {spec.n_model}) mesh, the bound mesh "
                         f"({_mesh.n_data}, {_mesh.n_model})")
    return _mesh


def all_reduce(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``t`` summed in place over the mesh's ``axis`` ("world", "data" or
    "model"; contiguous; a 0-d tensor as a 1-element view), ``t`` untouched
    where the axis has one rank."""
    group, size = mesh.axis(axis)
    if size == 1:
        return t
    flat = t.view(1) if t.dim() == 0 else t
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return t


def complete_data(t: torch.Tensor, cfg: FWConfig) -> torch.Tensor:
    """A partial sum over the rank's sample slice completed over "data" (one
    all_reduce where the samples are split, ``t`` itself otherwise)."""
    return all_reduce(t.contiguous(), current_mesh(cfg), "data")


def _tile(Xt_l):
    """``(mat, p_local, m_local, sparse)``: the kernels' matrix argument of
    a rank's tile."""
    if isinstance(Xt_l, SparseBlockMatrix):
        return (Xt_l.values, Xt_l.rows), Xt_l.p_padded, Xt_l.m, True
    return Xt_l, Xt_l.shape[0], Xt_l.shape[1], False


def feature_range(Xt_l, cfg: FWConfig):
    """``(off, p_local)`` of this rank's global feature range: the local
    count is padded (whole blocks, equal tiles), so global = off + local on
    every rank."""
    p_loc = _tile(Xt_l)[1]
    return current_mesh(cfg).coords[1] * p_loc, p_loc


# --------------------------------------------------------------------------
# Sampled-vertex selection
# --------------------------------------------------------------------------


def owned_scores(Xt_l, w_l, blk, width: int, off: int):
    """The owned partial scores of the sampled global ids ``blk`` at
    ``width`` (K2's or K5's ``OWNED`` instantiation; their plain versions on
    CPU tensors)."""
    if isinstance(Xt_l, SparseBlockMatrix):
        return sparse_grad.sparse_sampled_scores_owned(Xt_l.values, Xt_l.rows, w_l, blk, width,
                                                       off)
    return fw_grad.sampled_scores_owned(Xt_l, w_l, blk, width, off)


def _draw(Xt_l, sampler, p: int, cfg: FWConfig):
    """The step's sampled global ids, their width and the dots they cost, as
    the single-device kernels' backends draw them (the same stream): the
    sparse layout's block geometry is the matrix's, the dense one's
    ``cfg.block_size``."""
    from repro_torch.core import vertex  # lazy: core.vertex dispatches here

    bs = Xt_l.block_size if isinstance(Xt_l, SparseBlockMatrix) else cfg.block_size
    n_blocks = -(-p // bs)
    if cfg.sampling == "uniform":
        blk = sampler.uniform(cfg.kappa, p)
        return blk, 1, blk.shape[0]
    if cfg.sampling == "block":
        blk = vertex.sample_blocks(sampler, n_blocks, bs, cfg)
        return blk, bs, blk.shape[0] * bs
    if cfg.sampling == "full":
        dev = Xt_l.device
        return torch.arange(n_blocks, device=dev), bs, p
    raise ValueError(f"unknown sampling mode {cfg.sampling!r}")


def dist_sample_vertex(Xt_l, w_l, sampler, p: int, cfg: FWConfig, extra_fn=None):
    """The distributed ``vertex.sample_vertex``: the shared draw (every rank
    replays the same stream), the owned scores, ONE all_reduce over both
    axes that completes and replicates them, then the single-device argmax
    kernel (or its shifted instantiation) at ``p_valid = p``. Returns
    ``(i_star, g_raw, g_sel, n_scored)``, replicated."""
    off, _ = feature_range(Xt_l, cfg)
    blk, width, n_scored = _draw(Xt_l, sampler, p, cfg)
    scores = owned_scores(Xt_l, w_l, blk, width, off)
    _count("score_psum")
    all_reduce(scores, current_mesh(cfg), "world")
    sparse = isinstance(Xt_l, SparseBlockMatrix)
    if extra_fn is None:
        i_star, g = fw_grad.vertex_argmax(scores, blk, width, p)
        if sparse:
            g = g.to(Xt_l.dtype)
        return i_star, g, g, n_scored
    i_star, g_raw, g_sel = fw_grad.argmax_shifted(scores, blk, width, p, extra_fn)
    if sparse:
        g_raw, g_sel = g_raw.to(Xt_l.dtype), g_sel.to(Xt_l.dtype)
    return i_star, g_raw, g_sel, n_scored


def dist_score_indices(Xt_l, w_l, idx, p: int, cfg: FWConfig, extra_fn=None):
    """The distributed ``vertex.score_indices`` (the step rules' re-scoring
    of caller-chosen ids): the owned scores at width 1 and one all_reduce
    over both axes. Returns ``(raw, sel)``, replicated."""
    safe = idx.clamp(0, p - 1)
    off, _ = feature_range(Xt_l, cfg)
    raw = owned_scores(Xt_l, w_l, safe, 1, off)
    _count("rescore_psum")
    all_reduce(raw, current_mesh(cfg), "world")
    if isinstance(Xt_l, SparseBlockMatrix):
        raw = raw.to(Xt_l.dtype)
    sel = raw if extra_fn is None else raw.float() + extra_fn(safe)
    return raw, sel


def dist_score_indices_lanes(Xt_l, w_l, idx, p: int, cfg: FWConfig, lanes, extra=None):
    """The distributed ``vertex.score_indices_lanes``: the owned lane scores
    at width 1 of each lane's ids ``idx (L, n)`` (one launch for the lanes
    in ``lanes``) and one all_reduce over both axes. Returns ``(raw (L, n),
    sel (L, n))``, replicated."""
    safe = idx.clamp(0, p - 1)
    off, _ = feature_range(Xt_l, cfg)
    sparse = isinstance(Xt_l, SparseBlockMatrix)
    if sparse:
        raw = sparse_grad.sparse_sampled_scores_lanes_owned(Xt_l.values, Xt_l.rows, w_l, safe, 1,
                                                            lanes, off)
    else:
        raw = fw_grad.sampled_scores_lanes_owned(Xt_l, w_l, safe, 1, lanes, off)
    _count("rescore_psum")
    all_reduce(raw.as_strided((raw.shape[0], raw.stride(0)), (raw.stride(0), 1)),
               current_mesh(cfg), "world")
    if sparse:
        raw = raw.to(Xt_l.dtype)
    sel = raw if extra is None else raw.float() + extra.l2 * (
        extra.scale[:, None].float() * extra.beta.gather(1, safe).float())
    return raw, sel


def dist_sample_vertex_lanes(Xt_l, w_l, sampler, p: int, cfg: FWConfig, active, lanes,
                             extra=None):
    """The distributed ``vertex.sample_vertex_lanes``: one owned lane scores
    launch for the stepping lanes, one all_reduce over both axes of the
    ``(L, n)`` buffer, then the single-device lane argmax kernel (or its
    shifted instantiation, reading beta everywhere: no support bitmap).
    Returns ``(i_star (L,), g_raw (L,), g_sel (L,), n_scored)``."""
    from repro_torch.core import vertex  # lazy: core.vertex dispatches here

    sparse = isinstance(Xt_l, SparseBlockMatrix)
    bs = Xt_l.block_size if sparse else cfg.block_size
    blk, width = vertex._lane_draws(sampler, p, bs, cfg, active, Xt_l.device)
    n_scored = p if cfg.sampling == "full" else blk.shape[-1] * width
    off, _ = feature_range(Xt_l, cfg)
    if sparse:
        scores = sparse_grad.sparse_sampled_scores_lanes_owned(Xt_l.values, Xt_l.rows, w_l, blk,
                                                               width, lanes, off)
    else:
        scores = fw_grad.sampled_scores_lanes_owned(Xt_l, w_l, blk, width, lanes, off)
    _count("score_psum")
    # the whole (L, stride) buffer: a lane's row starts on 16 bytes
    all_reduce(scores.as_strided((scores.shape[0], scores.stride(0)), (scores.stride(0), 1)),
               current_mesh(cfg), "world")
    if extra is None:
        i_star, g = fw_grad.vertex_argmax_lanes(scores, blk, width, p, lanes)
        if sparse:
            g = g.to(Xt_l.dtype)
        return i_star, g, g, n_scored
    i_star, g_raw, g_sel = fw_grad.vertex_argmax_shifted_lanes(scores, blk, width, p, lanes,
                                                               extra)
    if sparse:
        g_raw, g_sel = g_raw.to(Xt_l.dtype), g_sel.to(Xt_l.dtype)
    return i_star, g_raw, g_sel, n_scored


# --------------------------------------------------------------------------
# The winner's column and the step tails with it given
# --------------------------------------------------------------------------


def dist_columns(Xt_l, ids: torch.Tensor, cfg: FWConfig) -> torch.Tensor:
    """The ``(A, m_local)`` columns of the global features ``ids`` on the
    rank's sample slice: ``owned_column_lanes`` (zeros where the tile does
    not own an id, -1 included) and one all_reduce over "model"."""
    mat, _, m_loc, _ = _tile(Xt_l)
    cols = _step_tail.owned_column_lanes(mat, ids.long(), feature_range(Xt_l, cfg)[0], m_loc)
    _count("column_broadcast")
    return all_reduce(cols, current_mesh(cfg), "model")


def dist_column(Xt_l, i_star: torch.Tensor, cfg: FWConfig) -> torch.Tensor:
    """The ``(m_local,)`` column of feature ``i_star`` (0-d):
    ``owned_column`` and one all_reduce over "model"."""
    mat, _, m_loc, _ = _tile(Xt_l)
    col = _step_tail.owned_column(mat, i_star, feature_range(Xt_l, cfg)[0], m_loc)
    _count("column_broadcast")
    return all_reduce(col, current_mesh(cfg), "model")


def dist_step_tail(Xt_l, y_l, stats, beta, scale, maxabs, stall, resid, s_quad, f_lin, i_star,
                   g, delta, cfg: FWConfig, en=None, tel=None):
    """The step's tail on the rank's sample slice: the winner's column
    (``dist_column``), then the tail kernel's ``GIVEN`` instantiation (the
    lasso's, or with ``en`` the elastic-net's). Returns ``vertex.step_tail``'s."""
    col = _step_tail.GivenCol(dist_column(Xt_l, i_star, cfg), isinstance(Xt_l, SparseBlockMatrix))
    args = (col, beta, scale, maxabs, stall, resid, s_quad, f_lin, y_l, stats.zty, stats.znorm2,
            i_star, g, delta, cfg)
    if en is None:
        return _step_tail.step_tail_given(*args, tel)
    return _step_tail.step_tail_en_given(*args, en, tel)


def dist_step_tail_lanes(Xt_l, y_l, stats, beta, scale, maxabs, step_inf, stall, resid, s_quad,
                         f_lin, i_star, g, deltas, cfg: FWConfig, lanes, en=None, tel=None):
    """``dist_step_tail`` for L lanes: the lanes' columns in one
    ``owned_column_lanes`` launch and one all_reduce (a frozen lane's
    winner -1 gives zeros), then the lane ``GIVEN`` tail."""
    col = _step_tail.GivenCol(dist_columns(Xt_l, i_star, cfg),
                              isinstance(Xt_l, SparseBlockMatrix))
    args = (col, beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin, y_l, stats.zty,
            stats.znorm2, i_star, g, deltas, lanes, cfg)
    if en is None:
        return _step_tail.step_tail_lanes_given(*args, tel)
    return _step_tail.step_tail_en_lanes_given(*args, en, tel)


def dist_dir_tail(Xt_l, y_l, beta, scale, maxabs, stall, resid, s_quad, f_lin, buf, raw_b, i_f,
                  sel_f, delta, refresh: bool, pairwise: bool, cfg: FWConfig, en=None):
    """The away and pairwise rules' tail on the rank's sample slice: the
    columns of ``i_f``, feature 0 and each buffer slot (the away vertex is
    chosen inside the launch) in one ``owned_column_lanes`` launch and one
    all_reduce, then the direction tail's ``GIVEN`` instantiation; with the
    samples split, its dots complete over "data" between its two launches."""
    p = beta.shape[0]
    zcols = dist_columns(Xt_l, _step_tail.dir_column_ids(i_f, buf, p), cfg)
    complete = (lambda t: complete_data(t, cfg)) if cfg.dist.n_data > 1 else None
    args = (zcols, beta, scale, maxabs, stall, resid, s_quad, f_lin, y_l, buf, raw_b, i_f, sel_f,
            delta, refresh, pairwise, cfg)
    if en is None:
        return _step_tail.dir_tail_given(*args, complete=complete)
    return _step_tail.dir_tail_en_given(*args, en, complete=complete)


def dist_dir_tail_lanes(Xt_l, y_l, beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin,
                        buf, raw_b, i_f, sel_f, deltas, refresh, lanes, pairwise: bool,
                        cfg: FWConfig, en=None):
    """``dist_dir_tail`` for L lanes: every lane's ``dir_column_ids`` columns
    (a frozen lane's -1 gives zeros) in one ``owned_column_lanes`` launch and
    one all_reduce, then the lane direction tail's ``GIVEN``
    instantiation; with the samples split, the lanes' dots complete over
    "data" between its two launches."""
    L, n = buf.shape
    p = beta.shape[1]
    ids = torch.cat([i_f[:, None], torch.zeros_like(i_f)[:, None], buf.clamp(0, p - 1)], dim=1)
    zcols = dist_columns(Xt_l, ids.reshape(-1), cfg).view(L, n + 2, -1)
    complete = (lambda t: complete_data(t, cfg)) if cfg.dist.n_data > 1 else None
    args = (zcols, beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin, y_l, buf, raw_b,
            i_f, sel_f, deltas, refresh, lanes, pairwise, cfg)
    if en is None:
        return _step_tail.dir_tail_lanes_given(*args, complete=complete)
    return _step_tail.dir_tail_en_lanes_given(*args, en, complete=complete)


def dist_column_update(Xt_l, v_l, y_l, i_star, lam, delta_t, cfg: FWConfig):
    """``vertex.apply_column_update`` on the rank's slice: v <- (1-lam) v +
    lam (y - delta_t z) with the winner's column broadcast (``dist_column``),
    in the single-device op order of the tile's layout (the dense K3
    kernel's, or the block-ELL sum ``kernels.step_tail.given_residual_update``
    replays)."""
    from repro_torch.kernels.residual_update import residual_update

    col = dist_column(Xt_l, i_star, cfg)
    if isinstance(Xt_l, SparseBlockMatrix):
        return _step_tail.given_residual_update(v_l, y_l, _step_tail.GivenCol(col, True), lam,
                                                delta_t)
    return residual_update(v_l, y_l, col, lam, delta_t)


# --------------------------------------------------------------------------
# Column statistics, matvec, full gradient (setup and certification)
# --------------------------------------------------------------------------


def _gather_model(parts: torch.Tensor, cfg: FWConfig) -> torch.Tensor:
    """The replicated ``(..., n_model * p_local)`` feature axis from each
    rank's ``(..., p_local)`` part: a zero buffer in which the rank writes
    its slice, summed over "model"."""
    mesh = current_mesh(cfg)
    mo = mesh.coords[1]
    p_loc = parts.shape[-1]
    buf = torch.zeros(parts.shape[:-1] + (mesh.n_model * p_loc,), dtype=parts.dtype,
                      device=parts.device)
    buf[..., mo * p_loc:(mo + 1) * p_loc] = parts
    return all_reduce(buf, mesh, "model")


def _tile_sums(Xt_l, v_l):
    """``(X_l^T v, ||z||^2)`` over the tile's local features, f32 (K1 on a
    dense tile, K6 on a block-ELL one)."""
    if isinstance(Xt_l, SparseBlockMatrix):
        return sparse_colstats.sparse_colstats(Xt_l.values, Xt_l.rows, v_l, Xt_l.p_padded)
    return _colstats.colstats(Xt_l, v_l)


def dist_colstats(Xt_l, y_l, cfg: FWConfig, p: int):
    """``(zty, znorm2, yty)`` replicated at the global p: K1/K6 on the tile
    (f32 sums), one all_reduce over "data" to complete the sample axis, one
    over "model" of the zero-padded feature axis, in the tile's dtype; y.y
    completed over "data"."""
    mesh = current_mesh(cfg)
    _count("colstats_gather")
    zty_l, zn2_l = _tile_sums(Xt_l, y_l)
    both = all_reduce(torch.stack([zty_l, zn2_l]), mesh, "data")
    full = _gather_model(both, cfg)
    dtype = Xt_l.dtype
    yty = all_reduce(torch.dot(y_l, y_l), mesh, "data")
    return full[0, :p].to(dtype), full[1, :p].to(dtype), yty


def _beta_slice(beta: torch.Tensor, off: int, p_loc: int) -> torch.Tensor:
    """This rank's slice of the replicated beta, zero-padded past p."""
    part = beta[off:off + p_loc]
    if part.shape[0] == p_loc:
        return part
    out = torch.zeros(p_loc, dtype=beta.dtype, device=beta.device)
    out[:part.shape[0]] = part
    return out


def dist_matvec(Xt_l, beta: torch.Tensor, cfg: FWConfig) -> torch.Tensor:
    """The rank's ``(m_local,)`` slice of X alpha from the replicated beta
    (warm starts): the tile's product with its beta slice and one
    all_reduce over "model"."""
    _count("matvec_psum")
    off, p_loc = feature_range(Xt_l, cfg)
    b_l = _beta_slice(beta, off, p_loc).to(Xt_l.dtype)
    if isinstance(Xt_l, SparseBlockMatrix):
        v_l = sparse_ops.sparse_matvec(Xt_l, b_l)
    else:
        v_l = b_l @ Xt_l
    return all_reduce(v_l.contiguous(), current_mesh(cfg), "model")


def dist_grad_full(Xt_l, w_l: torch.Tensor, cfg: FWConfig) -> torch.Tensor:
    """The replicated full linear gradient -X^T w over the padded feature
    axis (callers slice [:p]), the certification pass: the tile's product
    (K6's sweep on a block-ELL tile, in f32, cast after the sum as the
    single-device pass casts it), one all_reduce over "data", one over
    "model"."""
    mesh = current_mesh(cfg)
    _count("grad_gather")
    if isinstance(Xt_l, SparseBlockMatrix):
        g_l = _tile_sums(Xt_l, w_l)[0]
        g_l = -all_reduce(g_l, mesh, "data").to(Xt_l.dtype)
    else:
        g_l = -(Xt_l @ w_l)
        g_l = all_reduce(g_l.contiguous(), mesh, "data")
    return _gather_model(g_l, cfg)
