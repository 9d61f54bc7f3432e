"""Sampled-vertex dispatch (the reference's ``core/vertex.py``,
single-device part).

This module owns everything between "the oracle handed us an (m,)
co-gradient vector" and "here is the winning FW vertex": drawing the
sampling set S (paper §4.1/§4.5), scoring the sampled coordinates on the
selected backend ('torch' | 'kernels' | 'sparse'), and reducing to the
argmax. Every score is the linear form ``raw_i = -z_i^T w``; an oracle
may shift the selected scores per coordinate (the elastic-net's
``ScoreShift``, ``sel = raw + l2 * (scale * beta[idx])``), which the
kernels' backends apply inside K2's argmax launch. Also here:
the lasso step's tail after the argmax on the matrix's layout
(``step_tail``, with eq. 10), the fused chunk's routing
(``use_fused_kernel``), and the full matvecs behind warm starts and the
certified gap.

The reference draws S with ``jax.random`` from a key. The port draws it
from a *sampler* instead, so that parity with the reference never
depends on two random number generators agreeing: ``TorchSampler`` draws
with its own ``torch.Generator``, ``StreamSampler`` replays a stream
given to it (for instance the reference's, see ``repro_torch.convert``).
The batched engine's L delta lanes draw from a *lane sampler*:
``LaneSampler`` draws every lane's set in one call, ``LaneStreamSampler``
replays one stream a lane. ``sample_vertex_lanes`` and ``step_tail_lanes``
are the lane-axis counterparts of ``sample_vertex`` and ``step_tail``:
one launch of each kernel for all the lanes on the kernels' backends, the
one-lane plain ops once per lane elsewhere.

The reference zero-pads Xt's tail rows once per solve for its block
kernels (``pad_backend_matrix``). The port never copies Xt: the
'kernels' backend's score kernel scores a row index past p as 0 without
reading it, and the 'torch' backend wraps the tail block modulo p, as the
reference's 'xla' backend does. The 'sparse' backend runs on a
``SparseBlockMatrix`` (block-ELL, padded at construction): its scores go
through K5 (``kernels/sparse_grad``), at width 1 for 'uniform' sampling.

The fourth backend, 'distributed', routes every primitive to
``repro_torch.distributed.backend`` (a lazy import: that package sits above
the core): the engine's step then runs on a rank's tile of a mesh, inside
``repro_torch.distributed``'s drivers only. Oracles reduce over the sample
axis only through ``mdot``, ``msum`` and ``mrowdot`` here, which complete
the sum over the mesh's "data" axis exactly when the samples are split.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from repro_torch.core.solver_config import FWConfig
from repro_torch.kernels import fused_step, fw_grad
from repro_torch.kernels import step_tail as _step_tail
from repro_torch.kernels.residual_update import residual_update as _residual_update_kernel
from repro_torch.kernels.fw_grad import ScoreShift  # noqa: F401 (the oracles' shift)
from repro_torch.sparse import ops as sparse_ops
from repro_torch.sparse.matrix import SparseBlockMatrix


class TorchSampler:
    """Draws each step's sampling set with its own ``torch.Generator`` on
    ``device``: 'uniform' draws kappa indices with replacement, 'block'
    draws block starts without replacement."""

    def __init__(self, seed: int, device="cuda"):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def position(self) -> torch.Tensor:
        """The generator's state (a host tensor): ``restore`` of it draws
        the same sets again (the guarded solve's chunk retry)."""
        return self.generator.get_state()

    def restore(self, pos: torch.Tensor) -> None:
        self.generator.set_state(pos)

    def uniform(self, kappa: int, p: int) -> torch.Tensor:
        return torch.randint(0, p, (kappa,), generator=self.generator, device=self.device)

    def uniform_chunk(self, n_steps: int, kappa: int, p: int) -> torch.Tensor:
        """``(n_steps, kappa)``: the next ``n_steps`` uniform draws, stacked,
        so a chunked solve sees the unfused solve's stream."""
        return torch.stack([self.uniform(kappa, p) for _ in range(n_steps)])

    def blocks(self, nb: int, nblocks: int) -> torch.Tensor:
        perm = torch.randperm(nblocks, generator=self.generator, device=self.device)
        return perm[:nb]

    def skip(self) -> None:
        """A step that draws no set (a lazy rule's cache hit) draws nothing
        here. The reference splits its key on every step, hit or miss; this
        generator's stream is the port's own, so it has no key to keep in
        step with."""


class StreamSampler:
    """Replays a given ``(n_steps, k)`` integer tensor: row t is step t's
    kappa indices ('uniform') or its block starts ('block'). Raises when
    the stream runs out or a row has the wrong width."""

    def __init__(self, draws: torch.Tensor):
        if draws.dim() != 2:
            raise ValueError(f"a stream is (n_steps, k), got shape {tuple(draws.shape)}")
        self.draws = draws.long()
        self.t = 0
        self._bound_checked: Optional[int] = None

    def position(self) -> int:
        """The stream's cursor: ``restore`` of it replays the same rows."""
        return self.t

    def restore(self, pos: int) -> None:
        self.t = int(pos)

    def _next(self, k: int, bound: int, n_steps: int = 1) -> torch.Tensor:
        if self.t + n_steps > self.draws.shape[0]:
            raise RuntimeError(
                f"the sampling stream ran out after {self.t} steps "
                f"({n_steps} more asked, {self.draws.shape[0]} in all)"
            )
        if self.draws.shape[1] != k:
            raise ValueError(f"stream rows hold {self.draws.shape[1]} draws, the step needs {k}")
        if self._bound_checked != bound:  # once per stream, not per step
            if bool((self.draws < 0).any() | (self.draws >= bound).any()):
                raise ValueError(f"stream values must lie in [0, {bound})")
            self._bound_checked = bound
        rows = self.draws[self.t:self.t + n_steps]
        self.t += n_steps
        return rows

    def uniform(self, kappa: int, p: int) -> torch.Tensor:
        return self._next(kappa, p)[0]

    def uniform_chunk(self, n_steps: int, kappa: int, p: int) -> torch.Tensor:
        """The next ``n_steps`` rows in one slice."""
        return self._next(kappa, p, n_steps)

    def blocks(self, nb: int, nblocks: int) -> torch.Tensor:
        return self._next(nb, nblocks)[0]

    def skip(self) -> None:
        """Pass over the next row unused: a step that draws no set (a lazy
        rule's cache hit) still takes its row, as the reference splits its
        key on every step, hit or miss."""
        if self.t >= self.draws.shape[0]:
            raise RuntimeError(f"the sampling stream ran out after {self.t} steps")
        self.t += 1


class LaneSampler:
    """Draws the sampling sets of ``lanes`` delta lanes with one
    ``torch.Generator`` on ``device``: each step's ``(L, kappa)`` uniform
    indices in one ``torch.randint``, a frozen lane's row drawn and
    discarded; 'block' draws a lane's block starts at a time. A lane's
    stream is its own, not a ``TorchSampler``'s. (The reference's lanes
    split keys of their own, a frozen lane's key standing still; a
    ``LaneStreamSampler`` replays such streams.)"""

    def __init__(self, seed: int, lanes: int, device="cuda"):
        self.lanes = int(lanes)
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def position(self) -> torch.Tensor:
        return self.generator.get_state()

    def restore(self, pos: torch.Tensor) -> None:
        self.generator.set_state(pos)

    def uniform_lanes(self, kappa: int, p: int, active) -> torch.Tensor:
        return torch.randint(0, p, (self.lanes, kappa), generator=self.generator,
                             device=self.device)

    def blocks_lanes(self, nb: int, nblocks: int, active) -> torch.Tensor:
        return torch.stack([
            torch.randperm(nblocks, generator=self.generator, device=self.device)[:nb]
            for _ in range(self.lanes)
        ])

    def skip(self, lanes) -> None:
        """The lanes in ``lanes`` (host bools) draw no set this step (lazy
        cache hits): nothing to do, a draw being every lane's at once (the
        hits' rows discarded) and this stream the port's own."""


class LaneStreamSampler:
    """Replays one ``(n_steps, k)`` stream a lane (a ``StreamSampler``
    each): an active lane takes its stream's next row, a frozen lane's
    cursor stays and its row is a placeholder of zeros. So lane l sees
    exactly the rows a sequential solve replaying its stream sees."""

    def __init__(self, draws):
        self.lanes = [StreamSampler(d) for d in draws]
        if not self.lanes:
            raise ValueError("a lane stream sampler needs one stream a lane")

    def position(self) -> list:
        return [s.position() for s in self.lanes]

    def restore(self, pos) -> None:
        for s, t in zip(self.lanes, pos):
            s.restore(t)

    def _rows(self, take, k: int, active) -> torch.Tensor:
        if len(active) != len(self.lanes):
            raise ValueError(f"{len(active)} lanes asked, {len(self.lanes)} streams")
        dev = self.lanes[0].draws.device
        rows = [take(s) if a else torch.zeros(k, dtype=torch.int64, device=dev)
                for s, a in zip(self.lanes, active)]
        return torch.stack(rows)

    def uniform_lanes(self, kappa: int, p: int, active) -> torch.Tensor:
        return self._rows(lambda s: s.uniform(kappa, p), kappa, active)

    def blocks_lanes(self, nb: int, nblocks: int, active) -> torch.Tensor:
        return self._rows(lambda s: s.blocks(nb, nblocks), nb, active)

    def skip(self, lanes) -> None:
        """Pass each lane in ``lanes`` (host bools) over its next row unused
        (a lazy cache hit in that lane), as ``StreamSampler.skip``: the
        other lanes' cursors stay."""
        if len(lanes) != len(self.lanes):
            raise ValueError(f"{len(lanes)} lanes asked, {len(self.lanes)} streams")
        for s, h in zip(self.lanes, lanes):
            if h:
                s.skip()


def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d device index, as a 0-d tensor, without a host sync."""
    return x.index_select(0, i.view(1)).view(())


def _dist():
    """``repro_torch.distributed.backend`` (a lazy import: it layers on the
    core)."""
    from repro_torch.distributed import backend

    return backend


def dist_spec(cfg: Optional[FWConfig]):
    """The active ``DistSpec``, or None outside the distributed backend (the
    reference's ``core/vertex.py:81-90``)."""
    if cfg is not None and cfg.backend == "distributed":
        if cfg.dist is None:
            raise ValueError("backend='distributed' needs cfg.dist (set by "
                             "repro_torch.distributed.dist_config from the operand's mesh)")
        return cfg.dist
    return None


def mdot(a: torch.Tensor, b: torch.Tensor, cfg: Optional[FWConfig] = None) -> torch.Tensor:
    """Sample-axis dot product, completed over the mesh's "data" axis when
    the distributed backend splits the samples (one all_reduce). Oracles
    reduce over the m axis only through this, ``msum`` and ``mrowdot``, so
    their recursions stay right on a rank's sample slice."""
    d = torch.dot(a, b)
    return _dist().complete_data(d, cfg) if _dist_split(cfg) else d


def msum(x: torch.Tensor, cfg: Optional[FWConfig] = None) -> torch.Tensor:
    """Sample-axis sum, the ``mdot`` analogue for elementwise losses."""
    s = torch.sum(x)
    return _dist().complete_data(s, cfg) if _dist_split(cfg) else s


def mdot_pair(a1, b1, a2, b2, cfg: Optional[FWConfig] = None):
    """``(mdot(a1, b1), mdot(a2, b2))`` with one all_reduce of the pair where
    the samples are split (the S/F refresh's two dots)."""
    d1, d2 = torch.dot(a1, b1), torch.dot(a2, b2)
    if not _dist_split(cfg):
        return d1, d2
    return tuple(_dist().complete_data(torch.stack([d1, d2]), cfg).unbind())


def mrowdot(a: torch.Tensor, b: torch.Tensor, cfg: Optional[FWConfig] = None) -> torch.Tensor:
    """Each row's sample-axis dot of two ``(A, m)`` stacks, ``(A,)``,
    completed over "data" as ``mdot``."""
    d = (a * b).sum(dim=1)
    return _dist().complete_data(d, cfg) if _dist_split(cfg) else d


def _dist_split(cfg: Optional[FWConfig]) -> bool:
    spec = dist_spec(cfg)
    return spec is not None and spec.n_data > 1


def use_sparse_kernel(cfg: FWConfig) -> bool:
    """'sparse' backend: the Hopper kernels K5-K7 unless ``cfg.sparse_kernel``
    is False (None, the default, and True mean the kernels, whose plain
    versions run when the tensors lie on the CPU, as 'kernels' does). False
    runs the plain PyTorch ops on any device, the counterpart of the
    reference's XLA-gather sparse path."""
    return cfg.sparse_kernel is not False


def check_matrix_backend(Xt, cfg: FWConfig) -> None:
    """The matrix layout and the backend must agree. 'distributed' runs only
    through ``repro_torch.distributed``'s drivers, on a rank's tile."""
    if cfg.backend == "distributed":
        raise ValueError(
            "backend='distributed' only runs inside repro_torch.distributed's drivers (solve / "
            "solve_batched / fw_path* on a ShardedOperand); the single-device entry points "
            "cannot place mesh shards"
        )
    is_sparse = isinstance(Xt, SparseBlockMatrix)
    if is_sparse and cfg.backend != "sparse":
        raise ValueError(
            f"Xt is a SparseBlockMatrix but cfg.backend={cfg.backend!r}; "
            "use FWConfig(backend='sparse')"
        )
    if cfg.backend == "sparse" and not is_sparse:
        raise ValueError(
            "cfg.backend='sparse' needs a repro_torch.sparse.SparseBlockMatrix "
            "design matrix (build one with SparseBlockMatrix.from_dense / from_coo "
            "or repro_torch.data.make_sparse_proxy)"
        )
    if not is_sparse and getattr(Xt, "ndim", None) != 2:
        raise ValueError("the 'torch' and 'kernels' backends need a dense feature-major Xt (p, m)")


# --------------------------------------------------------------------------
# Sampling-set draws (paper §4.1 / §4.5)
# --------------------------------------------------------------------------


def sample_blocks(sampler, nblocks: int, block_size: int, cfg: FWConfig) -> torch.Tensor:
    """kappa // block_size aligned blocks without replacement, clamped to
    the blocks that exist."""
    nb = min(max(cfg.kappa // block_size, 1), nblocks)
    return sampler.blocks(nb, nblocks)


def sample_block_starts(sampler, p: int, cfg: FWConfig) -> torch.Tensor:
    """Aligned block starts for 'block' sampling over a feature axis of size p."""
    return sample_blocks(sampler, -(-p // cfg.block_size), cfg.block_size, cfg)


def sample_sparse_blocks(sampler, mat: SparseBlockMatrix, cfg: FWConfig) -> torch.Tensor:
    """Aligned block ids for the sparse backend. The geometry comes from the
    matrix (cfg.block_size is a dense knob), and the tail block is padded at
    construction, so no modulo wrap."""
    return sample_blocks(sampler, mat.nblocks, mat.block_size, cfg)


def sample_indices(sampler, p: int, cfg: FWConfig, device) -> torch.Tensor:
    """Draw the sampling set S (paper §4.1 / §4.5).

    'uniform': kappa i.i.d. uniform draws (with replacement).
    'block':   kappa/block aligned blocks without replacement; the tail
               block wraps modulo p (as the reference's 'xla' backend).
    'full':    deterministic FW (S = {0..p-1}); no draw.
    """
    if cfg.sampling == "full":
        return torch.arange(p, device=device)
    if cfg.sampling == "uniform":
        return sampler.uniform(cfg.kappa, p)
    if cfg.sampling == "block":
        starts = sample_block_starts(sampler, p, cfg)
        return fw_grad.block_indices(starts, cfg.block_size) % p
    raise ValueError(f"unknown sampling mode {cfg.sampling!r}")


# --------------------------------------------------------------------------
# Backend-dispatched vertex selection
# --------------------------------------------------------------------------


def _torch_vertex(Xt, w, sampler, p, cfg, extra_fn):
    idx = sample_indices(sampler, p, cfg, Xt.device)
    raw = -(Xt.index_select(0, idx) @ w)  # (|S|,) linear scores
    if extra_fn is None:
        j = torch.argmax(torch.abs(raw))
        g = take(raw, j)
        return take(idx, j), g, g, idx.shape[0]
    sel = raw.float() + extra_fn(idx)
    j = torch.argmax(torch.abs(sel))
    return take(idx, j), take(raw, j), take(sel, j), idx.shape[0]


def _kernel_vertex(Xt, w, sampler, p, cfg, extra_fn):
    """The sampled vertex through K2. 'uniform' scores width-1 blocks (the
    same index stream as the 'torch' backend); 'block' and 'full' score
    block_size-wide aligned blocks, whose rows past p score 0 and are
    masked out of the argmax. A score shift runs in the argmax's launch."""
    if cfg.sampling == "uniform":
        blk = sampler.uniform(cfg.kappa, p)
        bs = 1
    elif cfg.sampling == "block":
        blk = sample_block_starts(sampler, p, cfg)
        bs = cfg.block_size
    elif cfg.sampling == "full":
        bs = cfg.block_size
        blk = torch.arange(-(-p // bs), device=Xt.device)
    else:
        raise ValueError(f"unknown sampling mode {cfg.sampling!r}")
    # dot-product accounting as the reference: 'full' scores every real
    # coordinate once; 'block' counts nb*bs, tail included
    n_scored = p if cfg.sampling == "full" else blk.shape[0] * bs
    if extra_fn is None:
        i_star, g_star = fw_grad.fw_vertex(Xt, w, blk, bs, p_valid=p)
        return i_star, g_star, g_star, n_scored
    scores = fw_grad.sampled_scores(Xt, w, blk, bs)
    return (*fw_grad.argmax_shifted(scores, blk, bs, p, extra_fn), n_scored)


def _sparse_vertex(mat: SparseBlockMatrix, w, sampler, cfg, extra_fn):
    """The sampled vertex over the block-ELL matrix. 'uniform' scores the
    kappa drawn features (K5 at width 1, the dense path's index stream);
    'block' and 'full' score whole aligned blocks (K5 at the matrix's block
    width). Dot counts as the reference: uniform kappa, block
    nb * mat.block_size, full mat.p."""
    use_kernel = use_sparse_kernel(cfg)
    if cfg.sampling == "uniform":
        idx = sampler.uniform(cfg.kappa, mat.p)
        i_star, g_raw, g_sel = sparse_ops.sparse_gather_vertex_general(
            mat, w, idx, extra_fn=extra_fn, use_kernel=use_kernel)
        return i_star, g_raw, g_sel, idx.shape[0]
    if cfg.sampling == "block":
        blk = sample_sparse_blocks(sampler, mat, cfg)
        n_scored = blk.shape[0] * mat.block_size
    elif cfg.sampling == "full":
        blk = torch.arange(mat.nblocks, device=mat.device)
        n_scored = mat.p
    else:
        raise ValueError(f"unknown sampling mode {cfg.sampling!r}")
    i_star, g_raw, g_sel = sparse_ops.sparse_fw_vertex_general(mat, w, blk, use_kernel=use_kernel,
                                                               extra_fn=extra_fn)
    return i_star, g_raw, g_sel, n_scored


def sample_vertex(Xt, w: torch.Tensor, sampler, p: int, cfg: FWConfig, extra_fn=None):
    """Draw S and return the winning vertex on the configured backend.

    Returns ``(i_star, g_raw, g_sel, n_scored)``: the selected coordinate,
    its linear score ``-z^T w`` and its selected score (shifted by
    ``extra_fn(idx)``, the oracle's ``score_extra``; without one, the same
    tensor) as 0-d device tensors, and how many length-m dot products were
    consumed, a host int.
    """
    if cfg.backend == "distributed":
        return _dist().dist_sample_vertex(Xt, w, sampler, p, cfg, extra_fn)
    if cfg.backend == "sparse":
        return _sparse_vertex(Xt, w, sampler, cfg, extra_fn)
    if cfg.backend == "kernels":
        return _kernel_vertex(Xt, w, sampler, p, cfg, extra_fn)
    return _torch_vertex(Xt, w, sampler, p, cfg, extra_fn)


def score_indices(Xt, w: torch.Tensor, idx: torch.Tensor, p: int, cfg: FWConfig, extra_fn=None):
    """Linear scores ``raw_i = -z_i^T w`` at caller-chosen coordinates
    ``idx`` (the reference's ``core/vertex.py:286-318``): the step rules'
    re-scoring of the away rules' active set and the lazy rule's winner
    cache, with no draw and no argmax. ``idx`` is clipped to [0, p-1]
    (-1 marks an empty slot; its score is row 0's, which the caller masks),
    then scored on the backend: a row gather and a product ('torch'), K2 at
    width 1 ('kernels'), K5 at width 1 ('sparse', the plain ops with its
    kernels off), the sparse scores cast to the design's dtype as the
    reference's. Returns ``(raw, sel)``, ``sel = raw + extra_fn(safe)`` (the
    same tensor without a shift)."""
    if cfg.backend == "distributed":
        return _dist().dist_score_indices(Xt, w, idx, p, cfg, extra_fn)
    safe = idx.clamp(0, p - 1)
    if cfg.backend == "sparse":
        raw = sparse_ops.sparse_gather_scores(Xt, w, safe,
                                              use_kernel=use_sparse_kernel(cfg)).to(Xt.dtype)
    elif cfg.backend == "kernels":
        raw = fw_grad.sampled_scores(Xt, w, safe, 1)
    else:
        raw = -(Xt.index_select(0, safe) @ w)
    sel = raw if extra_fn is None else raw.float() + extra_fn(safe)
    return raw, sel


def dir_tail(Xt, y, beta, scale, maxabs, stall, resid, s_quad, f_lin, buf, raw_b, i_f, sel_f,
             delta, refresh: bool, pairwise: bool, cfg: FWConfig, en=None):
    """The away and pairwise rules' step after the FW vertex and the
    buffer's linear scores, on the matrix's layout: ``kernels/step_tail``'s
    direction tail, one launch, where the backend runs the kernels
    (``use_kernels``); its plain version on 'torch' and the plain sparse
    ops. The lasso's, or with ``en`` (a ``DirEN``) the elastic-net's.
    Returns a ``DirTailOut``."""
    if cfg.backend == "distributed":
        return _dist().dist_dir_tail(Xt, y, beta, scale, maxabs, stall, resid, s_quad, f_lin,
                                     buf, raw_b, i_f, sel_f, delta, refresh, pairwise, cfg, en)
    mat = (Xt.values, Xt.rows) if isinstance(Xt, SparseBlockMatrix) else Xt
    args = (mat, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, buf, raw_b, i_f, sel_f,
            delta, refresh, pairwise, cfg)
    if not use_kernels(cfg):
        return _step_tail.dir_tail_plain(*args, en)
    if en is None:
        return _step_tail.dir_tail(*args)
    return _step_tail.dir_tail_en(*args, en)


# --------------------------------------------------------------------------
# Batched delta lanes (the reference's jax.vmap of the step)
# --------------------------------------------------------------------------


def _lane_ids(active) -> list:
    return [lane for lane, a in enumerate(active) if a]


def _lane_blocks(p: int, block_size: int, cfg: FWConfig) -> int:
    """'block' sampling's blocks a lane."""
    return min(max(cfg.kappa // block_size, 1), -(-p // block_size))


def _lane_draws(sampler, p: int, block_size: int, cfg: FWConfig, active, device):
    """Every lane's sampled ids, as ``sample_vertex`` draws one lane's:
    'uniform' ``(L, kappa)`` indices (width 1), 'block' ``(L, nb)`` ids of
    ``block_size``-wide blocks, 'full' every block's id, one ``(nblocks,)``
    shared by the lanes. Returns the ids and their width."""
    n_blocks = -(-p // block_size)
    if cfg.sampling == "uniform":
        return sampler.uniform_lanes(cfg.kappa, p, active), 1
    if cfg.sampling == "block":
        return sampler.blocks_lanes(_lane_blocks(p, block_size, cfg), n_blocks, active), block_size
    if cfg.sampling == "full":
        return torch.arange(n_blocks, device=device), block_size
    raise ValueError(f"unknown sampling mode {cfg.sampling!r}")


def _plain_vertex_lanes(vertex_fn, L: int, active, device, dtype, sel_dtype):
    """``(i_star (L,), g_raw (L,), g_sel (L,))`` from ``vertex_fn(lane)`` for
    each active lane; a frozen lane gets ``(-1, 0, 0)``, as the kernels give
    it."""
    i_star = torch.full((L,), -1, dtype=torch.int64, device=device)
    g_raw = torch.zeros(L, dtype=dtype, device=device)
    g_sel = torch.zeros(L, dtype=sel_dtype, device=device)
    for lane in _lane_ids(active):
        i_star[lane], g_raw[lane], g_sel[lane] = vertex_fn(lane)
    return i_star, g_raw, g_sel


def _lane_kernels(cfg: FWConfig) -> bool:
    """Whether the lanes' vertex takes the lane kernels (``*_lanes``; their
    plain versions on CPU tensors): 'kernels', and 'sparse' with its
    kernels."""
    return cfg.backend == "kernels" or (cfg.backend == "sparse" and use_sparse_kernel(cfg))


def lane_support(Xt, cfg: FWConfig, extra) -> Optional[torch.Tensor]:
    """The support bitmap (``fw_grad.pack_support``) of the lanes' score
    shift ``extra``'s beta where ``sample_vertex_lanes`` takes the card's
    lane kernels on their cluster route (``fw_grad.lane_route`` of the
    scores a lane), the one route that reads and updates it; None
    elsewhere (no shift, the CPU, the plain ops, the ticket route)."""
    if not isinstance(extra, ScoreShift) or extra.beta.device.type != "cuda":
        return None
    if not _lane_kernels(cfg):
        return None
    if isinstance(Xt, SparseBlockMatrix):
        p, bs = Xt.p, Xt.block_size
    else:
        p, bs = Xt.shape[0], cfg.block_size
    if cfg.sampling == "uniform":
        n = cfg.kappa
    elif cfg.sampling == "block":
        n = _lane_blocks(p, bs, cfg) * bs
    else:
        n = -(-p // bs) * bs
    return fw_grad.pack_support(extra.beta) if fw_grad.lane_route(n) == "cluster" else None


def sample_vertex_lanes(Xt, w: torch.Tensor, sampler, p: int, cfg: FWConfig, active,
                        lanes: torch.Tensor, extra=None):
    """Draw every lane's S and return each active lane's winning vertex:
    ``(i_star (L,), g_raw (L,), g_sel (L,), n_scored)``, a frozen lane's
    ``(-1, 0, 0)``; ``n_scored`` is an active lane's dot products (a host
    int). ``w`` is the lanes' co-gradients ``(L, m)``, ``active`` the host's
    list of which lanes step and ``lanes`` the same as an int32 device
    tensor of their ids; ``extra`` the lanes' score shift (a lane-stacked
    ``ScoreShift``, or None). On the kernels' backends it is one scores
    launch and one argmax launch for all the lanes (``*_lanes``); on
    'torch' and the plain sparse ops, the one-lane ops once per lane. Lane
    l's winner is ``sample_vertex``'s on the same draw, bit for bit."""
    if cfg.backend == "distributed":
        return _dist().dist_sample_vertex_lanes(Xt, w, sampler, p, cfg, active, lanes, extra)
    L = w.shape[0]
    if cfg.backend == "sparse":
        mat = Xt
        blk, width = _lane_draws(sampler, mat.p, mat.block_size, cfg, active, mat.device)
        n_scored = mat.p if cfg.sampling == "full" else blk.shape[-1] * width
        if _lane_kernels(cfg):
            scores = sparse_ops.sparse_scores_lanes(mat, w, blk, width, lanes)
            if extra is None:
                i_star, g = fw_grad.vertex_argmax_lanes(scores, blk, width, mat.p, lanes)
                g = g.to(mat.dtype)
                return i_star, g, g, n_scored
            i_star, g_raw, g_sel = fw_grad.vertex_argmax_shifted_lanes(scores, blk, width, mat.p,
                                                                       lanes, extra)
            return i_star, g_raw.to(mat.dtype), g_sel.to(mat.dtype), n_scored
        fn = (sparse_ops.sparse_gather_vertex_general if cfg.sampling == "uniform"
              else sparse_ops.sparse_fw_vertex_general)
        i_star, g_raw, g_sel = _plain_vertex_lanes(
            lambda lane: fn(mat, w[lane].clone(), fw_grad.lane_blk(blk, lane), use_kernel=False,
                            extra_fn=None if extra is None else extra.lane(lane)),
            L, active, mat.device, mat.dtype, mat.dtype)
        return i_star, g_raw, g_sel, n_scored
    blk, bs = _lane_draws(sampler, p, cfg.block_size, cfg, active, Xt.device)
    n_scored = p if cfg.sampling == "full" else blk.shape[-1] * bs
    if _lane_kernels(cfg):
        scores = fw_grad.sampled_scores_lanes(Xt, w, blk, bs, lanes)
        if extra is None:
            i_star, g = fw_grad.vertex_argmax_lanes(scores, blk, bs, p, lanes)
            return i_star, g, g, n_scored
        return (*fw_grad.vertex_argmax_shifted_lanes(scores, blk, bs, p, lanes, extra), n_scored)

    def torch_vertex(lane):
        b = fw_grad.lane_blk(blk, lane)
        if cfg.sampling == "full":
            idx = torch.arange(p, device=Xt.device)
        else:
            idx = b if bs == 1 else fw_grad.block_indices(b, bs) % p
        raw = -(Xt.index_select(0, idx) @ w[lane].clone())
        if extra is None:
            j = torch.argmax(torch.abs(raw))
            return take(idx, j), take(raw, j), take(raw, j)
        sel = raw.float() + extra.lane(lane)(idx)
        j = torch.argmax(torch.abs(sel))
        return take(idx, j), take(raw, j), take(sel, j)

    i_star, g_raw, g_sel = _plain_vertex_lanes(torch_vertex, L, active, Xt.device, Xt.dtype,
                                               Xt.dtype if extra is None else torch.float32)
    return i_star, g_raw, g_sel, n_scored


def score_indices_lanes(Xt, w: torch.Tensor, idx: torch.Tensor, p: int, cfg: FWConfig,
                        active, lanes: torch.Tensor, extra=None):
    """``score_indices`` for L lanes: each lane's linear scores at its own
    caller-chosen ids, ``idx (L, n)`` (the away rules' buffers, the lazy
    rule's caches), against its co-gradient ``w (L, m)``, for the lanes in
    ``active`` (``lanes`` the same as int32 device ids). On the kernels'
    backends one launch of the lane scores at width 1 (K2's, or K5's cast
    to the design's dtype as the one-lane call casts), each lane's row
    bitwise the one-lane launch's; on 'torch' and the plain sparse ops the
    one-lane ops once per active lane. ``extra`` is the lanes' score shift
    (a lane-stacked ``ScoreShift``, or None). A frozen lane's row is
    unused. Returns ``(raw (L, n), sel (L, n))``."""
    if cfg.backend == "distributed":
        return _dist().dist_score_indices_lanes(Xt, w, idx, p, cfg, lanes, extra)
    safe = idx.clamp(0, p - 1)
    if _lane_kernels(cfg):
        if cfg.backend == "sparse":
            raw = sparse_ops.sparse_scores_lanes(Xt, w, safe, 1, lanes).to(Xt.dtype)
        else:
            raw = fw_grad.sampled_scores_lanes(Xt, w, safe, 1, lanes)
    else:
        dtype = Xt.dtype
        raw = torch.zeros(safe.shape, dtype=dtype, device=w.device)
        for lane in _lane_ids(active):
            raw[lane] = score_indices(Xt, w[lane].clone(), safe[lane], p, cfg)[0]
    sel = raw if extra is None else raw.float() + extra.l2 * (
        extra.scale[:, None].float() * extra.beta.gather(1, safe).float())
    return raw, sel


def dir_tail_lanes(Xt, y, beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin, buf, raw_b,
                   i_f, sel_f, deltas, refresh, lanes: torch.Tensor, pairwise: bool,
                   cfg: FWConfig, en=None):
    """``dir_tail`` for L lanes (``beta (L, p)`` in place, ``resid (L, m)``,
    ``(L,)`` scalars, FW vertices, scores and deltas, the buffers and their
    scores ``(L, n)``, ``refresh`` one host bool a lane): one launch of
    ``kernels/step_tail``'s lane direction tail where the backend runs the
    kernels, its plain version (the one-lane plain tail once per lane)
    otherwise. Lanes not in ``lanes`` keep their state. Returns a
    ``DirTailOut`` of lane-stacked fields."""
    if cfg.backend == "distributed":
        return _dist().dist_dir_tail_lanes(Xt, y, beta, scale, maxabs, step_inf, stall, resid,
                                           s_quad, f_lin, buf, raw_b, i_f, sel_f, deltas,
                                           refresh, lanes, pairwise, cfg, en)
    mat = (Xt.values, Xt.rows) if isinstance(Xt, SparseBlockMatrix) else Xt
    args = (mat, beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin, y, buf, raw_b, i_f,
            sel_f, deltas, refresh, lanes, pairwise, cfg)
    if not use_kernels(cfg):
        return _step_tail.dir_tail_lanes_plain(*args, en)
    if en is None:
        return _step_tail.dir_tail_lanes(*args)
    return _step_tail.dir_tail_en_lanes(*args, en)


def step_tail_lanes(Xt, y, stats, beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin,
                    i_star, g, deltas, cfg: FWConfig, lanes: torch.Tensor, en=None, tel=None):
    """``step_tail`` for L lanes (``beta (L, p)`` in place, ``resid (L, m)``,
    ``(L,)`` scalars, winners, scores and deltas): one launch of
    ``kernels/step_tail``'s lane kernel where the backend runs the kernels,
    its plain version (the one-lane plain tail once per lane) otherwise.
    Lanes not in ``lanes`` keep their state. Returns ``(beta, scale,
    maxabs, step_inf, stall, resid, s_quad, f_lin)``, lane-stacked, and with
    ``en`` (the elastic-net's ``ENTail``) Q after them. ``tel`` (a lane
    ``kernels.step_tail.TailRecord``) adds each stepping lane's ring
    record."""
    if cfg.backend == "distributed":
        return _dist().dist_step_tail_lanes(Xt, y, stats, beta, scale, maxabs, step_inf, stall,
                                            resid, s_quad, f_lin, i_star, g, deltas, cfg, lanes,
                                            en, tel)
    mat = (Xt.values, Xt.rows) if isinstance(Xt, SparseBlockMatrix) else Xt
    args = (mat, beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin, y, stats.zty,
            stats.znorm2, i_star, g, deltas, lanes, cfg)
    if not use_kernels(cfg):
        return _step_tail.step_tail_lanes_plain(*args, en, tel)
    if en is None:
        return _step_tail.step_tail_lanes(*args, tel)
    return _step_tail.step_tail_en_lanes(*args, en, tel)


# --------------------------------------------------------------------------
# Fused K-step chunk dispatch (kernels/fused_step)
# --------------------------------------------------------------------------


# the step rules already warned about, once per process, as the reference's
_warned_unfused_rules: set = set()


def fused_supported(oracle, cfg: FWConfig) -> bool:
    """Whether ``run_loop`` advances K-step chunks: ``cfg.fuse_steps > 1``,
    'uniform' sampling (the K x kappa index stream can be drawn ahead of
    the chunk), an oracle with the ``fused_*`` protocol (the lasso and the
    elastic-net; the logistic bisection has none), a single-device backend
    and the classic step rule. Anything else runs the per-step loop
    (fuse_steps=1 semantics), as the reference does; a rule other than
    'classic' that would otherwise fuse says so in a warning, once per rule
    (the reference's ``core/vertex.py:355-398``)."""
    base = (
        cfg.fuse_steps > 1
        and cfg.sampling == "uniform"
        and getattr(oracle, "fused_kind", None) is not None
        and cfg.backend != "distributed"
    )
    if not base:
        return False
    if cfg.step_rule != "classic":
        if cfg.step_rule not in _warned_unfused_rules:
            _warned_unfused_rules.add(cfg.step_rule)
            warnings.warn(
                f"step_rule={cfg.step_rule!r} does not compose with the fused multi-step "
                f"chunk (fuse_steps={cfg.fuse_steps}); falling back to per-step execution "
                "(fuse_steps=1 semantics)",
                stacklevel=2,
            )
        return False
    return True


def use_kernels(cfg: FWConfig) -> bool:
    """Whether the backend runs the port's kernels: 'kernels', 'distributed'
    (on either layout), and 'sparse' with its kernels on ('torch' and the
    plain sparse ops run eager ops, as the reference's 'xla' path does)."""
    if cfg.backend in ("kernels", "distributed"):
        return True
    return cfg.backend == "sparse" and use_sparse_kernel(cfg)


def fused_kernel_fits(sparse: bool, m: int, dtype: torch.dtype, ledger: int = 0) -> bool:
    """Whether the fused chunk kernels take a design of ``m`` samples in
    ``dtype``: K4 (dense) and K7 (sparse) run in float32 only, and keep the
    residual (and dense y) in a block's shared memory, so m is at most
    ``M_MAX`` (dense) or ``M_MAX_SPARSE`` (sparse), with the elastic-net's
    ``ledger`` bytes beside it (``fused_step.chunk_fits``)."""
    return dtype == torch.float32 and fused_step.chunk_fits(sparse, m, ledger)


def use_fused_kernel(cfg: FWConfig, Xt, oracle=None) -> bool:
    """Chunk executor choice: the fused kernel drives the 'kernels' backend
    (K4) and the 'sparse' backend with its kernels on (K7), as the Pallas
    megakernel drives 'pallas' and the kernel-dispatched 'sparse'; 'torch'
    and the plain sparse ops chunk through K unfused engine steps. Two
    routes are chosen from the design (``fused_kernel_fits``): a bf16
    design, or a state past the kernels' shared memory (m past the caps,
    or with an elastic-net ``oracle`` its K-slot ledger beside the
    residual), chunks through K unfused steps on the same backend's kernels
    (ROADMAP.md Queue 2 lists K4/K7 in bf16 and with the residual in device
    memory as later work)."""
    ledger = 0
    if oracle is not None and oracle.fused_needs_alpha:
        ledger = fused_step.ledger_bytes(cfg.fuse_steps)
    return use_kernels(cfg) and fused_kernel_fits(
        isinstance(Xt, SparseBlockMatrix), Xt.shape[1], Xt.dtype, ledger)


def step_tail(Xt, y, stats, beta, scale, maxabs, stall, resid, s_quad, f_lin, i_star, g,
              delta, cfg: FWConfig, en=None, tel=None):
    """The step's tail after the argmax on the matrix's layout (the
    winner's row of a dense ``Xt``, or its ELL slots of a
    ``SparseBlockMatrix``): ``kernels/step_tail``, one launch, where the
    backend runs the kernels (``use_kernels``); its plain version, the same
    ops, on 'torch' and the plain sparse ops, as the reference's 'xla'
    path. The lasso's, or with ``en`` (an ``ENTail``) the elastic-net's.
    ``tel`` (a ``kernels.step_tail.TailRecord``) adds the step's ring
    record, inside the same launch on the kernels' backends."""
    if cfg.backend == "distributed":
        return _dist().dist_step_tail(Xt, y, stats, beta, scale, maxabs, stall, resid, s_quad,
                                      f_lin, i_star, g, delta, cfg, en, tel)
    mat = (Xt.values, Xt.rows) if isinstance(Xt, SparseBlockMatrix) else Xt
    args = (mat, beta, scale, maxabs, stall, resid, s_quad, f_lin, y, stats.zty, stats.znorm2,
            i_star, g, delta, cfg)
    if not use_kernels(cfg):
        return _step_tail.step_tail_plain(*args, en, tel)
    if en is None:
        return _step_tail.step_tail(*args, tel)
    return _step_tail.step_tail_en(*args, en, tel)


def run_fused_kernel(oracle, Xt, y, resid, scal, idx, zty_s, zn2_s, alpha_s, k0: int, delta,
                     cfg: FWConfig):
    """The fused chunk on the matrix's layout: K7 for a
    ``SparseBlockMatrix``, K4 for a dense ``Xt``; ``alpha_s`` the chunk-start
    alpha values at ``idx`` for an oracle that needs them (None else).
    Returns ``(i_star, lam, delta_t, no_progress, resid_out, (S, F, Q))``:
    the per-step records the engine replays into beta and the stopping
    state."""
    kw = dict(oracle=oracle, eps_den=cfg.eps_den, gap_rtol=cfg.gap_rtol,
              refresh_every=cfg.refresh_every, max_iters=cfg.max_iters)
    if alpha_s is not None:
        kw["alpha_s"] = alpha_s
    if isinstance(Xt, SparseBlockMatrix):
        fn = fused_step.sparse_fused_chunk if alpha_s is None else fused_step.sparse_fused_chunk_en
        return fn(Xt.values, Xt.rows, y, resid, scal, idx, zty_s, zn2_s, k0, delta, **kw)
    fn = fused_step.dense_fused_chunk if alpha_s is None else fused_step.dense_fused_chunk_en
    return fn(Xt, y, resid, scal, idx, zty_s, zn2_s, k0, delta, **kw)


# --------------------------------------------------------------------------
# O(m) column recursion and full matvecs
# --------------------------------------------------------------------------


def columns_dense(Xt, i_stars: torch.Tensor, cfg: Optional[FWConfig] = None) -> torch.Tensor:
    """The dense columns ``z_i (A, m)`` of the features ``i_stars (A,)``: rows
    of a dense ``Xt``, or each feature's ELL slots scatter-added into zeros
    (``sparse_ops.sparse_column_dense``'s adds, row by row). Distributed: the
    rank's sample slice of each column (``owned_column_lanes``, one
    all_reduce over "model")."""
    if dist_spec(cfg) is not None:
        return _dist().dist_columns(Xt, i_stars, cfg)
    mat = (Xt.values, Xt.rows) if isinstance(Xt, SparseBlockMatrix) else Xt
    return _step_tail.dense_columns(mat, i_stars, Xt.shape[1])


def column_dense(Xt, i_star: torch.Tensor, cfg: Optional[FWConfig] = None) -> torch.Tensor:
    """The dense (m,) column z_i of feature ``i_star`` (a 0-d device index),
    either layout: the logistic oracle's line-search direction."""
    if dist_spec(cfg) is not None:
        return _dist().dist_column(Xt, i_star, cfg)
    return columns_dense(Xt, i_star.view(1)).view(-1)


def apply_column_update(Xt, v, y_vec, i_star, lam, delta_t, cfg: FWConfig) -> torch.Tensor:
    """v <- (1-lam) v + lam (y_vec - delta_t * z_star) on the backend (the
    reference's ``core/vertex.py:440-464``): eq. 10 with ``v = R, y_vec =
    y``; with ``v`` the margin, ``y_vec = 0`` and ``-delta_t`` the
    logistic's margin recursion. K3 (``kernels/residual_update``) on a dense
    ``Xt`` on the kernels' backend, the block-ELL sum
    (``sparse_residual_update``) on a ``SparseBlockMatrix``, the plain ops on
    'torch', and on 'distributed' the winner's column broadcast first. The
    engine's steps run this inside their tails; this is the reference's
    public name for it."""
    if dist_spec(cfg) is not None:
        return _dist().dist_column_update(Xt, v, y_vec, i_star, lam, delta_t, cfg)
    if isinstance(Xt, SparseBlockMatrix):
        col_vals, col_rows = sparse_ops.sparse_column(Xt, i_star)
        return sparse_ops.sparse_residual_update(v, y_vec, col_vals, col_rows, lam, delta_t)
    z_star = Xt.index_select(0, i_star.view(1)).view(-1)
    if cfg.backend == "kernels":
        return _residual_update_kernel(v, y_vec, z_star, lam, delta_t)
    return (1.0 - lam) * v + lam * (y_vec - delta_t * z_star)


def matvec(Xt, beta: torch.Tensor, cfg: Optional[FWConfig] = None) -> torch.Tensor:
    """X @ alpha for warm-start initialization, either matrix layout.
    Distributed: the rank's sample slice of X alpha (one all_reduce over
    "model")."""
    if dist_spec(cfg) is not None:
        return _dist().dist_matvec(Xt, beta, cfg)
    if isinstance(Xt, SparseBlockMatrix):
        return sparse_ops.sparse_matvec(Xt, beta)
    return beta @ Xt


def grad_full(Xt, w: torch.Tensor, cfg: Optional[FWConfig] = None) -> torch.Tensor:
    """Full linear gradient -X^T w over every feature: the O(nnz) / O(p*m)
    certification pass behind ``gap()``, never the hot loop. Distributed:
    replicated over the padded feature axis (callers slice [:p])."""
    if dist_spec(cfg) is not None:
        return _dist().dist_grad_full(Xt, w, cfg)
    if isinstance(Xt, SparseBlockMatrix):
        use = cfg is None or use_sparse_kernel(cfg)
        return -sparse_ops.sparse_transpose_matvec(Xt, w, use_kernel=use)
    return -(Xt @ w)
