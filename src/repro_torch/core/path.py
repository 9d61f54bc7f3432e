"""The sequential regularization path (paper §5 protocol), the reference's
``core/path.py``: a log-spaced delta grid swept from sparse to dense, each
point warm-started from the previous solution rescaled so that its l1 norm
equals the next delta (the paper's heuristic).

Each grid point draws from its own sampler: by default a ``TorchSampler``
seeded from ``(seed, point index)``, so a point's stream does not depend on
how many steps the points before it took; ``sampler_fn(point_index)``
replaces it (the parity tests replay the reference's per-point streams).

``cd_path`` and ``fista_path`` are the baselines' paths (the reference's
``_penalized_path``): each point warm-started from the previous point's
solution as it is. Each point draws its own stream: by default a stochastic
CD's sweep orders and FISTA's power-iteration start from a
``torch.Generator`` seeded from ``(seed, point index)``;
``stream_fn(point_index)`` replaces them (the parity tests replay the
reference's per-point ``split``).

``fw_path_batched`` is the reference's lane driver: the grid in chunks of
``lane_width`` deltas, each chunk one ``engine.solve_batched`` (lanes
with early exit per lane), every lane warm-started from the previous
chunk's densest solution. The reference's ``batched_solver_cache_size``
and ``clear_batched_solver_cache`` count JAX compiles of the lane solver;
the port compiles nothing per call, so it has no counterpart of them.
"""
from __future__ import annotations

import functools
import time
from typing import List, NamedTuple

import numpy as np
import torch

from repro_torch.core import baselines, engine, fw_lasso
from repro_torch.core.solver_config import CDConfig, FISTAConfig, FWConfig
from repro_torch.core.vertex import LaneSampler, TorchSampler
from repro_torch.sparse import ops as sparse_ops
from repro_torch.sparse.matrix import SparseBlockMatrix


class PathPoint(NamedTuple):
    reg: float  # lam or delta
    objective: float  # the oracle's objective at this grid point
    l1: float
    active: int
    iterations: int
    n_dots: int
    seconds: float
    alpha_nnz_idx: np.ndarray
    alpha_nnz_val: np.ndarray
    # certified FW duality gap (FWConfig.report_gap); NaN off
    gap: float = float("nan")


class PathResult(NamedTuple):
    points: List[PathPoint]
    total_seconds: float
    total_dots: int
    total_iters: int
    # lane-iterations pruned by a batched driver (0 for the sequential one)
    saved_iters: int = 0

    @property
    def mean_active(self) -> float:
        return float(np.mean([pt.active for pt in self.points]))


def lambda_grid(Xt, y, n_points: int = 100, ratio: float = 100.0) -> np.ndarray:
    """Glmnet-style grid: lam_max = ||X^T y||_inf, descending log scale
    (``Xt`` dense feature-major or a ``SparseBlockMatrix``)."""
    if isinstance(Xt, SparseBlockMatrix):
        zty = sparse_ops.sparse_transpose_matvec(Xt, y)
    else:
        zty = Xt @ y
    lam_max = float(torch.max(torch.abs(zty)))
    return np.geomspace(lam_max, lam_max / ratio, n_points)


def delta_grid(delta_max: float, n_points: int = 100, ratio: float = 100.0) -> np.ndarray:
    """Constrained-form grid: delta_min -> delta_max, ascending log scale."""
    return np.geomspace(delta_max / ratio, delta_max, n_points)


def point_seed(seed: int, point_index: int) -> int:
    """The default sampler seed of one grid point."""
    return int(np.random.SeedSequence([seed, point_index]).generate_state(1)[0])


def fw_path(Xt, y, deltas, base_cfg: FWConfig, seed: int = 0, oracle=None, *,
            device="cuda", sampler_fn=None, on_step=None,
            checkpoint_dir=None, resume_from=None) -> PathResult:
    """Stochastic-FW path with the paper's l1-rescaling warm start, on a
    dense ``Xt (p, m)`` or a ``SparseBlockMatrix`` (``backend='sparse'``).

    ``on_step(point_index, state)``, when given, sees every engine state.
    Runs on the card unless ``device`` says otherwise.
    """
    if checkpoint_dir is not None or resume_from is not None:
        raise NotImplementedError(
            "path checkpoint/resume is not ported yet: ROADMAP.md Queue 1 item 12"
        )
    oracle = fw_lasso.LASSO if oracle is None else oracle
    Xt, y = engine.prepare_inputs(Xt, y, base_cfg, device)
    if sampler_fn is None:
        sampler_fn = lambda g: TorchSampler(point_seed(seed, g), Xt.device)  # noqa: E731
    alpha = None
    points = []
    t_total = time.perf_counter()
    for g, d in enumerate(deltas):
        if alpha is not None:
            l1 = float(torch.sum(torch.abs(alpha)))
            if l1 > 1e-12:
                alpha = alpha * (float(d) / l1)  # paper's rescaling heuristic
        hook = None if on_step is None else functools.partial(on_step, g)
        t0 = time.perf_counter()
        res = engine.solve_prepared(oracle, Xt, y, base_cfg, sampler_fn(g), alpha, float(d), hook)
        objective = float(res.objective)  # waits for the solve to finish
        dt = time.perf_counter() - t0
        alpha = res.alpha
        idx = torch.nonzero(alpha).view(-1)
        points.append(
            PathPoint(
                reg=float(d),
                objective=objective,
                l1=float(torch.sum(torch.abs(alpha))),
                active=int(res.active),
                iterations=res.iterations,
                n_dots=res.n_dots,
                seconds=dt,
                alpha_nnz_idx=idx.cpu().numpy(),
                alpha_nnz_val=alpha[idx].cpu().numpy(),
                gap=float("nan") if res.gap is None else float(res.gap),
            )
        )
    return PathResult(
        points,
        time.perf_counter() - t_total,
        sum(pt.n_dots for pt in points),
        sum(pt.iterations for pt in points),
    )


def fw_path_batched(Xt, y, deltas, base_cfg: FWConfig, seed: int = 0, lane_width=None,
                    oracle=None, *, device="cuda", lane_sampler_fn=None, solve_batched_fn=None,
                    checkpoint_dir=None, resume_from=None) -> PathResult:
    """Stochastic-FW path solved in parallel delta lanes (the reference's
    ``fw_path_batched``, ``src/repro/core/path.py:239-394``).

    The ascending grid is cut into chunks of ``lane_width`` deltas (default
    ``max(1, ceil(n / 8))``, about 8 batched solves); the ragged last chunk
    is padded by repeating the last delta. Each lane starts from the
    previous chunk's densest solution (its last lane's, a padded one
    included) scaled so its l1 norm equals the lane's delta; the first
    chunk starts from zero. Lanes that converge early freeze; the
    lane-iterations the real lanes were spared are ``saved_iters``, and a
    point's ``seconds`` is its chunk's over the chunk's real lanes.

    ``lane_sampler_fn(chunk_index)`` gives a chunk's lane sampler (default:
    a ``LaneSampler`` seeded from ``(seed, chunk_index)``; the parity tests
    replay the reference's lane streams); ``solve_batched_fn`` replaces
    ``engine.solve_batched_prepared`` (same arguments). Runs on the card
    unless ``device`` says otherwise.
    """
    if checkpoint_dir is not None or resume_from is not None:
        raise NotImplementedError(
            "path checkpoint/resume is not ported yet: ROADMAP.md Queue 1 item 12"
        )
    oracle = fw_lasso.LASSO if oracle is None else oracle
    Xt, y = engine.prepare_inputs(Xt, y, base_cfg, device)
    if solve_batched_fn is None:
        solve_batched_fn = engine.solve_batched_prepared
    deltas = np.asarray(deltas, dtype=np.float64)
    n = len(deltas)
    if lane_width is None:
        lane_width = max(1, -(-n // 8))  # about 8 batched solves
    n_chunks = -(-n // lane_width)
    padded = np.concatenate([deltas, np.repeat(deltas[-1:], n_chunks * lane_width - n)])
    if lane_sampler_fn is None:
        lane_sampler_fn = lambda c: LaneSampler(point_seed(seed, c), lane_width,  # noqa: E731
                                                Xt.device)
    carry = torch.zeros(Xt.shape[0], dtype=Xt.dtype, device=Xt.device)  # densest so far
    points: List[PathPoint] = []
    total_saved = 0
    t_total = time.perf_counter()
    for c in range(n_chunks):
        chunk = padded[c * lane_width:(c + 1) * lane_width]
        d_arr = torch.tensor(chunk, dtype=Xt.dtype, device=Xt.device)
        l1 = torch.sum(torch.abs(carry))
        # the paper's rescaling warm start, per lane; carry == 0 stays 0
        alpha0s = carry[None, :] * (d_arr / torch.clamp_min(l1, 1e-12))[:, None]
        t0 = time.perf_counter()
        res, _ = solve_batched_fn(oracle, Xt, y, base_cfg, lane_sampler_fn(c), alpha0s, d_arr)
        objective = res.objective.tolist()  # waits for the chunk to finish
        dt = time.perf_counter() - t0
        carry = res.alpha[-1]
        real = min(lane_width, n - c * lane_width)
        iters = np.asarray(res.iterations)
        # the pruning win of the real lanes only (the engine's own count also
        # holds the padded lanes)
        total_saved += int(np.sum(iters.max() - iters[:real]))
        l1s = torch.sum(torch.abs(res.alpha), dim=1).tolist()
        active = res.active.tolist()
        gaps = None if res.gap is None else res.gap.tolist()
        for i in range(real):
            alpha = res.alpha[i]
            idx = torch.nonzero(alpha).view(-1)
            points.append(
                PathPoint(
                    reg=float(chunk[i]),
                    objective=objective[i],
                    l1=l1s[i],
                    active=int(active[i]),
                    iterations=res.iterations[i],
                    n_dots=res.n_dots[i],
                    seconds=dt / real,
                    alpha_nnz_idx=idx.cpu().numpy(),
                    alpha_nnz_val=alpha[idx].cpu().numpy(),
                    gap=float("nan") if gaps is None else gaps[i],
                )
            )
    return PathResult(
        points,
        time.perf_counter() - t_total,
        sum(pt.n_dots for pt in points),
        sum(pt.iterations for pt in points),
        saved_iters=total_saved,
    )


def _penalized_path(solve, Xt, y, regs, stream_fn) -> PathResult:
    """Solve ``solve(Xt, y, reg, stream, alpha0)`` at each of ``regs`` in
    turn, each warm-started from the previous solution, ``stream_fn(g)``
    the point's stream."""
    alpha = None
    points = []
    t_total = time.perf_counter()
    for g, reg in enumerate(regs):
        t0 = time.perf_counter()
        res = solve(Xt, y, float(reg), stream_fn(g), alpha)
        objective = float(res.objective)  # waits for the solve to finish
        dt = time.perf_counter() - t0
        alpha = res.alpha
        idx = torch.nonzero(alpha).view(-1)
        points.append(
            PathPoint(
                reg=float(reg),
                objective=objective,
                l1=float(torch.sum(torch.abs(alpha))),
                active=res.active,
                iterations=res.iterations,
                n_dots=res.n_dots,
                seconds=dt,
                alpha_nnz_idx=idx.cpu().numpy(),
                alpha_nnz_val=alpha[idx].cpu().numpy(),
            )
        )
    return PathResult(
        points,
        time.perf_counter() - t_total,
        sum(pt.n_dots for pt in points),
        sum(pt.iterations for pt in points),
    )


def cd_path(Xt, y, lams, base_cfg: CDConfig, seed: int = 0, *, device=None,
            stream_fn=None) -> PathResult:
    """Coordinate descent along a descending ``lams`` grid (``lambda_grid``).
    ``stream_fn(g)``: point g's sweep orders (``cd_solve``'s ``order``;
    None for a cyclic config). Runs on Xt's device (the card for numpy
    inputs) unless ``device`` says otherwise."""
    Xt, y = baselines.prepare_dense(Xt, y, device)
    if stream_fn is None:
        p = Xt.shape[0]
        stream_fn = lambda g: (baselines.RandomOrder(p, point_seed(seed, g), Xt.device)  # noqa: E731
                               if base_cfg.stochastic else None)

    def solve(Xt, y, lam, order, alpha0):
        return baselines.cd_solve(Xt, y, base_cfg, order, alpha0, lam=lam)

    return _penalized_path(solve, Xt, y, lams, stream_fn)


def fista_path(Xt, y, regs, base_cfg: FISTAConfig, seed: int = 0, *, device=None,
               stream_fn=None) -> PathResult:
    """FISTA along ``regs``: a descending lam grid (penalized) or an
    ascending delta grid (``cfg.constrained``). ``stream_fn(g)``: point g's
    power-iteration start ``v0``. Runs on Xt's device (the card for numpy
    inputs) unless ``device`` says otherwise."""
    Xt, y = baselines.prepare_dense(Xt, y, device)
    if stream_fn is None:
        p = Xt.shape[0]
        stream_fn = lambda g: baselines.random_start(p, point_seed(seed, g), Xt.device)  # noqa: E731

    def solve(Xt, y, reg, v0, alpha0):
        return baselines.fista_solve(Xt, y, base_cfg, v0, alpha0, reg=reg)

    # constrained sweeps ascending (sparse -> dense), penalized descending.
    return _penalized_path(solve, Xt, y, regs, stream_fn)
