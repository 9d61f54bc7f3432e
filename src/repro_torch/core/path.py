"""The sequential regularization path (paper §5 protocol), the reference's
``core/path.py``: a log-spaced delta grid swept from sparse to dense, each
point warm-started from the previous solution rescaled so that its l1 norm
equals the next delta (the paper's heuristic).

Each grid point draws from its own sampler: by default a ``TorchSampler``
seeded from ``(seed, point index)``, so a point's stream does not depend on
how many steps the points before it took; ``sampler_fn(point_index)``
replaces it (the parity tests replay the reference's per-point streams).

Both FW drivers take the reference's ``checkpoint_dir`` /
``checkpoint_every`` / ``resume_from`` (``resilience.checkpoint``): a
killed path resumes at its last snapshot and ends bit for bit as the
uninterrupted one, since each point's (each lane chunk's) stream is a pure
function of its index; ``fw_path`` also takes the reference's ``solve_fn``
(the guarded solve's ``resilience.guards.resilient_solve_fn``).

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

Both FW drivers are observed as the reference's are
(``src/repro/core/path.py:105-130, 172-200, 295-360``): a ``fw_path`` /
``fw_path_batched`` span on the active tracer around the run, a span a
grid point or lane chunk that closes after the point's results are read
back from the card, an EWMA ``StepMonitor`` flagging a straggler point
(an instant event) or a ``LaneProgressMonitor`` keeping the lanes'
story, and with a metrics registry installed the point and chunk latency
histograms, the lane counters, each solve's families (the engine's
``_MetricsEntry``) and at the end the tracer's spans and counters
(``tracer_to_registry``).
"""
from __future__ import annotations

import functools
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import baselines, engine, fw_lasso
from repro_torch.core.solver_config import CDConfig, FISTAConfig, FWConfig
from repro_torch.core.vertex import LaneSampler, TorchSampler
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import monitor as obs_monitor
from repro_torch.obs import trace as obs_trace
from repro_torch.resilience import checkpoint as path_ckpt
from repro_torch.resilience import faults
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


def _observe_point(reg, driver: str, cfg: FWConfig, seconds: float) -> None:
    """Per-grid-point latency into the metrics plane (no-op when the
    registry is None, the metrics-off default)."""
    if reg is None:
        return
    reg.histogram(
        "fw_path_point_seconds",
        "wall time per regularization-path grid point (batched lanes "
        "amortize their chunk dispatch)",
        ("driver", "backend"),
    ).observe(seconds, driver=driver, backend=cfg.backend)


def _finish_path(reg, tracer) -> None:
    """End-of-path bridge: fold the tracer's spans and counters gathered
    during this path into the registry."""
    if reg is not None:
        obs_metrics.tracer_to_registry(tracer, reg)


def point_seed(seed: int, point_index: int) -> int:
    """The default sampler seed of one grid point."""
    return int(np.random.SeedSequence([seed, point_index]).generate_state(1)[0])


def _nnz(alpha: torch.Tensor):
    """A point's support and values on the host. numpy has no bfloat16, so
    a bf16 iterate's values are widened to float32 (exactly)."""
    idx = torch.nonzero(alpha).view(-1)
    val = alpha[idx]
    if val.dtype == torch.bfloat16:
        val = val.float()
    return idx.cpu().numpy(), val.cpu().numpy()


def fw_path(Xt, y, deltas, base_cfg: FWConfig, seed: int = 0, oracle=None, *,
            device="cuda", sampler_fn=None, on_step=None, solve_fn=None,
            checkpoint_dir=None, checkpoint_every: int = 1, resume_from=None,
            placed: bool = False) -> PathResult:
    """Stochastic-FW path with the paper's l1-rescaling warm start, on a
    dense ``Xt (p, m)`` or a ``SparseBlockMatrix`` (``backend='sparse'``).

    ``on_step(point_index, state)``, when given, sees every engine state.
    ``solve_fn(oracle, Xt, y, cfg, sampler, alpha0, delta) -> SolveResult``
    replaces the engine's solve (``resilience.guards.resilient_solve_fn``
    runs every point under the watchdog); it takes no ``on_step``.

    Checkpoint/resume (the reference's ``src/repro/core/path.py:166-226``):
    with ``checkpoint_dir`` set, the loop state (completed points, the
    sampler seed, the warm start) snapshots atomically every
    ``checkpoint_every`` grid points and after the last;
    ``resume_from=<dir>`` restores the newest valid snapshot and runs only
    the remaining points, bit for bit the uninterrupted run (a point's
    stream is ``sampler_fn(g)``'s, a pure function of its index, and its
    warm start a pure function of the carried alpha; the path's seed comes
    from the snapshot). ``total_dots`` and ``total_iters`` count the
    restored points too. Runs on the card unless ``device`` says otherwise.
    ``placed=True``: the caller placed and checked ``Xt`` and ``y`` itself
    (the distributed driver, passing a rank's tile with its own
    ``solve_fn``), and ``device`` is not read.
    """
    if solve_fn is not None and on_step is not None:
        raise ValueError("on_step goes to the engine's solve; a solve_fn takes none")
    oracle = fw_lasso.LASSO if oracle is None else oracle
    if not placed:
        Xt, y = engine.prepare_inputs(Xt, y, base_cfg, device)
    alpha = None
    points = []
    start = 0
    if resume_from is not None:
        loaded = path_ckpt.load_path_checkpoint(resume_from)
        if loaded is not None:
            start, seed, carry, points, _ = loaded
            alpha = carry.to(device=Xt.device, dtype=Xt.dtype)
    if sampler_fn is None:
        sampler_fn = lambda g: TorchSampler(point_seed(seed, g), Xt.device)  # noqa: E731
    tracer = obs_trace.get_tracer()
    reg = obs_metrics.get_registry()
    mon = obs_monitor.StepMonitor()
    t_total = time.perf_counter()
    n = len(deltas)
    with tracer.span("fw_path", cat="path", n_points=n, backend=base_cfg.backend,
                     rule=base_cfg.step_rule):
        for g in range(start, n):
            d = deltas[g]
            faults.check_kill("path_point", g)
            if alpha is not None:
                l1 = float(torch.sum(torch.abs(alpha)))
                if l1 > 1e-12:
                    alpha = alpha * (float(d) / l1)  # paper's rescaling heuristic
            mon.begin()
            t0 = time.perf_counter()
            with tracer.span("fw_path/point", cat="path", delta=float(d)):
                if solve_fn is None:
                    hook = None if on_step is None else functools.partial(on_step, g)
                    res = engine.solve_prepared(oracle, Xt, y, base_cfg, sampler_fn(g), alpha,
                                                float(d), hook)
                else:
                    res = solve_fn(oracle, Xt, y, base_cfg, sampler_fn(g), alpha, float(d))
                objective = float(res.objective)  # waits for the solve to finish
            dt = time.perf_counter() - t0
            # EWMA straggler detection (the first point seeds the average)
            if mon.end() and mon.step > 1:
                tracer.instant("fw_path/straggler_point", cat="path", point=mon.step,
                               seconds=dt)
            _observe_point(reg, "sequential", base_cfg, dt)
            alpha = res.alpha
            idx, val = _nnz(alpha)
            points.append(
                PathPoint(
                    reg=float(d),
                    objective=objective,
                    l1=float(torch.sum(torch.abs(alpha))),
                    active=int(res.active),
                    iterations=res.iterations,
                    n_dots=res.n_dots,
                    seconds=dt,
                    alpha_nnz_idx=idx,
                    alpha_nnz_val=val,
                    gap=float("nan") if res.gap is None else float(res.gap),
                )
            )
            if checkpoint_dir is not None and ((g + 1) % checkpoint_every == 0 or g == n - 1):
                path_ckpt.save_path_checkpoint(checkpoint_dir, g + 1, seed, alpha, points)
    _finish_path(reg, tracer)
    return PathResult(
        points,
        time.perf_counter() - t_total,
        sum(pt.n_dots for pt in points),
        sum(pt.iterations for pt in points),
    )


def fw_path_batched(Xt, y, deltas, base_cfg: FWConfig, seed: int = 0, lane_width=None,
                    oracle=None, *, device="cuda", lane_sampler_fn=None, solve_batched_fn=None,
                    checkpoint_dir=None, checkpoint_every: int = 1,
                    resume_from=None, placed: bool = False,
                    p: Optional[int] = None) -> PathResult:
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
    ``engine.solve_batched_prepared`` (same arguments).

    Checkpoint/resume works at lane-chunk granularity: ``checkpoint_every``
    counts chunks here, and ``resume_from=`` runs only the remaining chunks,
    bit for bit (a chunk's lanes draw from ``lane_sampler_fn(c)``, a pure
    function of the chunk's index, and start from the carried densest
    solution); ``saved_iters`` and the totals count the restored chunks
    too. Runs on the card unless ``device`` says otherwise. ``placed`` as
    ``fw_path``'s; ``p`` the global feature count where ``Xt`` is a rank's
    tile (default ``Xt.shape[0]``).
    """
    oracle = fw_lasso.LASSO if oracle is None else oracle
    if not placed:
        Xt, y = engine.prepare_inputs(Xt, y, base_cfg, device)
    p = Xt.shape[0] if p is None else p
    if solve_batched_fn is None:
        solve_batched_fn = engine.solve_batched_prepared
    deltas = np.asarray(deltas, dtype=np.float64)
    n = len(deltas)
    if lane_width is None:
        lane_width = max(1, -(-n // 8))  # about 8 batched solves
    n_chunks = -(-n // lane_width)
    padded = np.concatenate([deltas, np.repeat(deltas[-1:], n_chunks * lane_width - n)])
    carry = torch.zeros(p, dtype=Xt.dtype, device=Xt.device)  # densest so far
    points: List[PathPoint] = []
    start_chunk = 0
    total_saved = 0
    if resume_from is not None:
        loaded = path_ckpt.load_path_checkpoint(resume_from)
        if loaded is not None:
            start_chunk, seed, carry, points, total_saved = loaded
            carry = carry.to(device=Xt.device, dtype=Xt.dtype)
    if lane_sampler_fn is None:
        lane_sampler_fn = lambda c: LaneSampler(point_seed(seed, c), lane_width,  # noqa: E731
                                                Xt.device)
    tracer = obs_trace.get_tracer()
    reg = obs_metrics.get_registry()
    lanes_mon = obs_monitor.LaneProgressMonitor(max_iters=base_cfg.max_iters)
    t_total = time.perf_counter()
    with tracer.span("fw_path_batched", cat="path", n_points=n, lane_width=lane_width,
                     n_chunks=n_chunks, backend=base_cfg.backend):
        for c in range(start_chunk, n_chunks):
            faults.check_kill("path_chunk", c)
            chunk = padded[c * lane_width:(c + 1) * lane_width]
            d_arr = torch.tensor(chunk, dtype=Xt.dtype, device=Xt.device)
            l1 = torch.sum(torch.abs(carry))
            # the paper's rescaling warm start, per lane; carry == 0 stays 0
            alpha0s = carry[None, :] * (d_arr / torch.clamp_min(l1, 1e-12))[:, None]
            lanes_mon.begin_chunk()
            t0 = time.perf_counter()
            with tracer.span("fw_path_batched/chunk", cat="path", chunk=c):
                res, _ = solve_batched_fn(oracle, Xt, y, base_cfg, lane_sampler_fn(c), alpha0s,
                                          d_arr)
                objective = res.objective.tolist()  # waits for the chunk to finish
            dt = time.perf_counter() - t0
            carry = res.alpha[-1]
            real = min(lane_width, n - c * lane_width)
            iters = np.asarray(res.iterations)
            # the pruning win of the real lanes only (the engine's own count
            # also holds the padded lanes)
            chunk_saved = int(np.sum(iters.max() - iters[:real]))
            total_saved += chunk_saved
            conv = np.asarray(res.converged.tolist())[:real]
            lanes_mon.end_chunk(c, chunk[:real], iters[:real], chunk_saved, conv)
            if reg is not None:
                _observe_chunk(reg, base_cfg, real, conv, chunk_saved, dt)
            l1s = torch.sum(torch.abs(res.alpha), dim=1).tolist()
            active = res.active.tolist()
            gaps = None if res.gap is None else res.gap.tolist()
            for i in range(real):
                idx, val = _nnz(res.alpha[i])
                points.append(
                    PathPoint(
                        reg=float(chunk[i]),
                        objective=objective[i],
                        l1=l1s[i],
                        active=int(active[i]),
                        iterations=res.iterations[i],
                        n_dots=res.n_dots[i],
                        seconds=dt / real,
                        alpha_nnz_idx=idx,
                        alpha_nnz_val=val,
                        gap=float("nan") if gaps is None else gaps[i],
                    )
                )
            if checkpoint_dir is not None and (
                    (c + 1) % checkpoint_every == 0 or c == n_chunks - 1):
                path_ckpt.save_path_checkpoint(checkpoint_dir, c + 1, seed, carry, points,
                                               saved_iters=total_saved)
    _finish_path(reg, tracer)
    return PathResult(
        points,
        time.perf_counter() - t_total,
        sum(pt.n_dots for pt in points),
        sum(pt.iterations for pt in points),
        saved_iters=total_saved,
    )


def _observe_chunk(reg, cfg: FWConfig, real: int, conv, chunk_saved: int, dt: float) -> None:
    """A batched chunk's lane counters and latency into the registry, and one
    latency sample a real grid point (the chunk's amortized), so the point
    histogram's counts line up with the sequential driver's."""
    lbl = dict(backend=cfg.backend)
    reg.counter(
        "fw_lanes_admitted",
        "delta lanes admitted to batched path chunks",
        ("backend",),
    ).inc(real, **lbl)
    reg.counter(
        "fw_lane_freezes",
        "lanes frozen by per-lane early exit (converged before "
        "the chunk's while_loop drained)",
        ("backend",),
    ).inc(int(conv.sum()), **lbl)
    reg.counter(
        "fw_lane_saved_iterations",
        "lane-iterations pruned vs running every lane to the "
        "slowest lane's stop",
        ("backend",),
    ).inc(chunk_saved, **lbl)
    reg.histogram(
        "fw_path_chunk_seconds",
        "wall time per batched lane-chunk dispatch",
        ("backend",),
    ).observe(dt, **lbl)
    for _ in range(real):
        _observe_point(reg, "batched", cfg, dt / real)


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
        idx, val = _nnz(alpha)
        points.append(
            PathPoint(
                reg=float(reg),
                objective=objective,
                l1=float(torch.sum(torch.abs(alpha))),
                active=res.active,
                iterations=res.iterations,
                n_dots=res.n_dots,
                seconds=dt,
                alpha_nnz_idx=idx,
                alpha_nnz_val=val,
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
