"""Mesh-sharded FW solve drivers (the reference's ``distributed/driver.py``).

Every rank runs the SAME engine loop that serves the single-device
backends, on its tile, with ``cfg.backend='distributed'``: every oracle,
the lane-pruned batched driver and both regularization-path protocols run
on the mesh without a fork of the iteration. What is distributed is (a)
the operand's placement (``distributed.shard``), (b) the setup
collectives (column statistics, the warm-start matvec) and (c) the
collectives inside the step, in ``distributed.backend`` behind the
``core.vertex`` dispatch. The ranks replay the same sampling stream (each
is given a sampler of the same stream), and every scalar is computed on
every rank from the same reduced inputs by the same kernels, so every rank
reaches the same stop decision.

Where the reference compiles one shard_map program a static key, the port
runs each dispatch eagerly; ``_dispatch`` keeps the reference's spans and
metrics, a dispatch's program counted 'fresh' the first time its static
key (mesh, oracle, config, geometry, mode) runs in the process.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import threading
import time
import warnings
from typing import Optional

import torch

from repro_torch.core import engine, path as path_lib
from repro_torch.core.solver_config import FWConfig
from repro_torch.distributed import backend as dbackend
from repro_torch.distributed.shard import ShardedOperand
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.resilience import faults
from repro_torch.resilience import validate as _validate

_warned_fuse_steps = False


def dist_config(cfg: FWConfig, op: ShardedOperand) -> FWConfig:
    """The config the engine runs on every rank: the distributed backend,
    the operand's mesh vocabulary (``cfg.dist``) and ``fuse_steps = 1``.
    The caller's ``backend`` field is irrelevant here: the operand's layout
    decides.

    The fused chunk is single-device only: a rank's chunk would have to
    carry the score all_reduce and the column broadcast inside the kernel,
    K collective rounds a launch. A non-default ``fuse_steps`` warns once;
    ``SolveResult.effective_fuse_steps`` says what ran."""
    global _warned_fuse_steps
    if cfg.fuse_steps != 1 and not _warned_fuse_steps:
        _warned_fuse_steps = True
        warnings.warn(
            f"distributed driver forces fuse_steps=1 (requested {cfg.fuse_steps}): the fused "
            "multi-step chunk is single-device-only; see SolveResult.effective_fuse_steps for "
            "what actually ran",
            stacklevel=3,
        )
    return dataclasses.replace(cfg, backend="distributed", dist=op.spec, fuse_steps=1)


def _alpha0(op: ShardedOperand, alpha0):
    if alpha0 is None:
        return None
    return torch.as_tensor(alpha0).to(device=op.device, dtype=op.dtype)


class DispatchTimeoutError(RuntimeError):
    """A dispatch exceeded the active ``dispatch_policy`` timeout on every
    allowed attempt."""


@dataclasses.dataclass(frozen=True)
class DispatchPolicy:
    timeout_s: float
    retries: int = 1


_policy: Optional[DispatchPolicy] = None


@contextlib.contextmanager
def dispatch_policy(timeout_s: float, retries: int = 1):
    """Bound every distributed dispatch in the with-block to ``timeout_s``
    wall seconds, re-dispatching up to ``retries`` times before raising
    :class:`DispatchTimeoutError` (the reference's ``driver.py:285-362``).
    Each attempt runs on a worker thread and waits for the device; an
    attempt that has not started its solve when its time runs out (a
    straggler held at the injected-delay site, ``faults.maybe_delay``) is
    abandoned: a cancellation flag ends it before its first collective, so
    the ranks' collectives never fall out of step. An attempt that has
    started runs to its end, and its result is taken. Fault plans are
    replicated, so every rank times out together. Re-dispatches are counted
    as ``fw_dist_redispatches`` in the metrics registry."""
    global _policy
    prev = _policy
    _policy = DispatchPolicy(float(timeout_s), int(retries))
    try:
        yield
    finally:
        _policy = prev


class _Abandoned(RuntimeError):
    """An attempt whose dispatch timed out before it started."""


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _call_with_policy(entry: str, fn):
    """Run one dispatch under the active timeout policy (a pass-through
    when none is installed). The injected-delay site comes first in each
    attempt, then the cancellation check, then the solve."""
    pol = _policy
    lock = threading.Lock()

    def _attempt(state):
        faults.maybe_delay("dist_dispatch")
        with lock:
            if state["cancelled"]:
                raise _Abandoned(entry)
            state["started"] = True
        out = fn()
        if pol is not None:
            _sync()
        return out

    if pol is None:
        return _attempt({"cancelled": False, "started": False})
    reg = obs_metrics.get_registry()
    for _ in range(pol.retries + 1):
        state = {"cancelled": False, "started": False}
        ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        fut = ex.submit(_attempt, state)
        try:
            return fut.result(timeout=pol.timeout_s)
        except concurrent.futures.TimeoutError:
            with lock:
                started = state["started"]
                state["cancelled"] = not started
            if started:  # its collectives are under way on every rank: run it out
                return fut.result()
            if reg is not None:
                reg.counter(
                    "fw_dist_redispatches",
                    "distributed dispatch attempts abandoned after the dispatch_policy timeout",
                    ("entry",),
                ).inc(1, entry=entry)
        finally:
            ex.shutdown(wait=False, cancel_futures=True)
    raise DispatchTimeoutError(
        f"dist/{entry} exceeded {pol.timeout_s}s on {pol.retries + 1} attempt(s)"
    )


_programs: set = set()  # the static keys dispatched in this process


def _fresh(op: ShardedOperand, oracle, dcfg: FWConfig, mode: str) -> bool:
    # delta stays a run-time argument, as in the reference's programs
    key = (id(op.mesh), repr(oracle), repr(dataclasses.replace(dcfg, delta=0.0)), op.geom, mode)
    fresh = key not in _programs
    _programs.add(key)
    return fresh


def _dispatch(entry: str, op: ShardedOperand, fresh: bool, dcfg: FWConfig, fn, **span_kw):
    """Run one dispatch on ``op``'s mesh (``backend.on_mesh``) under its
    tracer span (``dist/<entry>``) and, only
    when a metrics registry is installed, time it to completion and fold the
    dispatch latency, the program-freshness counter, the solve's totals and
    the tracer's collective counters into the registry. Registry off: a
    pass-through, no extra sync."""
    reg = obs_metrics.get_registry()
    tracer = obs_trace.get_tracer()
    t0 = time.perf_counter()
    with tracer.span(f"dist/{entry}", cat="dist", new_program=fresh, **span_kw):
        with dbackend.on_mesh(op.mesh):
            out = _call_with_policy(entry, fn)
        if reg is not None:
            _sync()
    if reg is not None:
        elapsed = time.perf_counter() - t0
        # solve returns a bare SolveResult; history/batched return
        # (SolveResult, extra), and SolveResult is itself a tuple
        res = out if isinstance(out, engine.SolveResult) else out[0]
        reg.counter(
            "fw_dist_dispatches",
            "distributed shard_map dispatches by program freshness ('fresh' paid trace + XLA "
            "compile)",
            ("entry", "program"),
        ).inc(1, entry=entry, program="fresh" if fresh else "cached")
        reg.histogram(
            "fw_dist_dispatch_seconds",
            "host wall time per distributed dispatch (compile included when the program is "
            "fresh)",
            ("entry",),
        ).observe(elapsed, entry=entry)
        engine._observe_solve(reg, f"dist/{entry}", dcfg, res, elapsed)
        obs_metrics.tracer_to_registry(tracer, reg)
    return out


def _prepare(op: ShardedOperand, cfg: FWConfig) -> FWConfig:
    _validate.validate_inputs(op.tile, op.y)
    return dist_config(cfg, op)


def solve(oracle, op: ShardedOperand, cfg: FWConfig, sampler, alpha0=None,
          delta=None) -> engine.SolveResult:
    """The distributed ``engine.solve`` on every rank of ``op``'s mesh, each
    with a sampler of the same stream: the same stopping rule and
    trajectory contract (on a mesh with one data slice a uniform-sampling
    lasso run is the single-device run on the kernels' backend, bit for
    bit). Every result field comes back replicated."""
    dcfg = _prepare(op, cfg)
    d = float(cfg.delta if delta is None else delta)
    a0 = _alpha0(op, alpha0)
    return _dispatch(
        "solve", op, _fresh(op, oracle, dcfg, "solve"), dcfg,
        lambda: engine._solve_prepared(oracle, op.tile, op.y, dcfg, sampler, a0, d, p=op.p),
        layout=op.layout,
    )


def solve_with_history(oracle, op: ShardedOperand, cfg: FWConfig, sampler, n_iters: int,
                       alpha0=None):
    """A fixed-length distributed run recording the objective after each
    step, on the telemetry ring as ``engine.solve_with_history``. Returns
    ``(SolveResult, objective_history)``."""
    dcfg = _prepare(op, cfg)
    hcfg = engine.history_config(dcfg, n_iters)
    a0 = _alpha0(op, alpha0)
    return _dispatch(
        "solve_with_history", op, _fresh(op, oracle, hcfg, "history"), hcfg,
        lambda: engine._history_prepared(oracle, op.tile, op.y, hcfg, sampler, n_iters, a0,
                                         engine._patience(dcfg), p=op.p),
        n_iters=int(n_iters),
    )


def solve_batched(oracle, op: ShardedOperand, cfg: FWConfig, sampler, alpha0s, deltas):
    """The lane-pruned batched solve on the mesh (``sampler`` a lane
    sampler of the same streams on every rank): the engine's lane loop on
    every rank, one owned lane scores launch and one lane tail a step, so
    converged lanes freeze as on one device. Returns ``(batched
    SolveResult, saved_iters)``."""
    dcfg = _prepare(op, cfg)
    if alpha0s is not None:
        alpha0s = torch.as_tensor(alpha0s).to(device=op.device, dtype=op.dtype)
    lanes = int(torch.as_tensor(deltas).reshape(-1).shape[0])
    return _dispatch(
        "solve_batched", op, _fresh(op, oracle, dcfg, "batched"), dcfg,
        lambda: engine._solve_batched_prepared(oracle, op.tile, op.y, dcfg, sampler, alpha0s,
                                               deltas, p=op.p),
        lanes=lanes,
    )


def fw_path(op: ShardedOperand, deltas, base_cfg: FWConfig, seed: int = 0, oracle=None,
            report_gap: bool = True, *, sampler_fn=None, checkpoint_dir=None,
            checkpoint_every: int = 1, resume_from=None) -> path_lib.PathResult:
    """The sequential regularization path on the mesh (``path.fw_path``'s
    protocol, each point through ``solve``), certified gaps on by default;
    checkpoint and resume as ``path.fw_path``'s (the loop state lives on the
    host). ``sampler_fn(point_index)`` as ``path.fw_path``'s (by default a
    ``TorchSampler`` seeded from ``(seed, point index)``, the same on every
    rank)."""
    cfg = dataclasses.replace(base_cfg, report_gap=report_gap)

    def solve_fn(oracle_, Xt_, y_, cfg_, sampler, alpha0, delta):
        return solve(oracle_, op, cfg_, sampler, alpha0, delta)

    return path_lib.fw_path(op.tile, op.y, deltas, cfg, seed, oracle, placed=True,
                            sampler_fn=sampler_fn, solve_fn=solve_fn,
                            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
                            resume_from=resume_from)


def fw_path_batched(op: ShardedOperand, deltas, base_cfg: FWConfig, seed: int = 0,
                    lane_width: Optional[int] = None, oracle=None, report_gap: bool = True, *,
                    lane_sampler_fn=None, checkpoint_dir=None, checkpoint_every: int = 1,
                    resume_from=None) -> path_lib.PathResult:
    """The lane-pruned batched path on the mesh (``path.fw_path_batched``'s
    protocol, each chunk of lanes through ``solve_batched``); the pruning
    win is ``PathResult.saved_iters``."""
    cfg = dataclasses.replace(base_cfg, report_gap=report_gap)

    def solve_batched_fn(oracle_, Xt_, y_, cfg_, sampler, alpha0s, d_arr):
        return solve_batched(oracle_, op, cfg_, sampler, alpha0s, d_arr)

    return path_lib.fw_path_batched(op.tile, op.y, deltas, cfg, seed, lane_width, oracle,
                                    placed=True, p=op.p, lane_sampler_fn=lane_sampler_fn,
                                    solve_batched_fn=solve_batched_fn,
                                    checkpoint_dir=checkpoint_dir,
                                    checkpoint_every=checkpoint_every, resume_from=resume_from)


def certified_gap(oracle, op: ShardedOperand, alpha, delta, cfg: FWConfig) -> torch.Tensor:
    """The certified duality gap at ``alpha`` on the mesh (the oracle
    ``gap()`` protocol on every rank: the warm-start matvec, then the full
    gradient), replicated."""
    dcfg = dist_config(cfg, op)
    a = torch.as_tensor(alpha).to(device=op.device, dtype=op.dtype)
    d = torch.tensor(float(delta), dtype=torch.float32, device=op.device)
    with obs_trace.get_tracer().span("dist/certified_gap", cat="dist"):
        with dbackend.on_mesh(op.mesh):
            return engine.oracle_gap(oracle, op.tile, op.y, a, d, dcfg)
