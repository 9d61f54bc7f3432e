"""Numerical-health watchdog and graceful-degradation ladder (the
reference's ``resilience/guards.py``).

``solve_resilient`` is a host-driven twin of ``engine.solve``: the loop
advances in chunks of ``GuardSpec.chunk_steps`` turns of ``run_loop``'s
body (each turn one fused K-step chunk or one rule step, with the loop's
stop test before each turn), and between chunks a health check reads the
state: NaN/Inf in beta, scale or the oracle co-state (``kernels/health``:
one launch on the kernels' backends, its plain version on 'torch' and the
plain sparse ops, one 12-byte host read that also gives the stop test its
stall count), plus (opt-in) certified-gap monotonicity within a tolerance
band. A run with no fault is bit for bit ``engine.solve``. Like the
reference's guard, the loop does not flush a telemetry sink between
chunks; the ring drains once, in the result.

On a trip the guard walks a graceful-degradation ladder:

  1. **rebuild the co-state** by an exact matvec from the live alpha
     (``oracle.init_co(y, X @ alpha, ...)``, ``vertex.matvec``: a plain
     product, ``torch.mv`` or the sparse matvec): FW tolerates an
     approximate oracle (Kerdreux et al., 2018), so a ulp-level rebuild
     keeps the convergence guarantee;
  2. **retry the chunk** from the pre-chunk state through the per-step
     executor (``engine._fused_ref_chunk``: K unfused steps on the same
     kernels; ``rule_step`` for an unfused config), the sampler put back
     where the chunk began so the retry draws the chunk's own sets;
  3. **fall back a backend rung** (``fallback_config``): 'kernels' ->
     'torch', 'sparse' with its kernels -> the plain sparse ops,
     re-deriving the column statistics under the degraded config, and
     continue there. Only for CPU operands, where the kernels' backends
     already run their plain versions. On the card the ladder ends at rung
     2: a trip that the retry on the hand-written kernels did not heal
     raises :class:`UnrecoverableFaultError` naming the backend and the
     reason, so no plain version ever stands in for a kernel there (the
     reference's ladder goes on to 'xla').

The pre-chunk state is a snapshot: ``step`` updates beta in place and the
tails write the residual and the rules' state in place, so every tensor
of the state (beta, the co-state, the rule's state, the ring's storage)
is copied into buffers kept across chunks before each chunk, and only
while the guard runs. A launch or build failure of a kernel is an
exception, never a trip.

Every check, trip and recovery is counted in the metrics registry
(``fw_guard_checks``, ``fw_guard_trips{reason}``,
``fw_guard_recoveries{rung}``, ``fw_guard_unrecovered``); an exhausted
ladder raises :class:`UnrecoverableFaultError`. The distributed guard
(``solve_resilient_sharded``) waits for ROADMAP.md Queue 1 item 13.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.checkpoint.manager import map_tree
from repro_torch.core import engine, vertex
from repro_torch.core.solver_config import FWConfig
from repro_torch.kernels import health
from repro_torch.obs import metrics as obs_metrics
from repro_torch.resilience import faults


class UnrecoverableFaultError(RuntimeError):
    """The degradation ladder ran out of rungs (or trips): the run cannot
    be healed; the caller decides whether to restart cold."""


@dataclasses.dataclass(frozen=True)
class GuardSpec:
    """Watchdog configuration.

    Attributes:
      chunk_steps: loop turns per check window (each turn advances
        ``cfg.fuse_steps`` iterations when fused, else 1): the health
        check granularity.
      check_every: health-check every N chunks (1 = every chunk).
      gap_check_every: certified-gap monotonicity check every N chunks;
        0 (default) disables it: the gap is a full O(nnz) pass.
      gap_growth_limit: trip when the certified gap exceeds
        ``limit * running_min`` (the paper's gap decays on average;
        explosive growth means corrupt state).
      max_trips: total ladder trips tolerated before giving up.
    """

    chunk_steps: int = 8
    check_every: int = 1
    gap_check_every: int = 0
    gap_growth_limit: float = 100.0
    max_trips: int = 8


class _Buf(int):
    """A snapshot leaf: the index of its buffer (not a host int of the state)."""


class _Snapshot:
    """Copies of every tensor of an ``EngineState`` (the pre-chunk state),
    in buffers reused from chunk to chunk. ``restore`` gives a state of
    fresh clones, so a retry never writes into the snapshot; a tensor that
    appears twice in the state (PARTAN's anchor may be beta itself) comes
    back as one tensor."""

    def __init__(self):
        self._bufs: List[torch.Tensor] = []
        self._tree = None

    def take(self, state) -> None:
        ids = {}

        def enc(path, x):
            if not isinstance(x, torch.Tensor):
                return x  # host ints
            i = ids.get(id(x))
            if i is None:
                i = ids[id(x)] = len(ids)
                if i == len(self._bufs):
                    self._bufs.append(torch.empty_like(x))
                buf = self._bufs[i]
                if buf.shape != x.shape or buf.dtype != x.dtype or buf.device != x.device:
                    buf = self._bufs[i] = torch.empty_like(x)
                buf.copy_(x)
            return _Buf(i)

        self._tree = map_tree(enc, state)

    def restore(self):
        clones = {}

        def dec(path, x):
            if type(x) is not _Buf:
                return x
            if x not in clones:
                clones[x] = self._bufs[x].clone()
            return clones[x]

        return map_tree(dec, self._tree)


def fallback_config(cfg: FWConfig) -> Optional[FWConfig]:
    """One rung down the backend ladder, or None at the bottom: 'kernels'
    -> 'torch' (same math, no custom kernels); 'sparse' on its kernels ->
    the plain sparse ops. The matrix layout never changes (a
    SparseBlockMatrix stays sparse), so the state carries over."""
    if cfg.backend == "kernels":
        return dataclasses.replace(cfg, backend="torch")
    if cfg.backend == "sparse" and vertex.use_sparse_kernel(cfg):
        return dataclasses.replace(cfg, sparse_kernel=False)
    return None


def _observe(name: str, backend: str, **labels) -> None:
    reg = obs_metrics.get_registry()
    if reg is None:
        return
    helps = {
        "fw_guard_checks": "watchdog health checks between chunks",
        "fw_guard_trips": "watchdog trips by trip reason",
        "fw_guard_recoveries": "successful ladder recoveries by rung",
        "fw_guard_unrecovered": "ladder exhaustions (solve aborted)",
    }
    names = ("backend",) + tuple(sorted(labels))
    reg.counter(name, helps[name], names).inc(1, backend=backend, **labels)


def health_check(state, cfg: FWConfig):
    """``(beta_ok, co_ok, stall)`` as host ints from one device read:
    ``kernels/health``'s kernel where the backend runs the kernels, its
    plain version otherwise."""
    leaves = [t for t in state.co if isinstance(t, torch.Tensor) and t.is_floating_point()]
    fn = health.health_flags if vertex.use_kernels(cfg) else health.health_flags_plain
    beta_ok, co_ok, stall = fn(state.beta, state.scale, leaves, state.stall).tolist()
    return beta_ok, co_ok, stall


def _healthy(state, cfg: FWConfig) -> bool:
    beta_ok, co_ok, _ = health_check(state, cfg)
    return bool(beta_ok and co_ok)


def _advance(oracle, Xt, y, stats, state, cfg: FWConfig, delta, n_turns: int, sampler,
             use_ref: bool, turns: Optional[list] = None):
    """Up to ``n_turns`` turns of ``engine.run_loop``'s body, each after the
    loop's stop test (the caller has tested the first). ``use_ref=True``
    runs a fused config's chunks through the per-step executor
    (``engine._fused_ref_chunk``, ladder rung 2). ``turns``, when given,
    collects each turn's state."""
    patience = engine._patience(cfg)
    fused = vertex.fused_supported(oracle, cfg)
    for t in range(n_turns):
        if t and (state.k >= cfg.max_iters or engine._host_stall(state) >= patience):
            break
        if not fused:
            state = engine.rule_step(oracle, Xt, y, stats, state, cfg, delta, sampler)
        elif use_ref:
            state = engine._fused_ref_chunk(oracle, Xt, y, stats, state, cfg, delta, sampler)
        else:
            state = engine.fused_chunk(oracle, Xt, y, stats, state, cfg, delta, sampler)
        if turns is not None:
            turns.append(state)
    return state


def _rebuild_co(oracle, Xt, y, state, cfg: FWConfig):
    """Ladder rung 1: the co-state rebuilt by an exact matvec from the live
    alpha (the PARTAN odometer's refresh, for any oracle)."""
    alpha = state.scale * state.beta
    v = vertex.matvec(Xt, alpha, cfg)
    co = oracle.init_co(y, v, alpha, state.beta.dtype, cfg)
    return state._replace(co=co)


def solve_resilient(oracle, Xt, y, cfg: FWConfig, sampler, alpha0=None, delta=None, *,
                    guard: Optional[GuardSpec] = None, device="cuda",
                    on_step=None) -> engine.SolveResult:
    """``engine.solve`` under the watchdog and the degradation ladder.
    ``sampler`` must have ``position()``/``restore()`` (every sampler of
    ``core.vertex`` has). With no fault and no trip the result is bit for
    bit ``engine.solve``'s on the same sampler. ``on_step(state)``, when
    given, sees each turn's state as ``engine.solve``'s does, once its chunk
    is kept (a discarded chunk's states are never shown; a healed chunk's
    are its retry's). Runs on the card unless ``device`` says otherwise."""
    if cfg.backend == "distributed":
        raise ValueError("distributed operands go through solve_resilient_sharded")
    guard = GuardSpec() if guard is None else guard
    Xt, y = engine.prepare_inputs(Xt, y, cfg, device)
    delta_t = torch.tensor(float(cfg.delta if delta is None else delta), dtype=torch.float32,
                           device=Xt.device)
    stats = engine.precompute_colstats(Xt, y, cfg) if oracle.needs_stats else None
    state = engine.init_state(oracle, Xt, y, alpha0, cfg)
    live_cfg = cfg
    trips = 0
    chunk = 0
    min_gap = float("inf")
    prev = _Snapshot()
    checked_stall = None  # the last passed check's stall count, of the state it read

    def done(s) -> bool:
        stall = checked_stall if checked_stall is not None else engine._host_stall(s)
        return s.k >= live_cfg.max_iters or stall >= engine._patience(live_cfg)

    def keep(turns) -> None:
        for s in turns or ():
            on_step(s)

    while not done(state):
        checked_stall = None
        prev.take(state)
        pos = sampler.position()
        turns = None if on_step is None else []
        state = _advance(oracle, Xt, y, stats, state, live_cfg, delta_t, guard.chunk_steps,
                         sampler, False, turns)
        state = faults.maybe_corrupt_state(state, chunk)
        chunk += 1
        if chunk % guard.check_every:
            keep(turns)
            continue
        _observe("fw_guard_checks", live_cfg.backend)
        beta_ok, co_ok, stall = health_check(state, live_cfg)
        reason = None
        if not (beta_ok and co_ok):
            reason = "nonfinite_beta" if not beta_ok else "nonfinite_co"
        elif guard.gap_check_every and chunk % guard.gap_check_every == 0:
            g = float(engine.certified_gap(oracle, Xt, y, state.co, state.beta, state.scale,
                                           delta_t, live_cfg))
            if g == g and g < min_gap:  # finite and improving
                min_gap = g
            elif g != g or (min_gap < float("inf")
                            and g > guard.gap_growth_limit * max(abs(min_gap), 1e-30)):
                reason = "gap_regression"
        if reason is None:
            checked_stall = stall  # the check's read serves the loop's stop test
            keep(turns)
            continue

        # ---- the ladder ---------------------------------------------------
        trips += 1
        _observe("fw_guard_trips", live_cfg.backend, reason=reason)
        if trips > guard.max_trips:
            _observe("fw_guard_unrecovered", live_cfg.backend)
            raise UnrecoverableFaultError(
                f"guard tripped {trips} times (> max_trips={guard.max_trips}); "
                f"last reason: {reason}"
            )
        recovered = False
        # rung 1: exact-matvec co rebuild (needs a finite alpha)
        if beta_ok:
            cand = _rebuild_co(oracle, Xt, y, state, live_cfg)
            if _healthy(cand, live_cfg):
                state, recovered = cand, True
                min_gap = float("inf")
                _observe("fw_guard_recoveries", live_cfg.backend, rung="rebuild_co")
                keep(turns)
        # rung 2: discard the chunk, retry it from the snapshot per step
        if not recovered:
            sampler.restore(pos)
            turns = None if on_step is None else []
            cand = _retry_chunk(oracle, Xt, y, stats, prev.restore(), live_cfg, delta_t,
                                guard.chunk_steps, sampler, turns)
            if _healthy(cand, live_cfg):
                state, recovered = cand, True
                min_gap = float("inf")
                _observe("fw_guard_recoveries", live_cfg.backend, rung="retry_chunk")
                keep(turns)
        # rung 3: degrade the backend and retry from the snapshot there (CPU
        # operands only: on the card a trip that the hand-written kernels'
        # retry did not heal is their fault, and the run stops)
        if not recovered:
            fb = fallback_config(live_cfg)
            if fb is not None and state.beta.is_cuda:
                _observe("fw_guard_unrecovered", live_cfg.backend)
                raise UnrecoverableFaultError(
                    f"rungs 1-2 did not heal a trip (reason: {reason}) on the card's kernels "
                    f"(backend: {live_cfg.backend}); the plain fallback runs only on CPU operands"
                )
            if fb is not None:
                fb_stats = engine.precompute_colstats(Xt, y, fb) if oracle.needs_stats else None
                sampler.restore(pos)
                turns = None if on_step is None else []
                cand = _advance(oracle, Xt, y, fb_stats, prev.restore(), fb, delta_t,
                                guard.chunk_steps, sampler, False, turns)
                if _healthy(cand, fb):
                    _observe("fw_guard_recoveries", fb.backend, rung="backend_fallback")
                    state, recovered = cand, True
                    live_cfg, stats = fb, fb_stats
                    min_gap = float("inf")
                    keep(turns)
        if not recovered:
            _observe("fw_guard_unrecovered", live_cfg.backend)
            raise UnrecoverableFaultError(
                f"degradation ladder exhausted (reason: {reason}, backend: {live_cfg.backend})"
            )

    return engine._result(oracle, Xt, y, stats, state, engine._patience(live_cfg), live_cfg,
                          delta_t)


def _retry_chunk(oracle, Xt, y, stats, state, cfg: FWConfig, delta, n_turns: int, sampler,
                 turns=None):
    """Ladder rung 2's executor: the chunk again, per step."""
    return _advance(oracle, Xt, y, stats, state, cfg, delta, n_turns, sampler, True, turns)


def resilient_solve_fn(guard: Optional[GuardSpec] = None):
    """A ``solve_fn`` for ``path.fw_path(..., solve_fn=...)`` that runs
    every grid point through ``solve_resilient`` (on the operands' device)."""

    def fn(oracle, Xt, y, cfg, sampler, alpha0, delta):
        return solve_resilient(oracle, Xt, y, cfg, sampler, alpha0, delta, guard=guard,
                               device=Xt.device)

    return fn


def solve_resilient_sharded(oracle, op, cfg: FWConfig, key, alpha0=None, delta=None, *,
                            guard: Optional[GuardSpec] = None):
    """The distributed guard: not ported yet."""
    raise NotImplementedError(
        "solve_resilient_sharded needs the distributed backend: ROADMAP.md Queue 1 item 13"
    )
