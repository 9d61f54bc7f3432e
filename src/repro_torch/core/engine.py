"""The stochastic Frank-Wolfe engine (the reference's ``core/engine.py``,
per-step single-device part).

The engine owns the iteration skeleton: the sampled-vertex selection
(``core.vertex``), the scaled-iterate ``beta``/``scale`` update with
underflow renormalization, the ||alpha^{k+1}-alpha^k||_inf stopping
statistic with patience, and the loop. A problem oracle supplies the
objective-specific pieces through the reference's protocol
(``init_co``, ``cograd``, ``score_extra``, ``objective``, ``gap``),
whose ``line_search`` and ``update_co`` the port joins, with the
coefficient update between them (``apply_coeff_update``), into one
``tail``, so that the lasso's and the elastic-net's can run as one launch;
``core.fw_lasso``, ``core.fw_elasticnet`` and ``core.fw_logistic`` hold
the three oracles.

The loop is a Python ``while`` over ``step``, eager on the device. Every
scalar the step computes stays a 0-d device tensor, and every gather
(``beta[i_star]``, the selected column) is an index op with a device
index, so a step enqueues its work without waiting for the device, with
one exception: the stopping test ``stall < patience`` reads ``stall`` on
the host once per step. The iteration count ``k`` and the dot count
``n_dots`` are host integers: neither depends on the data. For the lasso
on the kernels' backends a step is four launches: the draw, the scores,
the argmax and ``kernels/step_tail`` (all that follows the argmax).

The design and y are float32 or bfloat16; the state (``beta``, its
scalars, the co-state) keeps that dtype, and each step computes its
scalars in float32, rounding each stored value once.

With ``FWConfig.fuse_steps = K > 1`` each turn of the loop advances K
iterations (``fused_chunk``), through the ``kernels/fused_step`` kernel on
the 'kernels' backend and on 'sparse' with its kernels on (the co-state
and the scalar recursions stay on the device across the K steps; a
float32 design whose m fits the kernel's shared memory) or K unfused
steps otherwise, and the stopping test is read on the host once
per chunk: a stop lands on the first chunk boundary where the stall
count has reached patience (K-1 steps after the unfused stop at most,
while the stall streak lasts to that boundary), and max_iters stays
exact (trailing chunk steps are masked). The kernel emits per-step
records that ``_fused_replay`` turns into the O(p) coefficient updates
with the unfused op sequence (``apply_coeff_update``). An elastic-net chunk
also takes the chunk-start alpha values at its samples (``_fused_streams``)
and, after the replay, reconciles Q with its exact value when the chunk
crossed a refresh step. The logistic oracle has no fused form: its chunks
run as unfused steps, bit for bit.

``solve_with_history`` runs a fixed number of steps and records the
objective after each, on the telemetry ring as the reference does: a ring
of capacity ``n_iters`` with the objective on, whose chunks run as K
unfused steps (the ``record_objective`` routing).

Telemetry (``FWConfig.telemetry``, ``obs.telemetry``): the ring rides on
``EngineState.tel`` and each step writes one record. The lasso's and the
elastic-net's tail writes it inside its launch on the kernels' backends
(the ``kernels/step_tail`` TEL instantiations; a refresh step's objective
then amended by one plain write), the logistic's tail and the step rules
write it with plain scalar writes, and a fused kernel chunk's replay
writes its K records inside its launch (``record_objective=False``; with
the objective on, a chunk runs as K unfused steps). The cursor is a host
integer, so no record reads the device; a turn of the loop flushes the
ring to its sink when it holds ``capacity`` unflushed records, and
``_result`` flushes the rest. With telemetry off no ring exists and the
loop launches what it launched before.

Metrics (``obs.metrics``): ``solve``, ``solve_with_history`` and
``solve_batched`` (and the path drivers' ``solve_prepared`` and
``solve_batched_prepared``) are ``_MetricsEntry`` wrappers; with a
registry installed each call waits for the card before it reads the
clock and folds its totals, latency and gap into the registry, with none
installed it is a pass-through.

Batched lanes (``solve_batched``, ``batched_loop``): L delta lanes, each
with its own warm start and sampling stream, share one loop with early
exit per lane, the reference's ``solve_batched``. The lane state is
``EngineState`` with a leading lane axis on the device fields and a host
int a lane for ``k`` and ``n_dots``; a batched step is one draw for all
the lanes, one launch each of the lane-axis scores, argmax and tail on
the kernels' backends, and one host read of the ``(L,)`` stall vector per
step (per K-step chunk under ``fuse_steps = K``). A frozen lane keeps its
state bit for bit, and each lane's trajectory is the sequential solve's
on the same stream, bit for bit.

Step rules (``FWConfig.step_rule``): ``run_loop`` steps through
``rule_step``, which is ``step`` itself for 'classic' (its launches and bits
unchanged) and ``core.step_rule``'s rule otherwise ('away', 'pairwise',
'partan', 'lazy'); the rule's state rides on ``EngineState.rule``. A rule
that needs a fact on the host reads it there: PARTAN its drift refresh with
the stall count in the step's one host read, handing the count to the loop
(``EngineState.stall_host``), the lazy rule its cache hit before the draw.
The rules do not fuse (the per-step loop runs, with a warning).

The rules under lanes (``batched_step`` hands a non-classic step to the
rule's ``step_lanes``): the lane-stacked state carries the rule's state
with a lane axis (``stack_states``), and each lane is the rule's
sequential solve on its stream, bit for bit. A rule's host facts ride the
turn's one host read: PARTAN's refresh is read with the stall vector inside
its step (``EngineState.stall_host``, a list), the lazy rule's hits before
its draw, beside the stall vector (``batched_loop`` takes the rule's
``peek_lanes`` first).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import vertex
from repro_torch.core.solver_config import FWConfig
from repro_torch.kernels import fused_step as _fused_step
from repro_torch.kernels.colstats import colstats as _colstats_kernel
from repro_torch.kernels.step_tail import apply_coeff_update  # noqa: F401 (step 5, re-exported)
from repro_torch.kernels.step_tail import TailRecord
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import telemetry as obs_telemetry
from repro_torch.resilience.validate import validate_inputs
from repro_torch.sparse import ops as sparse_ops
from repro_torch.sparse.matrix import SparseBlockMatrix


class ColStats(NamedTuple):
    """Per-column statistics precomputed once before the iterations (§4.2)."""

    zty: torch.Tensor  # (p,)  z_i^T y
    znorm2: torch.Tensor  # (p,)  ||z_i||^2
    yty: torch.Tensor  # ()    y^T y


class EngineState(NamedTuple):
    """Loop state shared by every oracle. ``alpha = scale * beta``; ``co``
    is the oracle's co-state. ``step`` updates ``beta`` in place (an O(p)
    copy per step would cost more than the step's sampled work), so a
    state's ``beta`` is only valid until the next step from it."""

    beta: torch.Tensor  # (p,) unscaled coefficients
    scale: torch.Tensor  # ()  multiplicative scale
    co: Any  # oracle co-state (NamedTuple of tensors)
    maxabs: torch.Tensor  # ()  running upper bound on ||alpha||_inf
    step_inf: torch.Tensor  # ()  ||alpha^{k+1} - alpha^k||_inf (bound)
    stall: torch.Tensor  # ()  int32, consecutive sub-tolerance steps
    n_dots: int  # length-m dot products consumed so far (exact)
    k: int  # iteration counter
    # int64: () the last step's vertex (-1 before any); after a fused chunk
    # (n_active,) the vertices of the chunk's live steps; lanes: (L,) the
    # last batched step's, -1 for a lane frozen in it
    i_star: torch.Tensor
    rule: Any = ()  # the step rule's state (core.step_rule); () for 'classic'
    # the stall count as the step's own host read gave it (a rule with a host
    # fact to read); None: ``run_loop`` reads ``stall`` itself
    stall_host: Optional[int] = None
    # the telemetry ring (obs.telemetry.TelemetryRing; lanes: a lane ring);
    # None when cfg.telemetry is None
    tel: Any = None
    # lanes with a score shift on the card's lane kernels' cluster route: the
    # support bitmap of beta (vertex.lane_support, kernels.fw_grad.pack_support;
    # a superset of beta's nonzeros), which the shifted lane argmax reads and
    # updates in place; a cache derived from beta, never checkpointed. None
    # elsewhere
    support: Any = None


class SolveResult(NamedTuple):
    alpha: torch.Tensor
    objective: torch.Tensor
    iterations: int
    n_dots: int
    active: torch.Tensor  # () number of nonzero coefficients
    converged: torch.Tensor
    # certified FW duality gap at alpha (cfg.report_gap; None otherwise)
    gap: Optional[torch.Tensor] = None
    # iterations advanced per dispatch: cfg.fuse_steps when the fused chunk
    # engaged (``vertex.fused_supported``), else 1
    effective_fuse_steps: int = 1
    # the final telemetry ring when cfg.telemetry is set (None otherwise);
    # lanes: a lane ring (``ring.lane(l)``); read with
    # obs.telemetry.ring_to_records
    telemetry: Optional[Any] = None


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; 'cuda' needs a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "solver's plain versions on the CPU"
        )
    return dev


def check_ported(cfg: FWConfig) -> None:
    """Refuse a config the port cannot run: a ``telemetry`` that is not an
    ``obs.TelemetrySpec``."""
    if cfg.telemetry is not None and not isinstance(cfg.telemetry, obs_telemetry.TelemetrySpec):
        raise TypeError(
            f"FWConfig.telemetry takes a repro_torch.obs.TelemetrySpec, got "
            f"{type(cfg.telemetry).__name__}"
        )


def prepare_inputs(Xt, y, cfg: FWConfig, device):
    """Check the config and the operands once per entry call and place the
    operands on ``device`` (no copy when they are already there). The
    design and y share one dtype, float32 or bfloat16; the solver's state
    lives in it (``init_state``) and each step computes its scalars in
    float32. The NaN/Inf check is ``resilience.validate``'s, once per
    operand object."""
    dev = resolve_device(device)
    check_ported(cfg)
    vertex.check_matrix_backend(Xt, cfg)
    if isinstance(Xt, SparseBlockMatrix):
        Xt = Xt.to(dev)
        if Xt.rows.dtype != torch.int32:
            raise TypeError(f"a SparseBlockMatrix's rows are int32, got {Xt.rows.dtype}")
    else:
        Xt = torch.as_tensor(Xt, device=dev).contiguous()
    y = torch.as_tensor(y, device=dev).contiguous()
    if Xt.dtype not in (torch.float32, torch.bfloat16) or y.dtype != Xt.dtype:
        raise TypeError(
            f"the solver needs Xt and y of one dtype, float32 or bfloat16, got Xt "
            f"{Xt.dtype} and y {y.dtype}"
        )
    if y.shape != (Xt.shape[1],):
        raise ValueError(f"y must be (m,) = ({Xt.shape[1]},), got {tuple(y.shape)}")
    validate_inputs(Xt, y)
    return Xt, y


def precompute_colstats(Xt, y: torch.Tensor, cfg: Optional[FWConfig] = None,
                        p: Optional[int] = None) -> ColStats:
    """One full pass over X: z_i^T y and ||z_i||^2 for every column (§4.2),
    through K1 on the 'kernels' backend. A ``SparseBlockMatrix`` sweeps its
    stored slots only, through K6 unless ``cfg.sparse_kernel`` is False
    (without a cfg, the plain ops, as the reference). Distributed (``Xt`` a
    rank's tile): the tile's K1/K6 sums completed over the mesh, replicated
    at the global ``p``, which the caller gives."""
    if cfg is not None and cfg.backend == "distributed":
        if p is None:
            raise ValueError("the distributed column statistics need the global p")
        from repro_torch.distributed import backend as dist_backend  # lazy: layered on top

        return ColStats(*dist_backend.dist_colstats(Xt, y, cfg, p))
    if isinstance(Xt, SparseBlockMatrix):
        use_kernel = cfg is not None and vertex.use_sparse_kernel(cfg)
        zty, znorm2 = sparse_ops.sparse_colstats(Xt, y, use_kernel=use_kernel)
        return ColStats(zty=zty, znorm2=znorm2, yty=torch.dot(y, y))
    if cfg is not None and cfg.backend == "kernels":
        zty, znorm2 = (s.to(Xt.dtype) for s in _colstats_kernel(Xt, y))  # f32 sums
    else:
        zty = Xt @ y
        znorm2 = torch.einsum("pm,pm->p", Xt, Xt)
    return ColStats(zty=zty, znorm2=znorm2, yty=torch.dot(y, y))


def _patience(cfg: FWConfig) -> int:
    return cfg.patience if cfg.sampling != "full" else 1


def init_state(oracle, Xt, y, alpha0=None, cfg=None, p: Optional[int] = None) -> EngineState:
    """Start from the null solution, or warm-start from ``alpha0`` (copied).
    ``p`` (the global feature count, given for a rank's tile), the dtype and
    the device are read off the matrix, dense or sparse."""
    p = Xt.shape[0] if p is None else p
    dtype, dev = Xt.dtype, Xt.device
    if alpha0 is None:
        beta = torch.zeros(p, dtype=dtype, device=dev)
        v = None
        maxabs = torch.zeros((), dtype=dtype, device=dev)
    else:
        beta = torch.as_tensor(alpha0).to(device=dev, dtype=dtype, copy=True)
        v = vertex.matvec(Xt, beta, cfg)  # X alpha
        maxabs = torch.max(torch.abs(beta))
    co = oracle.init_co(y, v, beta, dtype, cfg)
    rule = ()
    if cfg is not None and cfg.step_rule != "classic":
        # lazy import: the rules layer on top of the engine
        from repro_torch.core import step_rule

        rule = step_rule.get_rule(cfg).init_state(oracle, cfg, beta, co, y)
    tel = None
    if cfg is not None and cfg.telemetry is not None:
        tel = obs_telemetry.init_ring(cfg.telemetry, dev)
    return EngineState(
        beta=beta,
        scale=torch.ones((), dtype=dtype, device=dev),
        co=co,
        maxabs=maxabs,
        step_inf=torch.full((), float("inf"), dtype=dtype, device=dev),
        stall=torch.zeros((), dtype=torch.int32, device=dev),
        n_dots=0,
        k=0,
        i_star=torch.full((), -1, dtype=torch.int64, device=dev),
        rule=rule,
        tel=tel,
    )


def tail_record(state: EngineState, stats, n_dots: int, cfg: FWConfig) -> Optional[TailRecord]:
    """The ring record the step's tail writes (None with telemetry off): at
    the cursor's slot, the step's k and the dot count ``n_dots`` after it,
    with the objective (and y.y) as the spec asks."""
    tel = state.tel
    if tel is None:
        return None
    objective = cfg.telemetry.record_objective
    cap = tel.capacity
    return TailRecord(tel.buf, cap, tel.cursor % cap, state.k, n_dots, objective,
                      stats.yty if objective and stats is not None else None)


def step(oracle, Xt, y, stats, state: EngineState, cfg: FWConfig, delta, sampler) -> EngineState:
    """One randomized Frank-Wolfe step (paper Algorithm 2, any oracle).
    ``delta`` is a 0-d device tensor, so one path reuses every launch."""
    p = state.beta.shape[0]

    # -- step 2: score the sampled coordinates against the co-gradient ------
    w = oracle.cograd(state.co, y)
    extra_fn = oracle.score_extra(state.beta, state.scale)
    i_star, g_raw, g_sel, n_scored = vertex.sample_vertex(Xt, w, sampler, p, cfg, extra_fn)

    # -- steps 3-6: eq. 6's sign, the line search, the coefficient update
    # (``apply_coeff_update``) and the co-state recursions, and the ring's
    # record ------------------------------------------------------------------
    n_dots = state.n_dots + n_scored + oracle.extra_dots
    rec = tail_record(state, stats, n_dots, cfg)
    beta, scale, maxabs, step_inf, stall, co = oracle.tail(
        Xt, y, stats, state, i_star, g_raw, g_sel, delta, cfg, tel=rec)
    return EngineState(
        beta=beta,
        scale=scale,
        co=co,
        maxabs=maxabs,
        step_inf=step_inf,
        stall=stall,
        n_dots=n_dots,
        k=state.k + 1,
        i_star=i_star,
        rule=state.rule,
        tel=None if rec is None else obs_telemetry.advance(state.tel),
    )


def rule_step(oracle, Xt, y, stats, state: EngineState, cfg: FWConfig, delta,
              sampler) -> EngineState:
    """One iteration under ``cfg.step_rule`` (the reference's
    ``core/engine.py:344-360``): 'classic' is ``step`` itself, so its
    trajectory keeps its bits; the other rules dispatch through
    ``core.step_rule`` (a lazy import: the rules layer on top of the
    engine)."""
    if cfg is None or cfg.step_rule == "classic":
        return step(oracle, Xt, y, stats, state, cfg, delta, sampler)
    from repro_torch.core import step_rule

    return step_rule.get_rule(cfg).step(oracle, Xt, y, stats, state, cfg, delta, sampler)


def _host_stall(state: EngineState) -> int:
    """The stall count on the host: the step's own read where it made one,
    else one read now."""
    return state.stall_host if state.stall_host is not None else int(state.stall)


def certified_gap(oracle, Xt, y, co, beta, scale, delta, cfg=None) -> torch.Tensor:
    """Exact FW duality gap g(alpha) = alpha^T grad + delta*||grad||_inf
    from a live co-state: one full-gradient O(p*m) pass, certification
    only, never the hot loop."""
    p = beta.shape[0]
    w = oracle.cograd(co, y)
    grad = vertex.grad_full(Xt, w, cfg)[:p]
    extra_fn = oracle.score_extra(beta, scale)
    if extra_fn is not None:
        grad = grad + extra_fn(torch.arange(p, device=grad.device))
    alpha = scale * beta
    return torch.dot(alpha, grad) + delta * torch.max(torch.abs(grad))


def oracle_gap(oracle, Xt, y, alpha, delta, cfg=None) -> torch.Tensor:
    """Certified duality gap at a bare coefficient vector: rebuild the
    oracle co-state from X alpha, then ``certified_gap``."""
    v = vertex.matvec(Xt, alpha, cfg)
    co = oracle.init_co(y, v, alpha, alpha.dtype, cfg)
    one = torch.ones((), dtype=alpha.dtype, device=alpha.device)
    return certified_gap(oracle, Xt, y, co, alpha, one, delta, cfg)


# --------------------------------------------------------------------------
# Fused multi-step chunks (FWConfig.fuse_steps > 1)
# --------------------------------------------------------------------------


def _fused_streams(oracle, stats, state: EngineState, cfg: FWConfig, p: int, sampler):
    """The chunk's K x kappa uniform index stream (the unfused steps' draws,
    trailing masked steps included, as the reference draws them), the
    column statistics pregathered at it and, for an oracle whose scores
    read live alpha values (the elastic-net), the chunk-start alpha at it
    in f32 (None else)."""
    idx = sampler.uniform_chunk(cfg.fuse_steps, cfg.kappa, p)
    flat = idx.view(-1)
    zty_s = stats.zty.index_select(0, flat).view(idx.shape)
    zn2_s = stats.znorm2.index_select(0, flat).view(idx.shape)
    alpha_s = None
    if oracle.fused_needs_alpha:
        alpha_s = (state.scale * state.beta.index_select(0, flat)).float().view(idx.shape)
    return idx, zty_s, zn2_s, alpha_s


def q_exact(beta: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Q = ||alpha||^2 from the scaled iterate, the exact refresh of the
    elastic-net's recursion: ``dot(beta, beta) * scale**2``."""
    return torch.dot(beta, beta) * scale**2


def _fused_replay(state: EngineState, cfg: FWConfig, i_stars, lams, delta_ts, no_progs,
                  per_step: int):
    """Replay the chunk's per-step records into the O(p) coefficient updates
    and the stopping statistics, with ``apply_coeff_update``'s op sequence
    (``kernels/fused_step.fused_replay``: one launch per chunk on the card,
    that loop itself on the CPU), and with telemetry on write each live
    step's ring record in the same launch (``per_step`` dots a step). Steps
    at k >= max_iters are skipped. Returns ``(beta, scale, maxabs,
    step_inf, stall)``."""
    tel = state.tel
    rec = None
    if tel is not None:
        rec = _fused_step.ReplayRecord(tel.buf, tel.capacity, tel.cursor % tel.capacity,
                                       state.n_dots, per_step)
    return _fused_step.fused_replay(
        state.beta, state.scale, state.maxabs, state.step_inf, state.stall,
        i_stars, lams, delta_ts, no_progs, state.k, cfg, rec,
    )


def _fused_kernel_chunk(oracle, Xt, y, stats, state: EngineState, cfg: FWConfig, delta,
                        sampler) -> EngineState:
    """One K-step chunk through the fused kernel: draw and pregather the
    streams, run the K iterations with the co-state on the device, then
    replay the step records into the coefficient and stopping state."""
    p = state.beta.shape[0]
    idx, zty_s, zn2_s, alpha_s = _fused_streams(oracle, stats, state, cfg, p, sampler)
    resid0, scal0 = oracle.fused_pack_co(state.co)
    i_stars, lams, delta_ts, no_progs, resid_out, scal_out = vertex.run_fused_kernel(
        oracle, Xt, y, resid0, scal0, idx, zty_s, zn2_s, alpha_s, state.k, delta, cfg
    )
    per_step = cfg.kappa + oracle.extra_dots
    beta, scale, maxabs, step_inf, stall = _fused_replay(
        state, cfg, i_stars, lams, delta_ts, no_progs, per_step
    )
    n_active = min(cfg.fuse_steps, cfg.max_iters - state.k)
    co = oracle.fused_unpack_co(resid_out, scal_out)
    re = cfg.refresh_every
    if oracle.fused_needs_alpha and any(k % re == re - 1
                                        for k in range(state.k, state.k + n_active)):
        # the chunk has no beta for Q's exact refresh: reconcile Q at chunk
        # granularity when a live step of the chunk was a refresh step
        co = co._replace(q_norm=q_exact(beta, scale).to(co.q_norm.dtype))
    return EngineState(
        beta=beta,
        scale=scale,
        co=co,
        maxabs=maxabs,
        step_inf=step_inf,
        stall=stall,
        n_dots=state.n_dots + n_active * per_step,
        k=state.k + n_active,
        i_star=i_stars[:n_active],
        tel=None if state.tel is None else obs_telemetry.advance(state.tel, n_active),
    )


def _fused_ref_chunk(oracle, Xt, y, stats, state: EngineState, cfg: FWConfig, delta,
                     sampler, per_step=None) -> EngineState:
    """The chunk executor of 'torch' and of the plain sparse ops: K unfused
    engine steps (bit-exact against fuse_steps=1 by construction), skipping
    the steps past max_iters; the stopping test is the caller's, between
    chunks. ``per_step(state)``, when given, sees the state after each step."""
    seq = []
    for _ in range(min(cfg.fuse_steps, cfg.max_iters - state.k)):
        state = step(oracle, Xt, y, stats, state, cfg, delta, sampler)
        if per_step is not None:
            per_step(state)
        seq.append(state.i_star)
    return state._replace(i_star=torch.stack(seq))


def fused_chunk(oracle, Xt, y, stats, state: EngineState, cfg: FWConfig, delta,
                sampler) -> EngineState:
    """Advance K = cfg.fuse_steps iterations in one turn of the loop (the
    fused kernel where ``vertex.use_fused_kernel``, K unfused steps
    otherwise: a bf16 design, a state past the fused kernels' shared
    memory, or telemetry that records each step's objective, which the
    fused kernel does not compute; those steps are the fused solve's, bit
    for bit)."""
    per_step_objective = cfg.telemetry is not None and cfg.telemetry.record_objective
    if vertex.use_fused_kernel(cfg, Xt, oracle) and not per_step_objective:
        return _fused_kernel_chunk(oracle, Xt, y, stats, state, cfg, delta, sampler)
    return _fused_ref_chunk(oracle, Xt, y, stats, state, cfg, delta, sampler)


def run_loop(oracle, Xt, y, stats, state0, cfg, delta, patience, sampler, on_step=None,
             per_step=None):
    """Step until the §Stopping rule fires or max_iters. ``on_step(state)``,
    when given, sees every new state (the parity tests read ``i_star``).

    With ``cfg.fuse_steps = K > 1`` (and ``vertex.fused_supported``) each
    turn advances a K-step chunk, ``on_step`` sees the state after each
    chunk, whose ``i_star`` holds the chunk's vertices, and the stopping
    rule is read between chunks (a stop lands on a chunk boundary;
    max_iters stays exact).

    ``per_step(state)``, when given, sees the state after every step, inside
    chunks too: a chunk then runs as K unfused steps (``_fused_ref_chunk``,
    the steps of the unfused solve bit for bit, the stops still on chunk
    boundaries), as the reference routes a chunk whose every step is
    recorded (``record_objective``).

    With a telemetry sink (``TelemetrySpec(stream_to=...)``) a turn ends
    with ``stream_flush``, which copies the ring to the host only when it
    holds ``capacity`` unflushed records.
    """
    fused = vertex.fused_supported(oracle, cfg)
    spec = cfg.telemetry
    stream = spec is not None and spec.stream_to is not None
    state = state0
    # `stall` is read on the host: the one device sync per step, or per
    # chunk on the fused path (a copy, and no comparison kernel)
    while state.k < cfg.max_iters and _host_stall(state) < patience:
        if not fused:
            state = rule_step(oracle, Xt, y, stats, state, cfg, delta, sampler)
            if per_step is not None:
                per_step(state)
        elif per_step is None:
            state = fused_chunk(oracle, Xt, y, stats, state, cfg, delta, sampler)
        else:
            state = _fused_ref_chunk(oracle, Xt, y, stats, state, cfg, delta, sampler, per_step)
        if stream:
            state = state._replace(tel=obs_telemetry.stream_flush(state.tel, spec, final=False))
        if on_step is not None:
            on_step(state)
    return state


def _result(oracle, Xt, y, stats, final: EngineState, patience: int, cfg, delta) -> SolveResult:
    alpha = final.scale * final.beta
    gap = None
    if cfg.report_gap:
        gap = certified_gap(oracle, Xt, y, final.co, final.beta, final.scale, delta, cfg)
    tel = final.tel
    if tel is not None:
        # drain whatever the loop's flushes have not shipped
        tel = obs_telemetry.stream_flush(tel, cfg.telemetry, final=True)
    return SolveResult(
        alpha=alpha,
        objective=oracle.objective(y, stats, final.co, cfg),
        iterations=final.k,
        n_dots=final.n_dots,
        active=torch.sum(alpha != 0.0),
        converged=final.stall >= patience,
        gap=gap,
        effective_fuse_steps=cfg.fuse_steps if vertex.fused_supported(oracle, cfg) else 1,
        telemetry=tel,
    )


def _solve_prepared(oracle, Xt, y, cfg: FWConfig, sampler, alpha0=None, delta=None,
                    on_step=None, per_step=None, p: Optional[int] = None) -> SolveResult:
    """``solve`` on operands that ``prepare_inputs`` already placed and
    checked (the path driver checks once, not per grid point);
    ``per_step`` as ``run_loop``'s; ``p`` the global feature count where
    ``Xt`` is a rank's tile (the distributed driver)."""
    delta = torch.tensor(float(cfg.delta if delta is None else delta),
                         dtype=torch.float32, device=Xt.device)
    stats = precompute_colstats(Xt, y, cfg, p) if oracle.needs_stats else None
    state0 = init_state(oracle, Xt, y, alpha0, cfg, p)
    patience = _patience(cfg)
    final = run_loop(oracle, Xt, y, stats, state0, cfg, delta, patience, sampler, on_step,
                     per_step)
    return _result(oracle, Xt, y, stats, final, patience, cfg, delta)


def _solve(oracle, Xt, y, cfg: FWConfig, sampler, alpha0=None, delta=None, *,
           device="cuda", on_step=None, per_step=None) -> SolveResult:
    """Run the oracle's Algorithm-2 analogue until
    ||alpha_{k+1}-alpha_k||_inf <= tol for ``patience`` consecutive
    iterations, or max_iters. ``sampler`` draws each step's sampling set
    (``vertex.TorchSampler`` or ``vertex.StreamSampler``, on ``device``);
    ``delta`` overrides cfg.delta; ``on_step`` and ``per_step`` as
    ``run_loop``'s. Runs on the card unless ``device`` says otherwise."""
    Xt, y = prepare_inputs(Xt, y, cfg, device)
    return _solve_prepared(oracle, Xt, y, cfg, sampler, alpha0, delta, on_step, per_step)


# --------------------------------------------------------------------------
# The history solve (fixed length, the objective after every step)
# --------------------------------------------------------------------------


def history_patience(n_iters: int) -> int:
    """The patience ``solve_with_history`` runs the loop with: stall reaches
    at most n_iters, so n_iters + 1 never stops the run early, which takes
    exactly n_iters steps through the one shared ``run_loop``."""
    return int(n_iters) + 1


def _solve_with_history(oracle, Xt, y, cfg: FWConfig, sampler, n_iters: int, alpha0=None, *,
                        device="cuda"):
    """Run exactly ``n_iters`` steps at ``cfg.delta``, recording f(alpha^k)
    after each (convergence plots). Returns ``(SolveResult,
    objective_history)``, the history an ``(n_iters,)`` tensor on the
    device in the design's dtype. Built on the telemetry ring, as the
    reference's: the run is ``run_loop`` with a ring of capacity
    ``n_iters`` and the objective on (``obs.telemetry.history_spec``; a
    spec in ``cfg.telemetry`` keeps its sink), so slot t is iteration t,
    and the history is the ring's objective column; each record is written
    on the device, so the steps keep their one host read each. With
    ``fuse_steps = K > 1`` the chunks run as K unfused steps (the
    ``record_objective`` routing), the unfused solve's steps bit for bit.
    ``converged`` is read against the config's own patience, as the
    reference's is; the result carries the ring."""
    hcfg = history_config(cfg, n_iters)
    Xt, y = prepare_inputs(Xt, y, hcfg, device)
    return _history_prepared(oracle, Xt, y, hcfg, sampler, n_iters, alpha0, _patience(cfg))


def history_config(cfg: FWConfig, n_iters: int) -> FWConfig:
    """The config a history solve runs: ``n_iters`` steps and a ring of
    ``n_iters`` records with the objective on (a spec in ``cfg.telemetry``
    keeps its sink)."""
    return dataclasses.replace(cfg, max_iters=int(n_iters),
                               telemetry=obs_telemetry.history_spec(cfg.telemetry, n_iters))


def _history_prepared(oracle, Xt, y, hcfg: FWConfig, sampler, n_iters: int, alpha0,
                      patience: int, p: Optional[int] = None):
    """``solve_with_history`` on placed operands under ``history_config``'s
    ``hcfg``; ``patience`` the caller's config's, for ``converged``; ``p``
    as ``_solve_prepared``'s."""
    delta = torch.tensor(float(hcfg.delta), dtype=torch.float32, device=y.device)
    stats = precompute_colstats(Xt, y, hcfg, p) if oracle.needs_stats else None
    state0 = init_state(oracle, Xt, y, alpha0, hcfg, p)
    final = run_loop(oracle, Xt, y, stats, state0, hcfg, delta, history_patience(n_iters),
                     sampler)
    res = _result(oracle, Xt, y, stats, final, patience, hcfg, delta)
    return res, res.telemetry.objective[:int(n_iters)].to(Xt.dtype)


# --------------------------------------------------------------------------
# Batched delta lanes (the reference's solve_batched)
# --------------------------------------------------------------------------


_lane_id_cache: dict = {}


def lane_ids(active, device) -> torch.Tensor:
    """The ids of the lanes that step (``active``, the host's list), as the
    int32 device tensor the lane kernels take; made once a pattern (a lane
    freezing, a lazy rule's misses) and device, so a step copies nothing to
    the device."""
    key = (device, tuple(bool(a) for a in active))
    ids = _lane_id_cache.get(key)
    if ids is None:
        if len(_lane_id_cache) > 256:
            _lane_id_cache.clear()
        ids = _lane_id_cache[key] = torch.tensor([i for i, a in enumerate(key[1]) if a],
                                                 dtype=torch.int32, device=device)
    return ids


def _check_lane_oracle(oracle) -> None:
    """The lanes run an oracle's ``tail_lanes`` (the lasso's, the
    elastic-net's and the logistic's have one)."""
    if not hasattr(oracle, "tail_lanes"):
        raise NotImplementedError(
            f"batched lanes need the oracle's tail_lanes; {type(oracle).__name__} has none"
        )


def stack_states(states) -> EngineState:
    """One lane-stacked ``EngineState`` from one state a lane, the step
    rule's state too (its tensors with a leading lane axis: the away and
    pairwise buffer ``(L, n)``, PARTAN's anchor, its image and odometer,
    the lazy cache and phi)."""
    def stack(ts):
        return torch.stack(list(ts))

    rule = states[0].rule
    if isinstance(rule, torch.Tensor):
        rule = stack(s.rule for s in states)
    else:
        rule = tuple(stack(s.rule[i] for s in states) for i in range(len(rule)))

    co = type(states[0].co)(*(stack(f) for f in zip(*(s.co for s in states))))
    tel = None
    if states[0].tel is not None:
        rings = [s.tel for s in states]
        tel = obs_telemetry.TelemetryRing(
            [r.cursor for r in rings], [r.flushed for r in rings], stack(r.buf for r in rings),
            torch.tensor([r.cursor for r in rings], dtype=torch.int64,
                         device=rings[0].buf.device))
    return EngineState(
        beta=stack(s.beta for s in states),
        scale=stack(s.scale for s in states),
        co=co,
        maxabs=stack(s.maxabs for s in states),
        step_inf=stack(s.step_inf for s in states),
        stall=stack(s.stall for s in states),
        n_dots=[s.n_dots for s in states],
        k=[s.k for s in states],
        i_star=stack(s.i_star for s in states),
        rule=rule,
        tel=tel,
    )


def lane_state(state: EngineState, lane: int) -> EngineState:
    """Lane ``lane``'s one-lane ``EngineState`` of a lane-stacked one, for
    the one-lane code a rule runs a lane at a time: its row of ``beta`` (a
    view, so a step's in-place update lands in the stack) and copies of its
    co-state, scalars and rule state (operands of their own, as a
    sequential solve's are: on the CPU a row that does not start on a
    vector boundary may round otherwise in a vectorized op)."""
    def own(t):
        return t[lane].clone()

    rule = state.rule
    rule = own(rule) if isinstance(rule, torch.Tensor) else tuple(own(t) for t in rule)
    return EngineState(
        beta=state.beta[lane],
        scale=own(state.scale),
        co=type(state.co)(*(own(f) for f in state.co)),
        maxabs=own(state.maxabs),
        step_inf=own(state.step_inf),
        stall=own(state.stall),
        n_dots=state.n_dots[lane],
        k=state.k[lane],
        i_star=own(state.i_star),
        rule=rule,
        tel=None if state.tel is None else state.tel.lane(lane),
    )


def batched_step(oracle, Xt, y, stats, state: EngineState, cfg: FWConfig, deltas, sampler,
                 active, lanes: torch.Tensor, pre=None) -> EngineState:
    """One step of every lane in ``active`` (a host list of bools; ``lanes``
    the same as int32 device ids) from the lane-stacked ``state``: one draw,
    one scores launch, one argmax launch and one tail launch for all the
    lanes on the kernels' backends. Lanes not active keep their state bit
    for bit (the tail copies it; ``k`` and ``n_dots`` stay), and their
    ``i_star`` is -1. With telemetry on each active lane records its step
    in the same tail launch (its slot from its cursor on the device; a
    frozen lane records nothing). A step rule other than 'classic' runs
    its ``step_lanes`` (``pre``: what the rule's ``peek_lanes`` took before
    the turn's host read, and that read's facts)."""
    if cfg.step_rule != "classic":
        from repro_torch.core import step_rule  # lazy: the rules layer on top of the engine

        return step_rule.get_rule(cfg).step_lanes(oracle, Xt, y, stats, state, cfg, deltas,
                                                  sampler, active, lanes, pre)
    return classic_batched_step(oracle, Xt, y, stats, state, cfg, deltas, sampler, active, lanes)


def classic_batched_step(oracle, Xt, y, stats, state: EngineState, cfg: FWConfig, deltas,
                         sampler, active, lanes: torch.Tensor) -> EngineState:
    """``batched_step`` under the classic rule (the rules' inner step too:
    PARTAN's classic half-step, the lazy rule's tail reads its own)."""
    p = state.beta.shape[1]
    w = oracle.cograd(state.co, y)
    extra = oracle.score_extra(state.beta, state.scale, state.support)  # lane-stacked
    i_star, g_raw, g_sel, n_scored = vertex.sample_vertex_lanes(Xt, w, sampler, p, cfg, active,
                                                                lanes, extra)
    return batched_tail(oracle, Xt, y, stats, state, cfg, deltas, active, lanes, i_star, g_raw,
                        g_sel, n_scored + oracle.extra_dots)


def batched_tail(oracle, Xt, y, stats, state: EngineState, cfg: FWConfig, deltas, active,
                 lanes: torch.Tensor, i_star, g_raw, g_sel, per_step: int) -> EngineState:
    """The classic lane step after its vertices: the oracle's ``tail_lanes``
    on the winners ``i_star`` and their scores, each active lane's ring
    record in it (its n_dots ``per_step`` a step), and the new lane state,
    ``per_step`` dots added to each active lane's count."""
    tel, rec = state.tel, None
    if tel is not None:
        objective = cfg.telemetry.record_objective
        rec = TailRecord(tel.buf, tel.capacity, 0, 0, per_step, objective,
                         stats.yty if objective and stats is not None else None,
                         tel.cursor, tel.dev_cursor)
        tel = obs_telemetry.advance(tel, lanes=active)
    beta, scale, maxabs, step_inf, stall, co = oracle.tail_lanes(
        Xt, y, stats, state, i_star, g_raw, g_sel, deltas, cfg, active, lanes, tel=rec)
    return EngineState(
        beta=beta,
        scale=scale,
        co=co,
        maxabs=maxabs,
        step_inf=step_inf,
        stall=stall,
        n_dots=[n + (per_step if a else 0) for n, a in zip(state.n_dots, active)],
        k=[k + 1 if a else k for k, a in zip(state.k, active)],
        i_star=i_star,
        tel=tel,
        support=state.support,
    )


def batched_loop(oracle, Xt, y, stats, states0: EngineState, cfg: FWConfig, deltas, patience,
                 sampler, on_step=None):
    """The lane-pruned loop of ``solve_batched`` (the reference's
    ``batched_loop``): a lane steps while ``k < max_iters`` and ``stall <
    patience``; the host reads the ``(L,)`` stall vector once per turn. A
    turn is one batched step, or under ``cfg.fuse_steps = K > 1`` (with
    ``vertex.fused_supported``) K batched steps, each lane active at the
    turn's start stepping until its max_iters, as the reference's chunk of
    K unfused steps; so a lane's stops land where the sequential fused
    solve's do. A step rule's facts ride the turn's host read: a step that
    read the stall counts itself (PARTAN's ``stall_host``) hands them on,
    and the lazy rule's ``peek_lanes`` runs before the read, which reads its
    hits with the stall vector. ``on_step(state, active)``, when given,
    sees the state after every batched step and which lanes took it.
    Returns ``(final
    state, saved)``, ``saved`` the lane-iterations not run: the frozen
    lanes times the turn's length, summed over the turns."""
    chunk_len = cfg.fuse_steps if vertex.fused_supported(oracle, cfg) else 1
    L = len(states0.k)
    dev = states0.beta.device
    peek = None
    if cfg.step_rule != "classic":
        from repro_torch.core import step_rule  # lazy: the rules layer on top of the engine

        peek = getattr(step_rule.get_rule(cfg), "peek_lanes", None)
    live = [k < cfg.max_iters for k in states0.k]  # the lanes a peek looks at: last turn's
    state, saved = states0, 0
    while True:
        pre = None
        if state.stall_host is not None:  # the step's own host read (PARTAN's)
            stall = state.stall_host
        elif peek is not None and any(live):
            # the rule's facts (the lazy rule's hits) in the turn's one host read
            look = peek(oracle, Xt, y, stats, state, cfg, deltas, live, lane_ids(live, dev))
            host = torch.cat([state.stall, look.hit.to(state.stall.dtype)]).tolist()
            stall, pre = host[:L], (look, [bool(h) for h in host[L:]])
        else:
            stall = state.stall.tolist()  # the one host read a turn
        active = [k < cfg.max_iters and s < patience for k, s in zip(state.k, stall)]
        if not any(active):
            return state, saved
        live = active
        for _ in range(chunk_len):
            act = [a and k < cfg.max_iters for a, k in zip(active, state.k)]
            if not any(act):
                break
            state = batched_step(oracle, Xt, y, stats, state, cfg, deltas, sampler, act,
                                 lane_ids(act, dev), pre)
            if on_step is not None:
                on_step(state, act)
        saved += (L - sum(active)) * chunk_len


def batched_result(oracle, Xt, y, stats, final: EngineState, patience: int, cfg: FWConfig,
                   deltas) -> SolveResult:
    """The lane-stacked ``SolveResult``: ``alpha (L, p)``, objective, active
    and converged ``(L,)``, iterations and n_dots a host int a lane, and
    under ``cfg.report_gap`` each lane's certified gap (one full pass a
    lane)."""
    alpha = final.scale[:, None] * final.beta
    gap = None
    if cfg.report_gap:
        gap = torch.stack([
            certified_gap(oracle, Xt, y, type(final.co)(*(f[lane] for f in final.co)),
                          final.beta[lane], final.scale[lane], deltas[lane], cfg)
            for lane in range(alpha.shape[0])
        ])
    return SolveResult(
        alpha=alpha,
        objective=oracle.objective(y, stats, final.co, cfg),
        iterations=list(final.k),
        n_dots=list(final.n_dots),
        active=torch.sum(alpha != 0.0, dim=1),
        converged=final.stall >= patience,
        gap=gap,
        effective_fuse_steps=cfg.fuse_steps if vertex.fused_supported(oracle, cfg) else 1,
        # the lane ring (a leading lane axis on its storage), kept on the device
        telemetry=final.tel,
    )


def _solve_batched_prepared(oracle, Xt, y, cfg: FWConfig, sampler, alpha0s, deltas,
                            on_step=None, p: Optional[int] = None):
    """``solve_batched`` on operands that ``prepare_inputs`` already placed
    and checked; ``on_step`` as ``batched_loop``'s; ``p`` as
    ``_solve_prepared``'s."""
    _check_lane_oracle(oracle)
    deltas = torch.as_tensor(deltas).to(device=Xt.device, dtype=torch.float32).reshape(-1)
    L = deltas.shape[0]
    p = Xt.shape[0] if p is None else p
    if alpha0s is not None and tuple(alpha0s.shape) != (L, p):
        raise ValueError(f"alpha0s must be (lanes, p) = ({L}, {p}), got "
                         f"{tuple(alpha0s.shape)}")
    stats = precompute_colstats(Xt, y, cfg, p) if oracle.needs_stats else None
    states0 = stack_states([
        init_state(oracle, Xt, y, None if alpha0s is None else alpha0s[lane], cfg, p)
        for lane in range(L)
    ])
    states0 = states0._replace(support=vertex.lane_support(
        Xt, cfg, oracle.score_extra(states0.beta, states0.scale)))
    patience = _patience(cfg)
    final, saved = batched_loop(oracle, Xt, y, stats, states0, cfg, deltas, patience, sampler,
                                on_step)
    return batched_result(oracle, Xt, y, stats, final, patience, cfg, deltas), saved


def _solve_batched(oracle, Xt, y, cfg: FWConfig, sampler, alpha0s, deltas, *, device="cuda",
                   on_step=None):
    """Solve a batch of lanes (one delta, warm start and sampling stream
    each) in one loop with early exit per lane (the reference's
    ``solve_batched``). ``sampler`` is a lane sampler
    (``vertex.LaneSampler`` or ``vertex.LaneStreamSampler``), ``alpha0s``
    the ``(L, p)`` warm starts (None: all from zero), ``deltas`` the ``(L,)``
    deltas. Column statistics are computed once, then each lane is
    initialized from its warm start. Each lane's trajectory is the
    sequential ``solve`` on the same stream, bit for bit. Returns
    ``(SolveResult with lane-stacked fields, saved)``. Runs on the card
    unless ``device`` says otherwise."""
    Xt, y = prepare_inputs(Xt, y, cfg, device)
    if alpha0s is not None:
        alpha0s = torch.as_tensor(alpha0s, device=Xt.device)
    return _solve_batched_prepared(oracle, Xt, y, cfg, sampler, alpha0s, deltas, on_step)


# --------------------------------------------------------------------------
# The metrics plane's host shims (the reference's core/engine.py:813-927)
# --------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    """A result field on the host, as a flat float64 array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, np.float64).reshape(-1)


def _observe_solve(reg, entry: str, cfg: FWConfig, res: SolveResult, elapsed_s: float) -> None:
    """Fold one finished entry-point call into the metrics registry, on the
    host after the call's device work is done. Batched results count each
    lane in the totals; latency is per call (what the path driver
    amortizes). The reference's families, help strings and labels."""
    labels = dict(entry=entry, backend=cfg.backend, step_rule=cfg.step_rule)
    names = ("entry", "backend", "step_rule")
    iters = _host(res.iterations)
    lanes = iters.size
    reg.counter(
        "fw_solves",
        "solver entry-point completions (batched lanes count individually)",
        names,
    ).inc(lanes, **labels)
    reg.counter(
        "fw_iterations", "FW iterations consumed across all solves", names
    ).inc(float(iters.sum()), **labels)
    reg.counter(
        "fw_n_dots", "length-m dot products consumed (paper's cost unit)",
        names,
    ).inc(float(_host(res.n_dots).sum()), **labels)
    n_conv = int(_host(res.converged).sum())
    outcomes = reg.counter(
        "fw_lane_outcomes",
        "lane stop reason: §Stopping rule ('converged') vs max_iters",
        names + ("outcome",),
    )
    if n_conv:
        outcomes.inc(n_conv, outcome="converged", **labels)
    if lanes - n_conv:
        outcomes.inc(lanes - n_conv, outcome="max_iters", **labels)
    reg.histogram(
        "fw_solve_latency_seconds",
        "wall time per entry-point dispatch, host-observed to completion",
        names,
    ).observe(elapsed_s, **labels)
    eff = int(res.effective_fuse_steps)
    if cfg.fuse_steps > 1 and eff == 1:
        reg.counter(
            "fw_fused_fallback",
            "dispatches where fuse_steps>1 fell back to per-step loops "
            "(non-fusable oracle/sampling/rule)",
            names,
        ).inc(lanes, **labels)
    elif eff > 1:
        reg.counter(
            "fw_fused_chunks",
            "K-step fused chunks dispatched (lane-iterations / "
            "effective_fuse_steps)",
            names,
        ).inc(float(np.ceil(iters / eff).sum()), **labels)
    if res.gap is not None:
        gaps = _host(res.gap)
        gaps = np.abs(gaps[np.isfinite(gaps)])
        if gaps.size:
            hist = reg.histogram(
                "fw_certified_gap",
                "certified FW duality gap at the returned iterate "
                "(cfg.report_gap)",
                names,
                buckets=obs_metrics.GAP_BUCKETS,
            )
            for g in gaps:
                hist.observe(float(g), **labels)


def _sync() -> None:
    """Wait for the card's queued work (nothing to wait for without one)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _MetricsEntry:
    """Host shim over a solver entry point.

    With no registry installed (the default) this is a straight
    pass-through: the call's launches and host reads are untouched, which
    keeps the metrics-off contract as strong as the telemetry-off one.
    With a registry installed it times the call to completion (the card is
    synchronized before the clock is read on either side, since a call
    returns with its last launches queued) and folds totals, latency and
    gap into the registry."""

    def __init__(self, fn, entry: str):
        self._fn = fn
        self._entry = entry
        self.__name__ = fn.__name__.lstrip("_")
        self.__doc__ = fn.__doc__
        self.__wrapped__ = fn

    def __call__(self, oracle, Xt, y, cfg, *args, **kwargs):
        reg = obs_metrics.get_registry()
        if reg is None:
            return self._fn(oracle, Xt, y, cfg, *args, **kwargs)
        _sync()
        t0 = time.perf_counter()
        out = self._fn(oracle, Xt, y, cfg, *args, **kwargs)
        # solve returns a bare SolveResult; the history and batched entries
        # return (SolveResult, extra), and SolveResult is itself a tuple
        res = out if isinstance(out, SolveResult) else out[0]
        _sync()
        _observe_solve(reg, self._entry, cfg, res, time.perf_counter() - t0)
        return out

    def __getattr__(self, name):
        return getattr(self._fn, name)


solve = _MetricsEntry(_solve, "solve")
solve_prepared = _MetricsEntry(_solve_prepared, "solve")
solve_with_history = _MetricsEntry(_solve_with_history, "solve_with_history")
solve_batched = _MetricsEntry(_solve_batched, "solve_batched")
solve_batched_prepared = _MetricsEntry(_solve_batched_prepared, "solve_batched")
