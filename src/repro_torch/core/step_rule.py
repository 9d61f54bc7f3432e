"""Pluggable FW step rules (the reference's ``core/step_rule.py``).

``engine.rule_step`` hands each iteration to the rule ``FWConfig.step_rule``
names; the rule owns the direction (the classic FW vertex, an away vertex
from a tracked active set, a pairwise or PARTAN combination, or a lazily
re-scored cached winner), the step-size clip and the state it carries
between iterations, on ``EngineState.rule``.

Rule protocol::

    name: str              the registry key, FWConfig.step_rule
    fused_ok: bool         composes with the fused K-step chunk ('classic'
                           only; the others run the per-step loop, and
                           vertex.fused_supported warns once per rule)
    init_state(oracle, cfg, beta, co, y) -> the rule's state
    step(oracle, Xt, y, stats, state, cfg, delta, sampler) -> EngineState

The away and pairwise rules rest on one fact of the l1 ball: with atoms
{+-delta e_i} u {0}, the canonical decomposition of a feasible alpha puts
weight |alpha_i|/delta on the sign-matched atoms, and classic, away and
pairwise steps keep that form, so only a fixed-size buffer of active
indices is carried. ``g_max`` is recomputed from the live (beta, scale)
every step, so a stale buffer costs no feasibility, and zero-weight slots
are masked out of the away argmax. A step that reaches ``g_max`` on an
away direction is a drop step: the away coordinate is set to exactly 0.
The generalized direction (``kernels/step_tail``'s ``dir_line_search`` and
``dir_update_co`` on the lasso and the elastic-net, the logistic oracle's
methods of those names):

    alpha(g) = (1 + g t) alpha + g (df e_f + da e_a),  g in [0, g_max]

    classic FW:  t = -1, df = delta_t, da = 0,              g_max = 1
    away:        t = +1, df = 0,       da = -sigma_a delta, g_max = w_a/(1-w_a)
    pairwise:    t =  0, df = delta_t, da = -sigma_a delta, g_max = w_a

On the lasso and the elastic-net everything after the FW vertex and the
buffer's linear scores is the oracle's ``dir_tail`` (``kernels/step_tail``'s
direction tail: one launch on the kernels' backends, so a step there is the
draw, K2's scores and argmax, K2 or K5 at width 1 on the buffer, and the
tail); on the logistic it is ``DirRule._protocol_step``, plain ops.

PARTAN (arxiv 1502.01563) runs a classic step to alpha_mid, then moves
along alpha_mid - alpha_prev with mu in [0, mu_max]; its drift odometer
rebuilds the co-state from an exact matvec when the recursion's f32 error
could have grown past ``PARTAN_DRIFT_LIMIT``. The lazy rule (arxiv
1803.07348's cache and threshold, over the sampled oracle) re-scores a small
ring of recent winners first; a cached vertex whose directional gap beats
phi skips the fresh draw.

The port differs from the reference where its tensors do: ``beta`` is
updated in place by the classic step, so PARTAN copies its anchor first;
the buffer and the cache are int64 (the port's index type); and a rule's
host facts are read on the host: PARTAN's refresh with the stall count in
the step's one host read (``EngineState.stall_host``), so its matvec runs
only when it is due, and the lazy rule's hit before the draw, so a hit
skips the draw's kernels.

Lanes (``step_lanes``, the batched engine's, under the reference's vmap of
``rule_step``): each rule steps L delta lanes from the lane-stacked state
(``engine.stack_states`` stacks the rule's state), every lane the
sequential step on its stream, bit for bit. Away and pairwise on the lasso
and the elastic-net: the lanes' draw, one lane scores launch on the
buffers (``vertex.score_indices_lanes``) and one lane direction tail
(``kernels/step_tail.dir_tail_lanes``); on the logistic the one-lane
``_protocol_step`` a stepping lane. PARTAN: the classic lane step, then
its O(p) algebra a lane (plain ops on the lane's rows, its reductions
summed as the sequential step sums them), the lanes' refresh flags read
with the stall vector in the step's one host read. Lazy: ``peek_lanes``
scores every lane's cache (one lane scores launch) before the turn's host
read, which reads the hits with the stall vector; the misses draw in one
lane draw, a hit lane's stream skips its row (``skip(lanes)``), and the
classic lane tail steps every lane.

Telemetry (the reference's ``core/step_rule.py:325-352, 457-470,
573-587``): an away or pairwise step writes its record with the plain
``record`` after its tail (its event, away, pairwise or drop, from the
choice recomputed with the plain ops from the state before the step, and
the classic sampled gap); PARTAN amends the record its classic half-step
wrote (``amend_last``: the event, the final step_inf, stall and n_dots,
and the objective), so there is one record an iteration; the lazy rule's
classic tail writes its record, and a hit amends its event to
``EVENT_LAZY_HIT``, with the lazy rule's gap ``<grad, alpha> + delta
|g_sel|``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import engine, vertex
from repro_torch.core.engine import EngineState
from repro_torch.core.solver_config import FWConfig
from repro_torch.obs import telemetry as obs_telemetry
from repro_torch.kernels.step_tail import (  # noqa: F401 (the protocol's pieces, re-exported)
    DirStep,
    apply_dir_update,
    away_vertex,
    dir_choice,
    insert_active,
)

# per-step O(m) surcharge of the generalized-direction rules (two columns
# and the dots on u), in length-m dot units for n_dots
DIR_EXTRA_DOTS = 5
# PARTAN's surcharge: the extrapolation dots and the exact S/F recompute
PARTAN_EXTRA_DOTS = 4
# PARTAN's extrapolation cap: the line search runs on [0, MU_CAP], and its
# result is kept only while ||a_mid + mu dp||_1 stays inside the ball
PARTAN_MU_CAP = 8.0
# PARTAN's drift odometer limit: each extrapolation amplifies the recursion's
# f32 error by about (1 + 2 mu); past this product the co-state is rebuilt
PARTAN_DRIFT_LIMIT = 1024.0


def init_active_set(beta, cfg: FWConfig) -> torch.Tensor:
    """The ``(active_set_size,)`` int64 buffer: the largest-|beta| coordinates
    of a warm start, -1 (empty) elsewhere (the reference's
    ``core/step_rule.py:161-173``). ``jax.lax.top_k`` puts larger values
    first and breaks ties by the lower index; ``torch.topk`` promises no
    order, so a stable descending sort stands in for it."""
    cap = cfg.active_set_size
    k_eff = min(cap, beta.shape[0])
    mag = torch.abs(beta)
    idx = torch.sort(mag, descending=True, stable=True).indices[:k_eff]
    idx = torch.where(mag.index_select(0, idx) > 0, idx, -1)
    if k_eff < cap:
        idx = torch.cat([idx, torch.full((cap - k_eff,), -1, dtype=idx.dtype,
                                         device=idx.device)])
    return idx


def _select_away(oracle, Xt, w, buf, beta, scale, delta, p, cfg):
    """The away vertex over the active set (the reference's
    ``core/step_rule.py:190-205``): the buffer's scores
    (``vertex.score_indices``), then ``away_vertex``. Returns ``(i_a,
    sel_a, a_a, sigma_a, any_valid)``."""
    extra_fn = oracle.score_extra(beta, scale)
    _, sel_b = vertex.score_indices(Xt, w, buf, p, cfg, extra_fn)
    return away_vertex(sel_b, buf, beta, scale, p)


@dataclasses.dataclass(frozen=True)
class ClassicRule:
    """The paper's Algorithm-2 step: ``engine.step`` itself."""

    name = "classic"
    fused_ok = True

    def init_state(self, oracle, cfg, beta, co, y):
        return ()

    def step(self, oracle, Xt, y, stats, state, cfg, delta, sampler) -> EngineState:
        return engine.step(oracle, Xt, y, stats, state, cfg, delta, sampler)

    def step_lanes(self, oracle, Xt, y, stats, state, cfg, deltas, sampler, active, lanes,
                   pre=None) -> EngineState:
        return engine.classic_batched_step(oracle, Xt, y, stats, state, cfg, deltas, sampler,
                                           active, lanes)


def _run(active) -> list:
    """The ids of the lanes that step."""
    return [lane for lane, a in enumerate(active) if a]


def _lane_co(co, lane: int):
    """Lane ``lane``'s co-state of a lane-stacked one, as copies."""
    return type(co)(*(f[lane].clone() for f in co))


@dataclasses.dataclass(frozen=True)
class DirRule:
    """Away steps (``pairwise=False``) or pairwise steps (``pairwise=True``)
    over the sampled oracle (the reference's ``core/step_rule.py:228-375``).
    Rule state: the active-set buffer."""

    pairwise: bool

    fused_ok = False

    @property
    def name(self):
        return "pairwise" if self.pairwise else "away"

    def init_state(self, oracle, cfg, beta, co, y):
        return init_active_set(beta, cfg)

    def step(self, oracle, Xt, y, stats, state: EngineState, cfg: FWConfig, delta,
             sampler) -> EngineState:
        p = state.beta.shape[0]
        buf = state.rule
        dtype = state.beta.dtype
        w = oracle.cograd(state.co, y)
        extra_fn = oracle.score_extra(state.beta, state.scale)
        i_f, _, sel_f, n_scored = vertex.sample_vertex(Xt, w, sampler, p, cfg, extra_fn)
        if hasattr(oracle, "dir_tail"):
            # the lasso and the EN: the buffer's linear scores, then one tail
            raw_b, _ = vertex.score_indices(Xt, w, buf, p, cfg)
            raw_b = raw_b.float()  # the tail's f32 scores (a bf16 sparse design's cast back)
            choice = None
            if state.tel is not None:
                sel_b = raw_b if extra_fn is None else raw_b.float() + extra_fn(buf.clamp(0, p - 1))
                choice = self._choice(oracle, y, stats, state, sel_b, buf, i_f, sel_f, delta, p,
                                      cfg)
            out, co = oracle.dir_tail(Xt, y, stats, state, buf, raw_b, i_f, sel_f, delta,
                                      self.pairwise, cfg)
            beta, scale, maxabs, step_inf, stall = out[:5]
            buf, i_star, g = out.buf, out.i_star, out.g
        else:
            beta, scale, maxabs, step_inf, stall, co, buf, i_star, g, choice = (
                self._protocol_step(oracle, Xt, y, stats, state, w, i_f, sel_f, delta, p, cfg))
            scale, maxabs, step_inf = (t.to(dtype) for t in (scale, maxabs, step_inf))
        n_dots = state.n_dots + n_scored + buf.shape[0] + DIR_EXTRA_DOTS + oracle.extra_dots
        tel = state.tel
        if tel is not None:
            tel = self._record(tel, oracle, y, stats, state.k, choice, sel_f, delta, co, i_star,
                               g, step_inf, stall, n_dots, cfg)
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
            rule=buf,
            tel=tel,
        )

    def step_lanes(self, oracle, Xt, y, stats, state: EngineState, cfg: FWConfig, deltas,
                   sampler, active, lanes, pre=None) -> EngineState:
        """``step`` for L lanes: the lanes' draw, then on the lasso and the
        elastic-net one lane scores launch on the buffers and one lane
        direction tail (the oracle's ``dir_tail_lanes``), on the logistic
        ``_protocol_step`` a stepping lane; each stepping lane's plain
        record. A frozen lane keeps its state, its vertex -1."""
        p = state.beta.shape[1]
        buf = state.rule
        run = _run(active)
        w = oracle.cograd(state.co, y)
        extra = oracle.score_extra(state.beta, state.scale, state.support)
        i_f, _, sel_f, n_scored = vertex.sample_vertex_lanes(Xt, w, sampler, p, cfg, active,
                                                             lanes, extra)
        tel = state.tel
        if hasattr(oracle, "dir_tail_lanes"):
            raw_b = vertex.score_indices_lanes(Xt, w, buf, p, cfg, active, lanes)[0]
            raw_b = raw_b.float().contiguous()
            choices = {}
            if tel is not None:
                for lane in run:
                    ls = engine.lane_state(state, lane)
                    sel_b = raw_b[lane] if extra is None else raw_b[lane] + extra.lane(lane)(
                        ls.rule.clamp(0, p - 1))
                    choices[lane] = self._choice(oracle, y, stats, ls, sel_b, ls.rule, i_f[lane],
                                                 sel_f[lane], deltas[lane], p, cfg)
            out, co = oracle.dir_tail_lanes(Xt, y, stats, state, buf, raw_b, i_f, sel_f, deltas,
                                            self.pairwise, cfg, active, lanes)
            beta, scale, maxabs, step_inf, stall = out[:5]
            buf, i_star, g = out.buf, out.i_star, out.g
        else:
            beta, scale, maxabs, step_inf, stall, co, buf, i_star, g, choices = (
                self._protocol_lanes(oracle, Xt, y, stats, state, w, i_f, sel_f, deltas, p, cfg,
                                     run))
        per = n_scored + buf.shape[1] + DIR_EXTRA_DOTS + oracle.extra_dots
        n_dots = [n + per if a else n for n, a in zip(state.n_dots, active)]
        if tel is not None:
            for lane in run:
                tel = self._record(tel, oracle, y, stats, state.k[lane], choices[lane],
                                   sel_f[lane], deltas[lane], _lane_co(co, lane), i_star[lane],
                                   g[lane], step_inf[lane], stall[lane], n_dots[lane], cfg,
                                   lane=lane)
        return EngineState(
            beta=beta,
            scale=scale,
            co=co,
            maxabs=maxabs,
            step_inf=step_inf,
            stall=stall,
            n_dots=n_dots,
            k=[k + 1 if a else k for k, a in zip(state.k, active)],
            i_star=i_star,
            rule=buf,
            tel=tel,
            support=state.support,
        )

    def _protocol_lanes(self, oracle, Xt, y, stats, state, w, i_f, sel_f, deltas, p, cfg, run):
        """``_protocol_step`` once per stepping lane, on its one-lane state
        (``engine.lane_state``: its row of beta updated in place); a frozen
        lane keeps its state, its vertex -1 and its g 0. Returns the lanes'
        state fields, step sizes and choices (a dict by lane)."""
        dtype = state.beta.dtype
        scale, maxabs, step_inf, stall = (t.clone() for t in (
            state.scale, state.maxabs, state.step_inf, state.stall))
        co = [f.clone() for f in state.co]
        buf = state.rule.clone()
        i_star = torch.full_like(i_f, -1)
        g = torch.zeros(i_f.shape, dtype=torch.float32, device=i_f.device)
        choices = {}
        for lane in run:
            ls = engine.lane_state(state, lane)
            got = self._protocol_step(oracle, Xt, y, stats, ls, w[lane].clone(),
                                      i_f[lane].clone(), sel_f[lane].clone(),
                                      deltas[lane].clone(), p, cfg)
            _, sc, mx, si, st, co_l, buf_l, i_l, g_l, choices[lane] = got
            scale[lane], maxabs[lane], step_inf[lane] = (t.to(dtype) for t in (sc, mx, si))
            stall[lane], buf[lane], i_star[lane], g[lane] = st, buf_l, i_l, g_l
            for f, v in zip(co, co_l):
                f[lane] = v
        return (state.beta, scale, maxabs, step_inf, stall, type(state.co)(*co), buf, i_star, g,
                choices)

    def _choice(self, oracle, y, stats, state, sel_b, buf, i_f, sel_f, delta, p, cfg):
        """The away-or-FW choice from the state before the step, with the
        plain ops (the record's event and gap need it; the direction tail
        makes the same choice inside its launch). Returns ``(ds, use_alt,
        ga)``."""
        away = away_vertex(sel_b, buf, state.beta, state.scale, p)
        ga = oracle.grad_dot_alpha(state.co, stats, y, state.beta, state.scale, cfg).float()
        a_f = state.scale.float() * vertex.take(state.beta, i_f).float()
        ds, use_alt = dir_choice(sel_f.float(), a_f, i_f, away, delta,
                                 None if self.pairwise else ga, self.pairwise, cfg.eps_den)
        return ds, use_alt, ga

    def _record(self, tel, oracle, y, stats, k, choice, sel_f, delta, co, i_star, g,
                step_inf, stall, n_dots, cfg, lane=None):
        """The step's plain ring record (iteration ``k``; of lane ``lane`` of
        a lane ring): a drop step (the away atom at g_max) is
        ``EVENT_DROP``, another away or pairwise direction ``EVENT_AWAY`` or
        ``EVENT_PAIRWISE``, else ``EVENT_FW``; the gap is the classic
        sampled FW gap ``<grad, alpha> - delta_t sel_f``, the rules' common
        yardstick."""
        ds, use_alt, ga = choice
        drop = (ds.da != 0.0) & (g >= ds.g_max) & (ds.same == 0.0)
        alt = obs_telemetry.EVENT_PAIRWISE if self.pairwise else obs_telemetry.EVENT_AWAY
        event = torch.where(drop, obs_telemetry.EVENT_DROP,
                            torch.where(use_alt, alt, obs_telemetry.EVENT_FW))
        gap = objective = float("nan")
        if cfg.telemetry.record_objective:
            df_fw = -delta * torch.sign(sel_f.float())
            gap = ga - df_fw * sel_f.float()
            objective = oracle.objective(y, stats, co, cfg)
        return obs_telemetry.record(tel, lane=lane, k=k, i_star=i_star, event=event, lam=g,
                                    gap=gap, objective=objective, step_inf=step_inf, stall=stall,
                                    n_dots=n_dots)

    def _protocol_step(self, oracle, Xt, y, stats, state, w, i_f, sel_f, delta, p, cfg):
        """The step after the FW vertex through the oracle's
        ``dir_line_search`` and ``dir_update_co`` (the reference's op
        sequence, plain PyTorch): an oracle without a ``dir_tail``, the
        logistic. Returns the step's state fields, its step size ``g`` and
        its choice ``(ds, use_alt, ga)`` (``ga`` None for pairwise without
        telemetry)."""
        buf = state.rule
        away = _select_away(oracle, Xt, w, buf, state.beta, state.scale, delta, p, cfg)
        ga = None
        if not self.pairwise or state.tel is not None:
            ga = oracle.grad_dot_alpha(state.co, stats, y, state.beta, state.scale, cfg).float()
        a_f = state.scale.float() * vertex.take(state.beta, i_f).float()
        ds, use_alt = dir_choice(sel_f.float(), a_f, i_f, away, delta,
                                 None if self.pairwise else ga, self.pairwise, cfg.eps_den)
        # the direction's image X d = t (X alpha) + u_lin, u_lin = df z_f + da z_a
        z = vertex.columns_dense(Xt, torch.stack([i_f, ds.i_a]), cfg).float()
        u_lin = ds.df * z[0] + ds.da * z[1]
        g, no_progress, aux = oracle.dir_line_search(y, stats, state.co, ds, u_lin, cfg)
        beta, scale, maxabs, step_inf, stall = apply_dir_update(
            state.beta, state.scale, state.maxabs, state.stall, ds, g, no_progress, cfg)
        co = oracle.dir_update_co(Xt, y, stats, state.co, beta, scale, ds, g, u_lin, state.k,
                                  cfg, aux)
        # the FW atom enters the active set whenever it gained weight
        took_fw = (ds.df != 0.0) & (g > 0.0)
        buf = torch.where(took_fw, insert_active(buf, i_f, beta), buf)
        return (beta, scale, maxabs, step_inf, stall, co, buf,
                torch.where(use_alt, ds.i_a, i_f), g, (ds, use_alt, ga))


@dataclasses.dataclass(frozen=True)
class PartanRule:
    """PARTAN: a classic step to alpha_mid, then an extrapolation along
    alpha_mid - alpha_prev (the reference's ``core/step_rule.py:378-483``).
    Rule state: (alpha_prev, X alpha_prev, the drift odometer). O(p) a step
    by construction: the extrapolation touches every coordinate."""

    name = "partan"
    fused_ok = False

    def init_state(self, oracle, cfg, beta, co, y):
        return (beta, oracle.co_linpred(co, y),
                torch.zeros((), dtype=torch.float32, device=beta.device))

    @staticmethod
    def choose_mu(mu_opt, mu_cons, l1_try, delta):
        """``mu_opt`` while its iterate stays in the ball (to a 1e-6 slack),
        else the bound ``mu_cons``; any mu in [0, mu_opt] still descends (a
        convex line objective)."""
        return torch.where(l1_try <= delta * (1.0 + 1e-6), mu_opt, torch.minimum(mu_opt, mu_cons))

    @staticmethod
    def odometer(drift, mu):
        """The drift odometer after a step of ``mu``: (1 + 2|mu|) drift + 1."""
        return (1.0 + 2.0 * torch.abs(mu).float()) * drift + 1.0

    def step(self, oracle, Xt, y, stats, state: EngineState, cfg: FWConfig, delta,
             sampler) -> EngineState:
        a_prev, v_prev, drift = state.rule
        # the classic half-step updates state.beta in place, which the anchor
        # may be: copy both values first (the reference holds them as values)
        a_prev = a_prev.clone()
        alpha_old = state.scale * state.beta
        mid = engine.step(oracle, Xt, y, stats, state, cfg, delta, sampler)
        ext = self._extrapolate(oracle, y, stats, mid, state.stall, a_prev, v_prev, drift,
                                alpha_old, delta, cfg)
        # the step's one host read: the stall count and whether to rebuild
        stall_host, refresh_host = torch.stack([ext.stall, ext.refresh.int()]).tolist()
        co, drift, v_new, n_dots = self._finish(oracle, Xt, y, ext, refresh_host, mid.n_dots,
                                                cfg)
        tel = mid.tel
        if tel is not None:
            tel = self._amend(tel, oracle, y, stats, ext, co, n_dots, cfg)
        return EngineState(
            beta=ext.a_new,
            scale=torch.ones((), dtype=ext.a_new.dtype, device=ext.a_new.device),
            co=co,
            maxabs=torch.max(torch.abs(ext.a_new)),
            step_inf=ext.step_inf,
            stall=ext.stall,
            n_dots=n_dots,
            k=mid.k,
            i_star=mid.i_star,
            rule=(ext.a_new, v_new, drift),
            stall_host=stall_host,
            tel=tel,
        )

    def step_lanes(self, oracle, Xt, y, stats, state: EngineState, cfg: FWConfig, deltas,
                   sampler, active, lanes, pre=None) -> EngineState:
        """``step`` for L lanes: the classic lane step, then each stepping
        lane's extrapolation with the one-lane ops on its rows, the lanes'
        stall counts and refresh flags in one host read (handed to the loop
        as ``stall_host``), each due lane's rebuild, and PARTAN's amend of
        each lane's record. A frozen lane keeps its state and anchor."""
        a_prev, v_prev, drift = state.rule
        run = _run(active)
        before = {lane: (a_prev[lane].clone(), v_prev[lane].clone(), drift[lane].clone(),
                         state.scale[lane] * state.beta[lane], state.stall[lane].clone())
                  for lane in run}
        mid = engine.classic_batched_step(oracle, Xt, y, stats, state, cfg, deltas, sampler,
                                          active, lanes)
        exts = {}
        for lane in run:
            a_p, v_p, d_p, alpha_old, stall0 = before[lane]
            exts[lane] = self._extrapolate(oracle, y, stats, engine.lane_state(mid, lane), stall0,
                                           a_p, v_p, d_p, alpha_old, deltas[lane], cfg)
        stall = mid.stall.clone()
        for lane in run:
            stall[lane] = exts[lane].stall
        flags = torch.stack([exts[lane].refresh for lane in run]).to(stall.dtype)
        host = torch.cat([stall, flags]).tolist()  # the step's one host read
        L = len(active)
        stall_host, refresh_host = host[:L], dict(zip(run, host[L:]))
        fields = [[t[lane] for lane in range(L)] for t in (
            mid.beta, mid.scale, mid.maxabs, mid.step_inf, v_prev, drift)]
        co = [[f[lane] for lane in range(L)] for f in mid.co]
        n_dots, tel = list(mid.n_dots), mid.tel
        for lane in run:
            ext = exts[lane]
            co_l, drift_l, v_new, n_dots[lane] = self._finish(oracle, Xt, y, ext,
                                                              refresh_host[lane],
                                                              mid.n_dots[lane], cfg)
            a_new = ext.a_new
            for f, v in zip(fields, (a_new, torch.ones((), dtype=a_new.dtype,
                                                        device=a_new.device),
                                     torch.max(torch.abs(a_new)), ext.step_inf, v_new, drift_l)):
                f[lane] = v
            for f, v in zip(co, co_l):
                f[lane] = v
            if tel is not None:
                tel = self._amend(tel, oracle, y, stats, ext, co_l, n_dots[lane], cfg, lane)
        beta, scale, maxabs, step_inf, v_new, drift = (torch.stack(f) for f in fields)
        return EngineState(
            beta=beta,
            scale=scale,
            co=type(mid.co)(*(torch.stack(f) for f in co)),
            maxabs=maxabs,
            step_inf=step_inf,
            stall=stall,
            n_dots=n_dots,
            k=mid.k,
            i_star=mid.i_star,
            rule=(beta, v_new, drift),
            stall_host=stall_host,
            tel=tel,
            support=mid.support,
        )

    def _extrapolate(self, oracle, y, stats, mid, stall0, a_prev, v_prev, drift, alpha_old, delta,
                     cfg) -> "PartanExt":
        """The extrapolation from the classic half-step's state ``mid`` (the
        state before it had stall ``stall0`` and alpha ``alpha_old``), before
        the refresh decision is read on the host."""
        no_prog_mid = mid.stall > stall0

        a_mid = mid.scale * mid.beta
        v_mid = oracle.co_linpred(mid.co, y)
        dp = a_mid - a_prev
        u_m = v_mid - v_prev  # X dp
        # the line search on [0, MU_CAP] first; when the l1 check fails, the
        # triangle-inequality bound mu <= (delta - |a_mid|) / (|a_mid| + |a_prev|)
        mu_opt = oracle.partan_mu(y, stats, mid.co, u_m, a_mid, dp, PARTAN_MU_CAP, cfg)
        s_mid = torch.sum(torch.abs(a_mid))
        s_prev = torch.sum(torch.abs(a_prev))
        l1_try = torch.sum(torch.abs(a_mid + mu_opt * dp))
        mu_cons = (torch.clamp_min(delta - s_mid, 0.0)
                   / torch.clamp_min(s_mid + s_prev, cfg.eps_den))
        mu = self.choose_mu(mu_opt, mu_cons, l1_try, delta)
        a_new = a_mid + mu * dp
        co = oracle.partan_update_co(y, stats, mid.co, a_new, mu, u_m, cfg)
        drift = self.odometer(drift, mu)
        refresh = drift > PARTAN_DRIFT_LIMIT
        # exact stopping statistics: PARTAN is O(p) anyway
        step_inf = torch.max(torch.abs(a_new - alpha_old))
        stall = torch.where((step_inf <= cfg.tol) | no_prog_mid, stall0 + 1, 0)
        return PartanExt(a_new, co, drift, refresh, step_inf, stall)

    @staticmethod
    def _finish(oracle, Xt, y, ext: "PartanExt", refresh_host, n_dots_mid: int, cfg):
        """After the host read: the co-state rebuilt from an exact matvec when
        the odometer asked (``refresh_host``), the anchor's image, and the
        dot count. Returns ``(co, drift, v_new, n_dots)``."""
        co, drift, a_new = ext.co, ext.drift, ext.a_new
        if refresh_host:
            co = oracle.init_co(y, vertex.matvec(Xt, a_new, cfg), a_new, a_new.dtype, cfg)
            drift = torch.zeros_like(drift)
        # the outer iterate anchors the next step, its image read through the
        # (rebuilt) co-state
        v_new = oracle.co_linpred(co, y)
        n_dots = n_dots_mid + PARTAN_EXTRA_DOTS + (a_new.shape[0] if refresh_host else 0)
        return co, drift, v_new, n_dots

    @staticmethod
    def _amend(tel, oracle, y, stats, ext: "PartanExt", co, n_dots: int, cfg, lane=None):
        """The classic half-step recorded this iteration; amend that record
        in place with the extrapolated step's statistics (one record an
        iteration; of lane ``lane`` of a lane ring); the gap stays the
        half-step's sampled FW gap."""
        fields = dict(event=obs_telemetry.EVENT_PARTAN, step_inf=ext.step_inf, stall=ext.stall,
                      n_dots=n_dots)
        if cfg.telemetry.record_objective:
            fields["objective"] = oracle.objective(y, stats, co, cfg)
        return obs_telemetry.amend_last(tel, lane=lane, **fields)


class PartanExt(NamedTuple):
    """PARTAN's extrapolated step before its refresh decision is read: the
    new iterate, its co-state, the odometer, whether it asks for a rebuild
    (a 0-d device bool), the exact step_inf and the stall count."""

    a_new: torch.Tensor
    co: Any
    drift: torch.Tensor
    refresh: torch.Tensor
    step_inf: torch.Tensor
    stall: torch.Tensor


class LazyPeek(NamedTuple):
    """A lazy step's cache scores, taken before its draw: the co-gradient,
    <grad, alpha>, the cache's linear and selected scores, the best slot
    ``j`` and whether it is a hit (a 0-d device bool)."""

    w: torch.Tensor
    ga: torch.Tensor
    raw_c: torch.Tensor
    sel_c: torch.Tensor
    j: torch.Tensor
    hit: torch.Tensor


@dataclasses.dataclass(frozen=True)
class LazyRule:
    """The lazy LMO around the classic step (the reference's
    ``core/step_rule.py:486-610``): re-score a ring of recent winners first;
    a cached vertex whose directional FW gap ``<grad, alpha> + delta |sel|``
    reaches the threshold phi skips the fresh draw (its kernels and its
    kappa dots, visible in ``n_dots``). Rule state: (the cache's indices,
    phi). The hit is read on the host before the draw, a read of its own
    beside the loop's stall read."""

    name = "lazy"
    fused_ok = False

    def init_state(self, oracle, cfg, beta, co, y):
        return (torch.full((cfg.lazy_cache,), -1, dtype=torch.int64, device=beta.device),
                torch.full((), float("inf"), dtype=torch.float32, device=beta.device))

    @staticmethod
    def phi_update(phi, gap):
        """The threshold after a fresh draw of directional gap ``gap``: the
        first seeds phi at half its gap; a later one that misses phi halves
        it (Braun et al.'s update)."""
        return torch.where(torch.isinf(phi), 0.5 * gap, torch.where(gap < phi, 0.5 * phi, phi))

    @staticmethod
    def _peek(oracle, Xt, y, stats, beta, scale, co, cache, phi, delta, p, cfg) -> LazyPeek:
        w = oracle.cograd(co, y)
        extra_fn = oracle.score_extra(beta, scale)
        ga = oracle.grad_dot_alpha(co, stats, y, beta, scale, cfg)
        raw_c, sel_c = vertex.score_indices(Xt, w, cache, p, cfg, extra_fn)
        # the directional FW gap of vertex -delta sign(sel) e_i, the currency
        gap_c = torch.where(cache >= 0, ga.float() + delta * torch.abs(sel_c.float()),
                            float("-inf"))
        j = torch.argmax(gap_c).view(1)
        hit = gap_c.index_select(0, j).view(()) >= phi
        return LazyPeek(w, ga, raw_c, sel_c, j, hit)

    def step(self, oracle, Xt, y, stats, state: EngineState, cfg: FWConfig, delta,
             sampler) -> EngineState:
        p = state.beta.shape[0]
        cache, phi = state.rule
        cap = cache.shape[0]
        peek = self._peek(oracle, Xt, y, stats, state.beta, state.scale, state.co, cache, phi,
                          delta, p, cfg)
        hit = bool(peek.hit)
        if hit:
            sampler.skip()  # the step's row of the stream goes unused
            i_star = vertex.take(cache.clamp(0, p - 1), peek.j)
            g_raw, g_sel = vertex.take(peek.raw_c, peek.j), vertex.take(peek.sel_c, peek.j)
            n_scored, phi_new, cache_new = cap, phi, cache
        else:
            extra_fn = oracle.score_extra(state.beta, state.scale)
            i_star, g_raw, g_sel, ns = vertex.sample_vertex(Xt, peek.w, sampler, p, cfg, extra_fn)
            phi_new = self.phi_update(phi, peek.ga.float() + delta * torch.abs(g_sel.float()))
            cache_new = cache.clone()
            cache_new[state.k % cap] = i_star
            n_scored = cap + ns
        # the classic tail on the chosen vertex, which writes the step's record
        n_dots = state.n_dots + n_scored + 1 + oracle.extra_dots
        rec = engine.tail_record(state, stats, n_dots, cfg)
        beta, scale, maxabs, step_inf, stall, co = oracle.tail(
            Xt, y, stats, state, i_star, g_raw, g_sel, delta, cfg, tel=rec)
        tel = None
        if rec is not None:
            # the lazy rule's gap, its acceptance currency (recorded with the
            # objective on or off, as the reference's), and a hit's event
            fields = dict(gap=peek.ga.float() + delta * torch.abs(g_sel.float()))
            if hit:
                fields["event"] = obs_telemetry.EVENT_LAZY_HIT
            tel = obs_telemetry.amend_last(obs_telemetry.advance(state.tel), **fields)
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
            rule=(cache_new, phi_new),
            tel=tel,
        )

    def peek_lanes(self, oracle, Xt, y, stats, state: EngineState, cfg: FWConfig, deltas, active,
                   lanes) -> LazyPeek:
        """``_peek`` for L lanes, taken before the turn's host read (which
        reads its hits with the stall vector): the lanes' co-gradients,
        <grad, alpha> a lane, one lane scores launch on the caches of the
        lanes in ``active`` (``lanes`` their int32 device ids), the gaps and
        the threshold test as plain ops on ``(L, cache)``. Returns a
        lane-stacked ``LazyPeek`` (``j`` and ``hit`` ``(L,)``)."""
        p = state.beta.shape[1]
        cache, phi = state.rule
        w = oracle.cograd(state.co, y)
        extra = oracle.score_extra(state.beta, state.scale)
        ga = oracle.grad_dot_alpha(state.co, stats, y, state.beta, state.scale, cfg)
        raw_c, sel_c = vertex.score_indices_lanes(Xt, w, cache, p, cfg, active, lanes, extra)
        gap_c = torch.where(cache >= 0,
                            ga.float()[:, None] + deltas[:, None] * torch.abs(sel_c.float()),
                            float("-inf"))
        j = torch.argmax(gap_c, dim=1)
        hit = gap_c.gather(1, j[:, None]).view(-1) >= phi
        return LazyPeek(w, ga, raw_c, sel_c, j, hit)

    def step_lanes(self, oracle, Xt, y, stats, state: EngineState, cfg: FWConfig, deltas,
                   sampler, active, lanes, pre=None) -> EngineState:
        """``step`` for L lanes from ``pre``, the turn's ``peek_lanes`` and
        its hits as the host read them: a hit lane takes its cached winner
        and skips its stream's row, the misses draw in one lane draw (their
        threshold and cache updated a lane), and the classic lane tail steps
        every lane, each record amended with the lazy gap, its dot count and
        a hit's event. A frozen lane keeps its state, its vertex -1."""
        peek, hits = pre
        L, p = state.beta.shape
        dev = state.beta.device
        cache, phi = state.rule
        cap = cache.shape[1]
        hit = [a and h for a, h in zip(active, hits)]
        miss = [a and not h for a, h in zip(active, hits)]
        sampler.skip(hit)
        ns = 0
        i_d = torch.full((L,), -1, dtype=torch.int64, device=dev)
        g_raw_d = g_sel_d = torch.zeros(L, dtype=torch.float32, device=dev)
        if any(miss):
            extra = oracle.score_extra(state.beta, state.scale, state.support)
            i_d, g_raw_d, g_sel_d, ns = vertex.sample_vertex_lanes(
                Xt, peek.w, sampler, p, cfg, miss, engine.lane_ids(miss, dev), extra)
        j = peek.j[:, None]
        i_star = torch.where(peek.hit, cache.clamp(0, p - 1).gather(1, j).view(-1), i_d)
        g_raw = torch.where(peek.hit, peek.raw_c.gather(1, j).view(-1).float(), g_raw_d.float())
        g_sel = torch.where(peek.hit, peek.sel_c.gather(1, j).view(-1).float(), g_sel_d.float())
        gap = peek.ga.float() + deltas * torch.abs(g_sel)
        phi_miss = self.phi_update(phi, gap)
        phi_new, cache_new = phi.clone(), cache.clone()
        for lane in _run(miss):
            phi_new[lane] = phi_miss[lane]
            cache_new[lane, state.k[lane] % cap] = i_star[lane]
        out = engine.batched_tail(oracle, Xt, y, stats, state, cfg, deltas, active, lanes, i_star,
                                  g_raw, g_sel, cap + 1 + oracle.extra_dots)
        n_dots = [n + (ns if m else 0) for n, m in zip(out.n_dots, miss)]
        tel = out.tel
        if tel is not None:
            # the lazy rule's gap, its dot count and a hit's event in each record
            for lane in _run(active):
                fields = dict(gap=gap[lane], n_dots=n_dots[lane])
                if hit[lane]:
                    fields["event"] = obs_telemetry.EVENT_LAZY_HIT
                tel = obs_telemetry.amend_last(tel, lane=lane, **fields)
        frozen = torch.ones(L, dtype=torch.bool, device=dev).index_fill_(0, lanes.long(), False)
        return out._replace(n_dots=n_dots, i_star=i_star.masked_fill(frozen, -1),
                            rule=(cache_new, phi_new), tel=tel)


_RULES = {
    "classic": ClassicRule(),
    "away": DirRule(pairwise=False),
    "pairwise": DirRule(pairwise=True),
    "partan": PartanRule(),
    "lazy": LazyRule(),
}


def get_rule(cfg: Optional[FWConfig]) -> Any:
    """The step rule ``cfg.step_rule`` names ('classic' when cfg is None)."""
    if cfg is None:
        return _RULES["classic"]
    return _RULES[cfg.step_rule]
