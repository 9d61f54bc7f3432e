"""Lasso problem oracle for the stochastic FW engine (paper Algorithm 2),
the reference's ``core/fw_lasso.py``:

    min_alpha f(alpha) = 1/2 ||X alpha - y||^2   s.t.  ||alpha||_1 <= delta

  * method of residuals (eq. 7): sampled gradient coords are -z_i^T R,
  * closed-form exact line search (eq. 8) with the S/F scalar recursions,
  * residual update (eq. 10),
  * per-iteration cost O(kappa * m), independent of p.

The scalar algebra (``kernels/step_tail``'s ``ls_closed_form`` and
``sf_recursion``) keeps the reference's operation order, so that the two
packages round alike.

Also the reference's flat lasso surface (``FWState``, ``init_state``,
``fw_step``, ``objective``, ``duality_gap``) and ``fw_solve_with_history``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import engine, vertex
from repro_torch.core.engine import ColStats, EngineState, precompute_colstats  # noqa: F401
from repro_torch.core.solver_config import FWConfig
from repro_torch.kernels.step_tail import ls_closed_form, sf_recursion
from repro_torch.obs.telemetry import write_record


class LassoCo(NamedTuple):
    """Lasso co-state: the residual and the paper's scalar recursions."""

    resid: torch.Tensor  # (m,) R = y - X alpha
    s_quad: torch.Tensor  # ()  S^k = ||X alpha||^2
    f_lin: torch.Tensor  # ()  F^k = (X alpha)^T y


def refresh_step(k: int, cfg) -> bool:
    """Whether iteration ``k`` (the host's count) refreshes the scalar
    recursions exactly."""
    return (k % cfg.refresh_every) == (cfg.refresh_every - 1)


def sf_refresh(s_quad, f_lin, resid, y, k: int, cfg):
    """The periodic exact O(m) refresh of S and F from the residual (fp32
    drift control) at iteration ``k``, the host iteration count, so the
    refresh is a host branch that needs no sync. Returns ``(s_quad,
    f_lin)``."""
    if refresh_step(k, cfg):
        v = y - resid
        s_quad, f_lin = vertex.mdot_pair(v, v, v, y, cfg)
    return s_quad, f_lin


def sf_update(stats, s_quad, f_lin, resid, y, i_star, lam, delta_t, g_lin, k: int, cfg):
    """The S/F scalar recursions (paper, below eq. 8) and the periodic exact
    O(m) refresh from the residual (the reference's ``sf_update``,
    ``core/fw_lasso.py:87-105``), as the tail's ``sf_recursion`` and
    ``sf_refresh`` compute them: the recursions on ``zty``/``znorm2`` at
    ``i_star`` (a 0-d device index), the refresh a host branch on ``k``.
    Returns ``(s_quad, f_lin, refresh)``, ``refresh`` a host bool."""
    s_quad, f_lin = sf_recursion(s_quad, f_lin, g_lin, lam, delta_t,
                                 vertex.take(stats.zty, i_star), vertex.take(stats.znorm2, i_star))
    s_quad, f_lin = sf_refresh(s_quad, f_lin, resid, y, k, cfg)
    return s_quad, f_lin, refresh_step(k, cfg)


def amend_refreshed(oracle, tel, y, stats, co, k: int, cfg) -> None:
    """A refresh step's ring record, written by the tail before the refresh,
    gets the objective of the refreshed co-state (the reference records it
    after ``update_co``, refresh included): one plain write, on refresh
    steps with the objective on only."""
    if tel is not None and tel.objective and refresh_step(k, cfg):
        write_record(tel.buf, tel.capacity, tel.slot, objective=oracle.objective(y, stats, co))


def amend_refreshed_lanes(oracle, tel, y, stats, co, lanes_done) -> None:
    """``amend_refreshed`` for the lanes refreshed in a batched step (each
    record at its lane's host cursor before the step)."""
    if tel is None or not tel.objective or not lanes_done:
        return
    objective = oracle.objective(y, stats, co)
    for lane in lanes_done:
        write_record(tel.buf[lane], tel.capacity, tel.cursors[lane] % tel.capacity,
                     objective=objective[lane])


def refresh_flags(ks, active, cfg) -> list:
    """Whether each lane refreshes this step: an active lane at a refresh
    step of its own k."""
    return [bool(a) and refresh_step(k, cfg) for k, a in zip(ks, active)]


def refresh_lanes(s_quad, f_lin, resid, y, ks, active, cfg):
    """Each active lane's periodic exact S/F refresh at its own k, from a
    residual row of its own, as ``sf_refresh`` takes it (in place on the
    ``(L,)`` scalars). Returns the lanes refreshed."""
    done = []
    for lane, a in enumerate(active):
        k = ks[lane]
        if a and (k % cfg.refresh_every) == (cfg.refresh_every - 1):
            s_quad[lane], f_lin[lane] = sf_refresh(s_quad[lane], f_lin[lane], resid[lane], y, k,
                                                   cfg)
            done.append(lane)
    return done


@dataclasses.dataclass(frozen=True)
class LassoOracle:
    """Problem oracle: 1/2 ||X alpha - y||^2 over the l1 ball."""

    needs_stats = True
    extra_dots = 0
    # fused K-step chunk protocol: the closed-form line search makes the
    # chunk kernel-composable, and the lasso's scores need no live alpha
    # values inside it
    fused_kind = "lasso"
    fused_needs_alpha = False

    def init_co(self, y, v, beta, dtype, cfg=None) -> LassoCo:
        if v is None:
            zero = torch.zeros((), dtype=dtype, device=y.device)
            return LassoCo(resid=y.to(dtype), s_quad=zero, f_lin=zero)
        s_quad, f_lin = vertex.mdot_pair(v, v, v, y, cfg)
        return LassoCo(resid=y - v, s_quad=s_quad, f_lin=f_lin)

    def cograd(self, co: LassoCo, y):
        """Sampled scores are -z_i^T R (method of residuals, eq. 7)."""
        return co.resid

    def score_extra(self, beta, scale, support=None):
        return None

    def tail(self, Xt, y, stats, state, i_star, g_raw, g_sel, delta, cfg, tel=None):
        """Steps 3-6 after the vertex: eq. 6's sign, the closed-form line
        search (eq. 8), the coefficient update, eq. 10 and the S/F
        recursions (``vertex.step_tail``: one launch on the kernels'
        backends), then the periodic exact S/F refresh. The lasso's scores
        have no extra term, so ``g_raw`` is ``g_sel``. ``tel`` (a
        ``kernels.step_tail.TailRecord``) writes the step's ring record in
        the same launch, its objective amended on a refresh step. Returns
        ``(beta, scale, maxabs, step_inf, stall, co)``, the scalars in the
        state's dtype."""
        co = state.co
        beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin = vertex.step_tail(
            Xt, y, stats, state.beta, state.scale, state.maxabs, state.stall, co.resid,
            co.s_quad, co.f_lin, i_star, g_sel, delta, cfg, tel=tel,
        )
        s_quad, f_lin = sf_refresh(s_quad, f_lin, resid, y, state.k, cfg)
        co = LassoCo(resid, s_quad, f_lin)
        amend_refreshed(self, tel, y, stats, co, state.k, cfg)
        return beta, scale, maxabs, step_inf, stall, co

    def tail_lanes(self, Xt, y, stats, state, i_star, g_raw, g_sel, deltas, cfg, active, lanes,
                   tel=None):
        """``tail`` for the batched engine's lanes (a lane-stacked ``state``;
        ``active`` the host's list of the lanes that step, ``lanes`` their
        int32 device ids): ``vertex.step_tail_lanes`` (one launch on the
        kernels' backends; with ``tel``, a lane ``TailRecord``, each stepping
        lane's ring record in it), then each active lane's periodic exact S/F
        refresh at its own k (``refresh_lanes``)."""
        co = state.co
        beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin = vertex.step_tail_lanes(
            Xt, y, stats, state.beta, state.scale, state.maxabs, state.step_inf, state.stall,
            co.resid, co.s_quad, co.f_lin, i_star, g_sel, deltas, cfg, lanes, tel=tel,
        )
        done = refresh_lanes(s_quad, f_lin, resid, y, state.k, active, cfg)
        co = LassoCo(resid, s_quad, f_lin)
        amend_refreshed_lanes(self, tel, y, stats, co, done)
        return beta, scale, maxabs, step_inf, stall, co

    # ---- the step rules' protocol (core/step_rule) -------------------------
    # The away and pairwise rules move along d = t*alpha + df*e_f + da*e_a;
    # with u = df*z_f + da*z_a the direction's image is X d = t*(X alpha) +
    # u, so the closed-form line search needs only S, F and O(m) dots on u:
    # ``kernels/step_tail``'s direction algebra (``dir_line_search``,
    # ``dir_update_co``, the reference's op order), all of it inside
    # ``dir_tail``.

    def co_linpred(self, co: LassoCo, y):
        """X alpha from the co-state (O(m), no matvec)."""
        return y - co.resid

    def grad_dot_alpha(self, co: LassoCo, stats, y, beta, scale, cfg):
        """<grad, alpha> = S - F for grad = -X^T R."""
        return co.s_quad - co.f_lin

    def partan_mu(self, y, stats, co: LassoCo, u_m, a_mid, dp, mu_max, cfg):
        """The PARTAN extrapolation step, minimizing 1/2 ||mu u - R_mid||^2
        (u = X dp) over mu in [0, mu_max]."""
        num = vertex.mdot(co.resid, u_m, cfg)
        den = vertex.mdot(u_m, u_m, cfg)
        return torch.clamp_min(num / torch.clamp_min(den, cfg.eps_den), 0.0).clamp_max(mu_max)

    def partan_update_co(self, y, stats, co: LassoCo, a_new, mu, u_m, cfg) -> LassoCo:
        """R' = R_mid - mu u, S and F recomputed exactly (two O(m) dots)."""
        resid = co.resid - mu * u_m
        v = y - resid
        return LassoCo(resid=resid, s_quad=vertex.mdot(v, v, cfg), f_lin=vertex.mdot(v, y, cfg))

    def dir_tail(self, Xt, y, stats, state, buf, raw_b, i_f, sel_f, delta, pairwise, cfg):
        """The away and pairwise rules' step after the FW vertex and the
        buffer's linear scores (``vertex.dir_tail``: one launch on the
        kernels' backends), the periodic refresh inside it. Returns ``(out,
        co)``, ``out`` a ``DirTailOut``."""
        co = state.co
        out = vertex.dir_tail(Xt, y, state.beta, state.scale, state.maxabs, state.stall,
                              co.resid, co.s_quad, co.f_lin, buf, raw_b, i_f, sel_f, delta,
                              refresh_step(state.k, cfg), pairwise, cfg)
        return out, LassoCo(out.resid, out.s_quad, out.f_lin)

    def dir_tail_lanes(self, Xt, y, stats, state, buf, raw_b, i_f, sel_f, deltas, pairwise, cfg,
                       active, lanes):
        """``dir_tail`` for the batched engine's lanes (``vertex.dir_tail_lanes``:
        one launch on the kernels' backends), each active lane's refresh at
        its own k inside it. Returns ``(out, co)``, lane-stacked."""
        co = state.co
        out = vertex.dir_tail_lanes(Xt, y, state.beta, state.scale, state.maxabs, state.step_inf,
                                    state.stall, co.resid, co.s_quad, co.f_lin, buf, raw_b, i_f,
                                    sel_f, deltas, refresh_flags(state.k, active, cfg), lanes,
                                    pairwise, cfg)
        return out, LassoCo(out.resid, out.s_quad, out.f_lin)

    # ---- fused K-step chunk protocol --------------------------------------
    # The chunk (kernels/fused_step) carries the co-state as (resid, (S, F,
    # Q)), Q unused by the lasso. The scalar algebra is ``ls_closed_form`` /
    # ``sf_recursion``, the same the unfused step runs, and the CUDA kernel
    # repeats its op order.

    def fused_score_shift(self, alpha_i):
        """Per-coordinate selected-score shift from the live alpha value
        (None: lasso scores are purely linear)."""
        return None

    def fused_line_search(self, scal, g_raw, g_sel, a_star, delta_t, zty_i, zn2_i,
                          eps_den, gap_rtol):
        s_quad, f_lin, _ = scal
        g_lin = g_raw + zty_i
        lam, no_progress, _ = ls_closed_form(
            s_quad, f_lin, g_sel, g_lin, delta_t, zn2_i, eps_den, gap_rtol
        )
        return lam, no_progress, g_lin

    def fused_scalar_update(self, scal, g_lin, a_star, lam, delta_t, zty_i, zn2_i):
        """Pre-refresh recursions on the (S, F, Q) triple; the chunk applies
        the periodic exact S/F refresh on the unfused cadence."""
        s_quad, f_lin = sf_recursion(scal[0], scal[1], g_lin, lam, delta_t, zty_i, zn2_i)
        return (s_quad, f_lin, scal[2])

    def fused_pack_co(self, co: LassoCo):
        return co.resid, (co.s_quad, co.f_lin, torch.zeros_like(co.s_quad))

    def fused_unpack_co(self, resid, scal) -> LassoCo:
        return LassoCo(resid=resid, s_quad=scal[0], f_lin=scal[1])

    def objective(self, y, stats, co: LassoCo, cfg=None):
        """f(alpha^k) = 1/2 y^T y + 1/2 S^k - F^k (paper eq. 8 block)."""
        return 0.5 * stats.yty + 0.5 * co.s_quad - co.f_lin

    def gap(self, Xt, y, alpha, delta, cfg=None):
        """Certified FW duality gap alpha^T grad + delta*||grad||_inf with
        grad = -X^T (y - X alpha): one O(p*m) pass."""
        return engine.oracle_gap(self, Xt, y, alpha, delta, cfg)


LASSO = LassoOracle()

# the reference's name of the lasso solve's result
FWResult = engine.SolveResult


def fw_solve(Xt, y, cfg: FWConfig, sampler, alpha0=None, delta=None, *,
             device="cuda", on_step=None) -> engine.SolveResult:
    """Run Algorithm 2 until ||alpha_{k+1}-alpha_k||_inf <= tol for
    ``patience`` consecutive iterations, or max_iters (``engine.solve``
    with the lasso oracle)."""
    return engine.solve(LASSO, Xt, y, cfg, sampler, alpha0, delta,
                        device=device, on_step=on_step)


def fw_solve_with_history(Xt, y, cfg: FWConfig, sampler, n_iters: int, alpha0=None, *,
                          device="cuda"):
    """Run exactly ``n_iters`` steps recording f(alpha^k) after each
    (convergence plots; ``engine.solve_with_history`` with the lasso
    oracle). Returns ``(SolveResult, objective_history (n_iters,))``."""
    return engine.solve_with_history(LASSO, Xt, y, cfg, sampler, n_iters, alpha0,
                                     device=device)


# --------------------------------------------------------------------------
# The reference's flat lasso state surface (tests drive fw_step directly)
# --------------------------------------------------------------------------


class FWState(NamedTuple):
    """Flat lasso loop state, the reference's fields without its PRNG key
    (the port's samplers stand in for it). ``alpha = scale * beta``."""

    beta: torch.Tensor
    scale: torch.Tensor
    resid: torch.Tensor
    s_quad: torch.Tensor
    f_lin: torch.Tensor
    maxabs: torch.Tensor
    step_inf: torch.Tensor
    stall: torch.Tensor
    n_dots: int
    k: int


def _to_engine(state: FWState) -> engine.EngineState:
    return engine.EngineState(
        beta=state.beta,
        scale=state.scale,
        co=LassoCo(resid=state.resid, s_quad=state.s_quad, f_lin=state.f_lin),
        maxabs=state.maxabs,
        step_inf=state.step_inf,
        stall=state.stall,
        n_dots=state.n_dots,
        k=state.k,
        i_star=torch.full((), -1, dtype=torch.int64, device=state.beta.device),
    )


def _from_engine(es: engine.EngineState) -> FWState:
    return FWState(
        beta=es.beta,
        scale=es.scale,
        resid=es.co.resid,
        s_quad=es.co.s_quad,
        f_lin=es.co.f_lin,
        maxabs=es.maxabs,
        step_inf=es.step_inf,
        stall=es.stall,
        n_dots=es.n_dots,
        k=es.k,
    )


def init_state(Xt, y, alpha0=None, cfg: Optional[FWConfig] = None) -> FWState:
    """Start from the null solution, or warm-start from ``alpha0``, on the
    device and in the dtype of ``Xt`` (dense, or a ``SparseBlockMatrix``)."""
    return _from_engine(engine.init_state(LASSO, Xt, y, alpha0, cfg))


def fw_step(Xt, y, stats: engine.ColStats, state: FWState, cfg: FWConfig, sampler,
            delta=None) -> FWState:
    """One randomized Frank-Wolfe step (paper Algorithm 2): the engine step
    under the lasso oracle, drawing its sampling set from ``sampler``.
    ``state.beta`` is updated in place, as the engine's step does."""
    delta = torch.tensor(float(cfg.delta if delta is None else delta), dtype=torch.float32,
                         device=state.beta.device)
    return _from_engine(engine.step(LASSO, Xt, y, stats, _to_engine(state), cfg, delta,
                                    sampler))


def objective(stats: engine.ColStats, state) -> torch.Tensor:
    """f(alpha^k) = 1/2 y^T y + 1/2 S^k - F^k (paper eq. 8 block)."""
    return 0.5 * stats.yty + 0.5 * state.s_quad - state.f_lin


def duality_gap(Xt, state, delta: float, cfg: Optional[FWConfig] = None) -> torch.Tensor:
    """Exact FW duality gap g(alpha) = alpha^T grad + delta*||grad||_inf, the
    gradient read off the state's live residual (``vertex.grad_full``): one
    O(p*m) (O(nnz) sparse) pass, for certification and tests."""
    alpha = state.scale * state.beta
    grad = vertex.grad_full(Xt, state.resid, cfg)[:alpha.shape[0]]
    return torch.dot(alpha, grad) + delta * torch.max(torch.abs(grad))
