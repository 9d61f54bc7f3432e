"""Elastic-net problem oracle for the stochastic FW engine (paper §6), the
reference's ``core/fw_elasticnet.py``:

    min_alpha  1/2 ||X a - y||^2 + (l2/2) ||a||^2   s.t.  ||a||_1 <= delta

The gradient gains a ``+l2 * a`` term and the exact line search stays
closed-form; the O(1) scalar recursions track Q^k = ||a^k||^2 beside S and
F:

    grad_i   = -z_i^T R + l2 * a_i
    num      = S - dt*g_x - F + l2*(Q - dt*a_i)                 [g_x = X-part]
    den      = (S - 2 dt G + dt^2 ||z||^2) + l2*(Q - 2 dt a_i + dt^2)
    Q_{k+1}  = (1-l)^2 Q + 2 l (1-l) dt a_i + l^2 dt^2

The ``+l2 * a_i`` term rides the engine's per-coordinate score shift
(``score_extra``, a ``vertex.ScoreShift``), which the kernels' backends
apply inside K2's argmax launch, so an elastic-net step is the lasso's four
launches. ``tail`` runs ``kernels/step_tail`` with the elastic-net's line
search and Q recursion (``en_ls_closed_form``, ``q_recursion``, in the
reference's op order so that the two packages round alike), then the
periodic exact refreshes of S, F and Q, host branches on the host's k.
With ``fuse_steps = K`` the chunk runs K4 or K7 with the alpha ledger
(``kernels/fused_step``), which matches the unfused steps to rounding.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import engine, vertex
from repro_torch.core.fw_lasso import (amend_refreshed, amend_refreshed_lanes, refresh_lanes,
                                       refresh_step, sf_refresh)
from repro_torch.core.solver_config import FWConfig
from repro_torch.kernels.step_tail import (  # noqa: F401 (the EN algebra, re-exported)
    DirEN,
    ENTail,
    en_ls_closed_form,
    q_recursion,
    sf_recursion,
)

ENResult = engine.SolveResult


class ENCo(NamedTuple):
    """Elastic-net co-state: the lasso's recursions plus Q = ||a||^2."""

    resid: torch.Tensor  # (m,)
    s_quad: torch.Tensor  # ||X a||^2
    f_lin: torch.Tensor  # (X a)^T y
    q_norm: torch.Tensor  # ||a||^2


def q_refresh(q_norm, beta, scale, k: int, cfg):
    """Q's periodic exact refresh from the scaled iterate at iteration
    ``k`` (the host's count, so a host branch, on the S/F refresh's
    cadence)."""
    if refresh_step(k, cfg):
        return engine.q_exact(beta, scale).to(q_norm.dtype)
    return q_norm


@dataclasses.dataclass(frozen=True)
class ENOracle:
    """Problem oracle: elastic-net over the l1 ball, of l2 strength ``l2``."""

    l2: float

    needs_stats = True
    extra_dots = 0
    # fused K-step chunk protocol: a closed-form line search, whose score
    # shift and line search read live alpha values, which the chunk
    # rebuilds from the chunk-start values and its alpha ledger
    fused_kind = "en"
    fused_needs_alpha = True

    def init_co(self, y, v, beta, dtype, cfg=None) -> ENCo:
        if v is None:
            zero = torch.zeros((), dtype=dtype, device=y.device)
            return ENCo(resid=y.to(dtype), s_quad=zero, f_lin=zero, q_norm=zero)
        return ENCo(
            resid=y - v,
            s_quad=vertex.mdot(v, v, cfg),
            f_lin=vertex.mdot(v, y, cfg),
            q_norm=torch.dot(beta, beta),
        )

    def cograd(self, co: ENCo, y):
        return co.resid

    def score_extra(self, beta, scale):
        """The +l2 * a_i gradient shift at the sampled coordinates (beta and
        scale lane-stacked for the batched lanes)."""
        return vertex.ScoreShift(beta, scale, self.l2)

    def tail(self, Xt, y, stats, state, i_star, g_raw, g_sel, delta, cfg, tel=None):
        """Steps 3-6 after the vertex: eq. 6's sign from the shifted score,
        the elastic-net's closed-form line search (``num`` is its sampled
        duality gap, the gap_rtol stall), the coefficient update, eq. 10 and
        the S/F/Q recursions (``vertex.step_tail`` with ``en``: one launch on
        the kernels' backends), then the periodic exact S/F and Q refresh.
        ``tel`` as the lasso's. Returns ``(beta, scale, maxabs, step_inf,
        stall, co)``."""
        co = state.co
        beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin, q_norm = vertex.step_tail(
            Xt, y, stats, state.beta, state.scale, state.maxabs, state.stall, co.resid,
            co.s_quad, co.f_lin, i_star, g_raw, delta, cfg,
            en=ENTail(g_sel, co.q_norm, self.l2), tel=tel,
        )
        s_quad, f_lin = sf_refresh(s_quad, f_lin, resid, y, state.k, cfg)
        q_norm = q_refresh(q_norm, beta, scale, state.k, cfg)
        co = ENCo(resid, s_quad, f_lin, q_norm)
        amend_refreshed(self, tel, y, stats, co, state.k, cfg)
        return beta, scale, maxabs, step_inf, stall, co

    def tail_lanes(self, Xt, y, stats, state, i_star, g_raw, g_sel, deltas, cfg, active, lanes,
                   tel=None):
        """``tail`` for the batched engine's lanes: ``vertex.step_tail_lanes``
        with ``en`` (one launch on the kernels' backends), then each active
        lane's periodic exact S/F and Q refresh at its own k."""
        co = state.co
        (beta, scale, maxabs, step_inf, stall, resid, s_quad, f_lin,
         q_norm) = vertex.step_tail_lanes(
            Xt, y, stats, state.beta, state.scale, state.maxabs, state.step_inf, state.stall,
            co.resid, co.s_quad, co.f_lin, i_star, g_raw, deltas, cfg, lanes,
            en=ENTail(g_sel, co.q_norm, self.l2), tel=tel,
        )
        done = refresh_lanes(s_quad, f_lin, resid, y, state.k, active, cfg)
        for lane in done:
            q_norm[lane] = engine.q_exact(beta[lane], scale[lane]).to(q_norm.dtype)
        co = ENCo(resid, s_quad, f_lin, q_norm)
        amend_refreshed_lanes(self, tel, y, stats, co, done)
        return beta, scale, maxabs, step_inf, stall, co

    # ---- the step rules' protocol (core/step_rule) -------------------------
    # The lasso's (``fw_lasso``) with the l2 terms: <grad, alpha> gains
    # +l2*Q, and the direction tail's line search its denominator
    # l2*||d||^2 (scalar algebra in Q and the atoms' alpha values on the
    # DirStep) and Q its generalized recursion (``kernels/step_tail``'s
    # ``DirEN`` terms); the selected scores already carry the +l2*a_i shift.

    def co_linpred(self, co: ENCo, y):
        return y - co.resid

    def grad_dot_alpha(self, co: ENCo, stats, y, beta, scale, cfg):
        return co.s_quad - co.f_lin + self.l2 * co.q_norm

    def partan_mu(self, y, stats, co: ENCo, u_m, a_mid, dp, mu_max, cfg):
        """mu* = (<R, u> - l2 <a_mid, dp>) / (||u||^2 + l2 ||dp||^2) on [0,
        mu_max]."""
        num = vertex.mdot(co.resid, u_m, cfg) - self.l2 * torch.dot(a_mid, dp)
        den = vertex.mdot(u_m, u_m, cfg) + self.l2 * torch.dot(dp, dp)
        return torch.clamp_min(num / torch.clamp_min(den, cfg.eps_den), 0.0).clamp_max(mu_max)

    def partan_update_co(self, y, stats, co: ENCo, a_new, mu, u_m, cfg) -> ENCo:
        resid = co.resid - mu * u_m
        v = y - resid
        return ENCo(resid=resid, s_quad=vertex.mdot(v, v, cfg), f_lin=vertex.mdot(v, y, cfg),
                    q_norm=torch.dot(a_new, a_new))

    def dir_tail(self, Xt, y, stats, state, buf, raw_b, i_f, sel_f, delta, pairwise, cfg):
        """The away and pairwise rules' step after the FW vertex (``sel_f``
        its shifted score) and the buffer's linear scores: ``vertex.dir_tail``
        with the EN's terms (one launch on the kernels' backends), then Q's
        periodic exact refresh, a host branch. Returns ``(out, co)``."""
        co = state.co
        out = vertex.dir_tail(Xt, y, state.beta, state.scale, state.maxabs, state.stall,
                              co.resid, co.s_quad, co.f_lin, buf, raw_b, i_f, sel_f, delta,
                              refresh_step(state.k, cfg), pairwise, cfg,
                              en=DirEN(self.l2, co.q_norm))
        q_norm = q_refresh(out.q_norm, out.beta, out.scale, state.k, cfg)
        return out, ENCo(out.resid, out.s_quad, out.f_lin, q_norm)

    # ---- fused K-step chunk protocol --------------------------------------

    def fused_score_shift(self, alpha_i):
        """The +l2 * a_i gradient shift from the reconstructed alpha."""
        return self.l2 * alpha_i

    def fused_line_search(self, scal, g_raw, g_sel, a_star, delta_t, zty_i, zn2_i, eps_den,
                          gap_rtol):
        s_quad, f_lin, q_norm = scal
        g_lin = g_raw + zty_i
        lam, no_progress = en_ls_closed_form(self.l2, s_quad, f_lin, q_norm, g_raw, g_lin, a_star,
                                             delta_t, zn2_i, eps_den, gap_rtol)
        return lam, no_progress, g_lin

    def fused_scalar_update(self, scal, g_lin, a_star, lam, delta_t, zty_i, zn2_i):
        s_quad, f_lin = sf_recursion(scal[0], scal[1], g_lin, lam, delta_t, zty_i, zn2_i)
        return (s_quad, f_lin, q_recursion(scal[2], lam, delta_t, a_star))

    def fused_pack_co(self, co: ENCo):
        return co.resid, (co.s_quad, co.f_lin, co.q_norm)

    def fused_unpack_co(self, resid, scal) -> ENCo:
        d = resid.dtype
        return ENCo(resid=resid, s_quad=scal[0].to(d), f_lin=scal[1].to(d), q_norm=scal[2].to(d))

    def objective(self, y, stats, co: ENCo, cfg=None):
        return 0.5 * stats.yty + 0.5 * co.s_quad - co.f_lin + 0.5 * self.l2 * co.q_norm

    def gap(self, Xt, y, alpha, delta, cfg=None):
        """Certified FW duality gap with the elastic-net's gradient
        -X^T R + l2*alpha: one O(p*m) (O(nnz) sparse) pass."""
        return engine.oracle_gap(self, Xt, y, alpha, delta, cfg)


def en_solve(Xt, y, cfg: FWConfig, l2: float, sampler, alpha0=None, delta=None, *,
             device="cuda", on_step=None) -> ENResult:
    """Elastic-net FW on any backend ('torch' | 'kernels' | 'sparse'):
    ``engine.solve`` with ``ENOracle(l2)``. Runs on the card unless
    ``device`` says otherwise."""
    return engine.solve(ENOracle(l2=float(l2)), Xt, y, cfg, sampler, alpha0, delta,
                        device=device, on_step=on_step)
