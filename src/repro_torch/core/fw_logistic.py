"""Logistic problem oracle for the stochastic FW engine (paper §6), the
reference's ``core/fw_logistic.py``:

    min_a  sum_i log(1 + exp(-y_i * x_i^T a))   s.t.  ||a||_1 <= delta
    (y in {-1, +1}; a padded sample's y == 0 adds nothing)

Algorithm 2 with two changes, both here: the co-state is the margin vector
m = X a, updated by the same O(m) recursion m <- (1-l) m + l dt z_i*, and
the engine scores against w = y * sigmoid(-y * m), the negated margin
gradient; the exact line search has no closed form, so ``n_bisect``
bisection steps on the monotone phi'(l) (one O(m) dot each) find the step.

The step's scores and argmax run on the card (K2, or K5 on the block-ELL
layout); the tail after the argmax (the direction column, the bisection,
the sampled gap, the coefficient update and the margin update) is plain
PyTorch, as the reference leaves it to XLA outside any Pallas kernel. It
stays on the device: the bisection's branches are ``torch.where`` selects,
no host read. ``tail`` is the one-lane case of ``tail_lanes``, which runs
the bisection stacked over the active lanes, so a lane keeps the bits of
its sequential replay. The oracle has no fused form (``fused_kind =
None``): ``fuse_steps = K`` runs the per-step loop, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import engine, vertex
from repro_torch.core.solver_config import FWConfig
from repro_torch.kernels.step_tail import apply_coeff_update
from repro_torch.obs.telemetry import EVENT_FW, write_record

LogisticResult = engine.SolveResult


def _loss(margin, y, cfg=None):
    """The logistic loss of one margin vector; padded samples (y == 0) add
    nothing (not their log 2 rest loss)."""
    per = torch.logaddexp(torch.zeros((), dtype=margin.dtype, device=margin.device), -y * margin)
    return vertex.msum(torch.where(y != 0, per, 0.0), cfg)


class LogisticCo(NamedTuple):
    """Logistic co-state: the margin vector X a."""

    margin: torch.Tensor  # (m,), lanes (L, m)


def _row_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Each row's dot product of two ``(A, m)`` stacks, the sample-axis
    reduction of the stacked bisection."""
    return (a * b).sum(dim=1)


# On the CPU the stacked bisection pads the sample axis to a multiple of
# this many elements. The CPU's vectorized sigmoid rounds otherwise than its
# scalar remainder loop, so a row of an (A, m) stack whose start is not on
# a vector boundary would not keep the one-lane bits; padded rows all start
# on one. (Zero padding adds exact zeros to every dot.) On the card the
# lanes are held to their one-lane steps to rounding only (an (A, m) row
# reduction need not split as an (m,) one does), so there the three copies
# a step are skipped.
_ROW_ALIGN = 64


def _pad_rows(t: torch.Tensor, mp: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, mp - t.shape[-1]))


@dataclasses.dataclass(frozen=True)
class LogisticOracle:
    """Problem oracle: l1-constrained logistic loss (labels in {-1, +1})."""

    n_bisect: int = 20

    needs_stats = False
    # no closed-form line search: the O(m)-per-probe bisection has no fused
    # form, so ``fuse_steps`` falls back to the per-step loop
    fused_kind = None
    fused_needs_alpha = False

    @property
    def extra_dots(self) -> int:
        # each bisection probe is one O(m) dot, plus the two endpoint tests
        # and the sampled-gap stall statistic
        return self.n_bisect + 3

    def init_co(self, y, v, beta, dtype, cfg=None) -> LogisticCo:
        return LogisticCo(margin=torch.zeros_like(y) if v is None else v)

    def cograd(self, co: LogisticCo, y):
        """The gradient with respect to the margin is -y * sigmoid(-y * m);
        the engine scores -z_i^T w, so w is its negation (exact). Lanes:
        a row at a time, each as the one-lane call computes it."""
        if co.margin.dim() == 2:
            return torch.stack([y * torch.sigmoid(-y * mg) for mg in co.margin])
        return y * torch.sigmoid(-y * co.margin)

    def score_extra(self, beta, scale):
        return None

    def _bisect_interval(self, ny, margin, dm, hi):
        """The bisection of A stacked rays (``margin``, ``dm (A, m)``, ``ny =
        -y``, rows padded on the CPU): the minimizer of the loss along
        ``margin + s dm`` for s in [0, hi] (``hi (A,)``), phi'(s) increasing
        (convexity), with the endpoint tests. Returns ``(A,)``."""

        def phi_prime(s):
            mg = margin + s[:, None] * dm
            return _row_dots(ny * torch.sigmoid(ny * mg), dm)

        zeros = torch.zeros_like(hi)
        a, b = zeros, hi
        for _ in range(self.n_bisect):
            mid = 0.5 * (a + b)
            going_up = phi_prime(mid) > 0
            a, b = torch.where(going_up, a, mid), torch.where(going_up, mid, b)
        s = 0.5 * (a + b)
        # phi'(hi) <= 0: the minimizer is hi; phi'(0) >= 0: it is 0
        s = torch.where(phi_prime(hi) <= 0, hi, s)
        return torch.where(phi_prime(zeros) >= 0, 0.0, s)

    def _padded(self, y, *rows):
        """``-y`` and the ``(A, m)`` stacks ``rows``, padded on the CPU (see
        ``_ROW_ALIGN``)."""
        ts = (-y, *rows)
        if rows[0].device.type == "cpu":
            mp = -(-rows[0].shape[1] // _ROW_ALIGN) * _ROW_ALIGN
            ts = tuple(_pad_rows(t, mp) for t in ts)
        return ts

    def _bisect(self, y, margin, dm, delta_t, g_sel, cfg):
        """The line search of A stacked steps (``margin``, ``dm (A, m)``;
        ``delta_t``, ``g_sel (A,)``): the bisection of phi'(l) on [0, 1]
        with the endpoint tests, and the sampled-gap stall. Returns ``(lam,
        no_progress)``, each ``(A,)``."""
        ny, margin, dm = self._padded(y, margin, dm)
        ones = torch.ones(margin.shape[0], dtype=torch.float32, device=margin.device)
        lam = self._bisect_interval(ny, margin, dm, ones)
        # the sampled FW duality gap alpha^T grad + delta |grad_i*|, with
        # alpha^T grad_alpha = margin^T grad_margin: O(m), and below the
        # fp32 floor of its own terms a stall (gap_rtol)
        grad_m = ny * torch.sigmoid(ny * margin)
        a_grad = _row_dots(margin, grad_m)
        dg = torch.abs(delta_t * g_sel)
        no_progress = a_grad + dg <= cfg.gap_rtol * (torch.abs(a_grad) + dg)
        return lam, no_progress

    def tail(self, Xt, y, stats, state, i_star, g_raw, g_sel, delta, cfg, tel=None):
        """Steps 3-6 after the vertex: eq. 6's sign, the bisection line
        search along m(l) = m + l (dt z_i* - m), the coefficient update and
        the margin update; ``tail_lanes``'s code for one lane. ``tel`` (a
        ``kernels.step_tail.TailRecord``) adds the step's ring record, the
        plain record (with the objective, one O(m) dot for the gap's <grad,
        alpha> before the step and the loss after it). Returns ``(beta,
        scale, maxabs, step_inf, stall, co)``."""
        ga = self._record_ga(tel, y, stats, state.co, cfg)
        beta, scale, maxabs, step_inf, stall, margin, lam, step_inf32 = self._tail_stacked(
            Xt, y, [state.beta], [state.scale], [state.maxabs], [state.stall],
            state.co.margin[None], i_star.view(1), g_sel.view(1), delta.view(1), cfg)
        co = LogisticCo(margin.view(-1))
        if tel is not None:
            self._record(tel, y, stats, co, ga, i_star, g_sel, delta, lam[0], step_inf32[0],
                         stall[0])
        return beta[0], scale[0], maxabs[0], step_inf[0], stall[0], co

    def tail_lanes(self, Xt, y, stats, state, i_star, g_raw, g_sel, deltas, cfg, active, lanes,
                   tel=None):
        """``tail`` for the batched engine's lanes: the bisection stacked over
        the active lanes; a frozen lane keeps its state and records nothing
        (``tel``, a lane ``TailRecord``: each stepping lane's plain record,
        its device cursor advanced)."""
        run = [lane for lane, a in enumerate(active) if a]
        scale, maxabs, step_inf, stall = (t.clone() for t in (
            state.scale, state.maxabs, state.step_inf, state.stall))
        margin = state.co.margin.clone()
        if run:
            gas = [self._record_ga(tel, y, stats, LogisticCo(margin[lane]), cfg) for lane in run]
            ids = lanes.long()  # the running lanes' ids, ``run`` on the device
            got = self._tail_stacked(
                Xt, y, [state.beta[lane] for lane in run], [state.scale[lane] for lane in run],
                [state.maxabs[lane] for lane in run], [state.stall[lane] for lane in run],
                margin.index_select(0, ids), i_star.index_select(0, ids),
                g_sel.index_select(0, ids), deltas.index_select(0, ids), cfg)
            for n, lane in enumerate(run):
                scale[lane], maxabs[lane], step_inf[lane], stall[lane] = (
                    t[n] for t in got[1:5])
            margin.index_copy_(0, ids, got[5])
            if tel is not None:
                for n, lane in enumerate(run):
                    self._record(tel.lane(lane), y, stats, LogisticCo(margin[lane]), gas[n],
                                 i_star[lane], g_sel[lane], deltas[lane], got[6][n], got[7][n],
                                 stall[lane])
                    tel.dev_cursor[lane] += 1
        return state.beta, scale, maxabs, step_inf, stall, LogisticCo(margin)

    def _record_ga(self, tel, y, stats, co, cfg):
        """<grad, alpha> before the step, for the record's gap (None: not
        recorded)."""
        if tel is None or not tel.objective:
            return None
        return self.grad_dot_alpha(co, stats, y, None, None, cfg)

    def _record(self, tel, y, stats, co, ga, i_star, g_sel, delta, lam, step_inf, stall):
        """The step's plain ring record: the classic record's gap ``<grad,
        alpha> - delta_t g_sel`` and the loss after the step when the
        objective is on, NaN else."""
        gap = objective = float("nan")
        if tel.objective:
            delta_t = -delta * torch.sign(g_sel.float())
            gap = ga.float() - delta_t * g_sel.float()
            objective = self.objective(y, stats, co)
        write_record(tel.buf, tel.capacity, tel.slot, k=tel.k, i_star=i_star, event=EVENT_FW,
                     stall=stall, lam=lam, gap=gap, objective=objective, step_inf=step_inf,
                     n_dots=tel.n_dots)

    def _tail_stacked(self, Xt, y, betas, scales, maxabss, stalls, margin, i_star, g_sel, delta,
                      cfg):
        """The tail of A steps at once: ``margin (A, m)``, the winners, their
        scores and deltas ``(A,)``, and each step's ``beta`` (updated in
        place) and scalars as lists. Returns ``(betas, scales, maxabss,
        step_infs, stalls, margin (A, m), lam (A,), step_infs in f32)``, the
        scalars in the state's dtype but the last two."""
        dtype = margin.dtype
        delta_t = -delta * torch.sign(g_sel.float())  # eq. 6
        dm = delta_t[:, None] * vertex.columns_dense(Xt, i_star) - margin
        lam, no_progress = self._bisect(y, margin, dm, delta_t, g_sel, cfg)
        outs = [[], [], [], [], []]
        for n, beta in enumerate(betas):
            i = i_star[n]
            a_star = scales[n].float() * vertex.take(beta, i).float()
            got = apply_coeff_update(beta, scales[n], maxabss[n], stalls[n], a_star, i, lam[n],
                                     delta_t[n], no_progress[n], cfg)
            for out, t in zip(outs, got):
                out.append(t)
        beta, scale, maxabs, step_inf, stall = outs
        margin = (margin + lam[:, None] * dm).to(dtype)
        return (beta, [t.to(dtype) for t in scale], [t.to(dtype) for t in maxabs],
                [t.to(dtype) for t in step_inf], stall, margin, lam, step_inf)

    # ---- the step rules' protocol (core/step_rule) -------------------------
    # Along d = t*alpha + df*e_f + da*e_a the margin moves on the ray m + g u,
    # u = t*m + df*z_f + da*z_a, so the classic step's bisection runs on
    # [0, g_max] (``_bisect_ray``). Plain PyTorch, on the device with no host
    # read, as the reference's XLA ops (a one-launch form is ROADMAP.md Queue
    # 2 item G).

    def co_linpred(self, co: LogisticCo, y):
        return co.margin

    def grad_dot_alpha(self, co: LogisticCo, stats, y, beta, scale, cfg):
        """alpha^T grad_alpha = margin^T grad_margin: one O(m) dot."""
        grad_m = -y * torch.sigmoid(-y * co.margin)
        return vertex.mdot(co.margin, grad_m, cfg)

    def _bisect_ray(self, y, m0, u, g_max, cfg):
        """argmin over g in [0, g_max] of the loss at ``m0 + g u`` (the
        reference's ``core/fw_logistic.py:147-166``): ``_bisect``'s body on one
        ray. Returns a 0-d f32."""
        ny, m0, u = self._padded(y, m0[None], u[None])
        hi = torch.as_tensor(g_max, dtype=torch.float32, device=m0.device).reshape(1)
        return self._bisect_interval(ny, m0, u, hi).view(())

    def dir_line_search(self, y, stats, co: LogisticCo, ds, u_lin, cfg):
        """The bisection along u = t*m + u_lin on [0, g_max]; ``num`` is the
        directional FW gap -<grad_m, u> at g = 0, below the f32 floor of its
        own terms a stall. Returns ``(g, no_progress, u)``."""
        u = ds.t * co.margin + u_lin
        g = self._bisect_ray(y, co.margin, u, ds.g_max, cfg)
        grad_m = -y * torch.sigmoid(-y * co.margin)
        num = -vertex.mdot(grad_m, u, cfg)
        a_grad = vertex.mdot(co.margin, grad_m, cfg)
        gap_scale = (torch.abs(ds.t) * torch.abs(a_grad) + torch.abs(ds.df * ds.sel_f)
                     + torch.abs(ds.da * ds.sel_a))
        return g, num <= cfg.gap_rtol * gap_scale, u

    def dir_update_co(self, Xt, y, stats, co: LogisticCo, beta, scale, ds, g, u_lin, k, cfg,
                      aux) -> LogisticCo:
        return LogisticCo(margin=(co.margin + g * aux).to(co.margin.dtype))

    def partan_mu(self, y, stats, co: LogisticCo, u_m, a_mid, dp, mu_max, cfg):
        return self._bisect_ray(y, co.margin, u_m, mu_max, cfg)

    def partan_update_co(self, y, stats, co: LogisticCo, a_new, mu, u_m, cfg) -> LogisticCo:
        return LogisticCo(margin=(co.margin + mu * u_m).to(co.margin.dtype))

    def objective(self, y, stats, co: LogisticCo, cfg=None):
        """The loss at the margin; lanes: one loss a lane, each summed as
        the one-lane call sums it."""
        if co.margin.dim() == 1:
            return _loss(co.margin, y, cfg)
        return torch.stack([_loss(mg, y, cfg) for mg in co.margin])

    def gap(self, Xt, y, alpha, delta, cfg=None):
        """Certified FW duality gap with the logistic gradient
        X^T (-y sigmoid(-y m)): one O(p*m) (O(nnz) sparse) pass."""
        return engine.oracle_gap(self, Xt, y, alpha, delta, cfg)


LOGISTIC = LogisticOracle()


def logistic_solve(Xt, y, cfg: FWConfig, sampler, alpha0=None, delta=None, *, device="cuda",
                   on_step=None) -> LogisticResult:
    """l1-constrained logistic FW on any backend ('torch' | 'kernels' |
    'sparse'), labels in {-1, +1}: ``engine.solve`` with ``LOGISTIC``. Runs
    on the card unless ``device`` says otherwise."""
    return engine.solve(LOGISTIC, Xt, y, cfg, sampler, alpha0, delta, device=device,
                        on_step=on_step)
