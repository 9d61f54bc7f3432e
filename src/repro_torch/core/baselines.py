"""Baseline lasso solvers the paper compares against (the reference's
``core/baselines.py``; paper Table 2 and §5):

  * cyclic coordinate descent (Glmnet-style, Friedman et al. 2010) on the
    penalized form 1/2 ||X a - y||^2 + lam ||a||_1;
  * stochastic coordinate descent (Shalev-Shwartz & Tewari 2011);
  * FISTA (accelerated proximal gradient) on the penalized form, and
    projected accelerated gradient on the constrained form (the SLEP pair).

Every solver takes the dense design feature-major (``Xt (p, m)``,
predictor z_i = Xt[i], float32 or bfloat16), keeps its state in float32
(a bfloat16 design is widened: on load by the CD kernel, once a solve for
FISTA's matrix products), counts "requested dot products" in the paper's
currency (a length-m predictor dot is one; a dense matvec is p) and stops
on the paper's ``||alpha_{t+1} - alpha_t||_inf <= eps`` rule, compared in
float32 as the reference compares.

A CD sweep is ``kernels/cd_sweep``'s screened sweep (its plain version on
CPU tensors): a score pass and a walker launch, once more each a re-base,
and one host read a walk (the last gives the sweep's max |d|); a FISTA iteration
is two ``torch.mv`` calls, the prox and the momentum, and one host read of
its step. The counts are Python ints (``unit_dots``): the reference's are
int32 and wrap at the paper's size (ROADMAP.md R6).

The random streams are inputs, as the FW sampler's are: ``cd_solve``
takes each sweep's order from ``order(sweep)`` (the reference draws
``randint(sub, (p,), 0, p)`` after a ``split`` each sweep), and
``estimate_lipschitz``/``fista_solve`` take the power iteration's start
``v0`` (the reference's ``normal(key, (p,))``). Without them the solvers
draw from a ``torch.Generator`` seeded from ``seed``.

The solvers run on the device of ``Xt`` when it is a tensor (the card for
numpy inputs), or on ``device`` when given.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.projections import project_l1_ball, soft_threshold
from repro_torch.core.solver_config import CDConfig, FISTAConfig
from repro_torch.kernels import _build
from repro_torch.kernels.cd_sweep import cd_sweep
from repro_torch.kernels.colstats import colstats
from repro_torch.sparse.matrix import SparseBlockMatrix

OrderFn = Callable[[int], torch.Tensor]


class SolveResult(NamedTuple):
    alpha: torch.Tensor  # (p,) float32
    objective: torch.Tensor  # 1/2||Xa-y||^2 (fit term only, comparable across forms)
    iterations: int  # sweeps (CD), iters (FISTA)
    n_dots: int
    active: int
    converged: bool


def unit_dots(p: int, cd_sweeps: int = 0, fista_iters: int = 0, power_iters: int = 0) -> int:
    """The paper's dot count, a Python int: p a CD sweep (one length-m dot
    a coordinate), 2p a FISTA iteration and a power iteration (two dense
    matvecs each)."""
    return p * cd_sweeps + 2 * p * (fista_iters + power_iters)


def _device(Xt, device) -> torch.device:
    if device is None:
        device = Xt.device if isinstance(Xt, torch.Tensor) else "cuda"
    return engine.resolve_device(device)


def prepare_dense(Xt, y, device=None):
    """``(Xt, y)`` on the solve's device: Xt (p, m) float32 or bfloat16 as
    given, y as float32; finite, of matching shapes. Dense only, as the
    reference (``cd_solve`` indexes ``Xt[j]``)."""
    if isinstance(Xt, SparseBlockMatrix):
        raise TypeError("the baselines take a dense Xt (p, m), as the reference's do")
    dev = _device(Xt, device)
    Xt = torch.as_tensor(Xt, device=dev).contiguous()
    y = torch.as_tensor(y, device=dev).float().contiguous()
    if Xt.dim() != 2 or Xt.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"Xt must be (p, m) float32 or bfloat16, got {tuple(Xt.shape)} "
                        f"{Xt.dtype}")
    if y.shape != (Xt.shape[1],):
        raise ValueError(f"y must be (m,) = ({Xt.shape[1]},), got {tuple(y.shape)}")
    engine.validate_inputs(Xt, y)
    return Xt, y


def _start(alpha0, p: int, device) -> torch.Tensor:
    """The iterate the solver updates: a float32 copy of ``alpha0`` (never
    the caller's tensor), or zeros."""
    if alpha0 is None:
        return torch.zeros(p, dtype=torch.float32, device=device)
    alpha = torch.as_tensor(alpha0, device=device).float().clone()
    if alpha.shape != (p,):
        raise ValueError(f"alpha0 must be ({p},), got {tuple(alpha.shape)}")
    return alpha


def _widened(Xt: torch.Tensor) -> torch.Tensor:
    """The design as float32 for the dense matvecs (a copy for bfloat16)."""
    return Xt if Xt.dtype == torch.float32 else Xt.float()


class RandomOrder:
    """The stochastic CD's default stream: each call draws the next sweep's
    p rows uniformly with replacement from a ``torch.Generator`` seeded from
    ``seed`` (calls in sweep order)."""

    def __init__(self, p: int, seed: int, device):
        self.p = p
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def __call__(self, sweep: int) -> torch.Tensor:
        return torch.randint(0, self.p, (self.p,), generator=self.gen, device=self.device)


def random_start(p: int, seed: int, device) -> torch.Tensor:
    """The power iteration's default start: p standard normals from a
    ``torch.Generator`` seeded from ``seed``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed)
    return torch.randn(p, generator=gen, device=device)


def _sweep_order(order: OrderFn, sweep: int, p: int, device) -> torch.Tensor:
    rows = torch.as_tensor(order(sweep), device=device).to(torch.int64).contiguous()
    if rows.shape != (p,):
        raise ValueError(f"sweep {sweep}'s order must be ({p},), got {tuple(rows.shape)}")
    if bool(((rows < 0) | (rows >= p)).any()):
        raise ValueError(f"sweep {sweep}'s order has rows outside [0, {p})")
    return rows


def cd_solve(Xt, y, cfg: CDConfig, order: Optional[OrderFn] = None, alpha0=None, lam=None, *,
             device=None, seed: int = 0) -> SolveResult:
    """Glmnet-style coordinate descent with a maintained residual.

    Update (unit-norm columns not assumed):
        a_j <- S_lam( z_j^T R + a_j ||z_j||^2 ) / ||z_j||^2

    ``order(sweep)`` gives a stochastic config's (p,) rows for each sweep
    (the reference's stream, replayed); None draws ``RandomOrder(p,
    seed)``. A cyclic config takes no order. ``lam`` overrides
    ``cfg.lam`` (path reuse).
    """
    Xt, y = prepare_dense(Xt, y, device)
    p, m = Xt.shape
    lam = cfg.lam if lam is None else lam
    if not cfg.stochastic and order is not None:
        raise ValueError("a cyclic CDConfig sweeps in index order and takes no order stream")
    if cfg.stochastic and order is None:
        order = RandomOrder(p, seed, Xt.device)
    _, zn2 = colstats(Xt, y)
    alpha = _start(alpha0, p, Xt.device)
    resid = y - torch.mv(_widened(Xt).t(), alpha)
    tol = _build.f32(cfg.tol)
    max_delta, sweeps = float("inf"), 0
    while sweeps < cfg.max_sweeps and max_delta > tol:
        rows = _sweep_order(order, sweeps, p, Xt.device) if cfg.stochastic else None
        # the screened sweep (a walk a launch), then the stopping rule's read
        max_delta = float(cd_sweep(Xt, alpha, resid, zn2, lam, rows))
        sweeps += 1
    return SolveResult(
        alpha=alpha,
        objective=0.5 * torch.dot(resid, resid),
        iterations=sweeps,
        n_dots=unit_dots(p, cd_sweeps=sweeps),
        active=int(torch.count_nonzero(alpha)),
        converged=max_delta <= tol,
    )


def estimate_lipschitz(Xt: torch.Tensor, iters: int, v0=None, *, seed: int = 0) -> torch.Tensor:
    """Power iteration for L = ||X||_2^2 (largest eigenvalue of X^T X), a
    0-d float32 tensor on Xt's device. ``v0``: the start (the reference's
    ``normal(key, (p,))``); None draws ``random_start(p, seed)``."""
    X = _widened(Xt)
    p = X.shape[0]
    v = random_start(p, seed, X.device) if v0 is None else torch.as_tensor(
        v0, device=X.device).float()
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        w = torch.mv(X, torch.mv(X.t(), v))  # X^T (X v)
        v = w / torch.clamp_min(torch.linalg.vector_norm(w), 1e-30)
    w = torch.mv(X.t(), v)  # X v
    return torch.dot(w, w)  # Rayleigh quotient with unit v


def fista_solve(Xt, y, cfg: FISTAConfig, v0=None, alpha0=None, reg=None, *, device=None,
                seed: int = 0) -> SolveResult:
    """FISTA: prox = soft-threshold (penalized) or l1-ball projection
    (``cfg.constrained``). ``reg`` overrides cfg.lam / cfg.delta for path
    reuse; ``v0`` is the power iteration's start (``estimate_lipschitz``)."""
    Xt, y = prepare_dense(Xt, y, device)
    X = _widened(Xt)
    p = X.shape[0]
    reg = _build.f32((cfg.delta if cfg.constrained else cfg.lam) if reg is None else reg)
    L = estimate_lipschitz(X, cfg.power_iters, v0, seed=seed) * 1.05  # safety margin
    thr = reg / L
    alpha = _start(alpha0, p, X.device)
    z = alpha
    # t in float32 on the host, each op rounded as the reference's f32 ops
    one, t = np.float32(1.0), np.float32(1.0)
    tol = _build.f32(cfg.tol)
    step_inf, k = float("inf"), 0
    while k < cfg.max_iters and step_inf > tol:
        grad = torch.mv(X, torch.mv(X.t(), z) - y)  # X^T (X z - y): 2 matvecs = 2p unit dots
        v = z - grad / L
        alpha_new = project_l1_ball(v, reg) if cfg.constrained else soft_threshold(v, thr)
        t_new = np.float32(0.5) * (one + np.sqrt(one + np.float32(4.0) * (t * t)))
        diff = alpha_new - alpha
        z = alpha_new + float((t - one) / t_new) * diff
        # the stopping rule's step: one host read (a device sync) an iteration
        step_inf = float(torch.max(torch.abs(diff)))
        alpha, t, k = alpha_new, t_new, k + 1
    resid = y - torch.mv(X.t(), alpha)
    return SolveResult(
        alpha=alpha,
        objective=0.5 * torch.dot(resid, resid),
        iterations=k,
        n_dots=unit_dots(p, fista_iters=k, power_iters=cfg.power_iters),
        active=int(torch.count_nonzero(alpha)),
        converged=step_inf <= tol,
    )
