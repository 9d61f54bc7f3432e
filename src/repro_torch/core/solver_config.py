"""Frozen solver configs (the reference's ``core/solver_config.py``): the
FW solver's and the baselines' (``CDConfig``, ``FISTAConfig``, with the
reference's fields and defaults)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# obs.telemetry is import-clean of repro_torch.core, so the spec can live
# with the config
from repro_torch.obs.telemetry import TelemetrySpec


@dataclass(frozen=True)
class DistSpec:
    """Sharding vocabulary of the distributed backend, kept as the type of
    ``FWConfig.dist``. The distributed backend is not ported yet
    (ROADMAP.md Queue 1 item 13)."""

    n_data: int = 1
    n_model: int = 1
    data_axis: str = "data"
    model_axis: str = "model"


# 'torch' (plain PyTorch ops) pairs with the reference's 'xla'; 'kernels'
# (the hand-written Hopper kernels) pairs with 'pallas'
VALID_BACKENDS = ("torch", "kernels", "sparse", "distributed")
VALID_STEP_RULES = ("classic", "away", "pairwise", "partan", "lazy")


@dataclass(frozen=True)
class FWConfig:
    """Configuration of the stochastic Frank-Wolfe Lasso solver.

    The fields, defaults and validation are the reference's, with these
    differences:

      backend: 'kernels' (default) runs the hot loop through the Hopper
        kernels of ``repro_torch.kernels`` (their plain versions when the
        tensors lie on the CPU); 'torch' runs plain PyTorch ops; 'sparse'
        runs on a ``repro_torch.sparse.SparseBlockMatrix`` (block-ELL)
        through the sparse kernels K5-K7. 'distributed' is a valid word
        that the solver does not run yet (ROADMAP.md Queue 1 item 13).
      sparse_kernel: on 'sparse', None (default) and True run the Hopper
        kernels (their plain versions on CPU tensors), False the plain
        PyTorch ops on any device (the reference's XLA-gather path). The
        reference's None means "the kernel on a TPU only".
      m_tile, interpret, gather_mode: TPU knobs of the reference, kept so
        configs carry across; the port reads none ('onehot' is a TPU
        lowering fallback).
      telemetry: the per-iteration metric ring's spec
        (``repro_torch.obs.TelemetrySpec``). None (default) means no ring:
        the loop launches what it launched before, bit for bit. When set,
        ``EngineState.tel`` carries the ring, surfaced on
        ``SolveResult.telemetry``; the trajectory is the telemetry-off one,
        bit for bit, on every backend, rule, oracle and fused route.
      fuse_steps: K consecutive FW iterations per dispatch. 1 (default) is
        the one-step-per-dispatch loop. K > 1 makes ``engine.run_loop``
        advance K-step chunks: the co-state and the scalar recursions stay
        on the device across K steps (the ``kernels/fused_step`` kernel on
        'kernels' and on 'sparse' with its kernels on, K unfused engine
        steps otherwise) and the §Stopping rule is checked on the host
        BETWEEN chunks, so a stall/patience stop lands on a chunk boundary,
        K-1 iterations after the unfused stop at most while the stall
        streak lasts to it (max_iters is still exact: trailing chunk steps
        are masked).
        Fusion engages for the lasso and the elastic-net oracles under
        'uniform' sampling, where the K x kappa index stream can be drawn
        ahead of the chunk; the other sampling modes, and the logistic
        oracle (no closed-form line search), fall back to fuse_steps=1
        semantics (``SolveResult.effective_fuse_steps`` says what ran).
      step_rule: the FW step variant, run on every backend and oracle
        (``core.step_rule``): 'classic' (default, the paper's Algorithm-2
        step), 'away' (away steps over a tracked active set), 'pairwise'
        (mass moved from the away atom onto the FW atom), 'partan' (each FW
        step extrapolated against the previous iterate) and 'lazy' (a cache
        of recent winners re-scored before a fresh draw). A rule other than
        'classic' runs the per-step loop under ``fuse_steps > 1`` (with a
        warning) and has no batched lanes yet (ROADMAP.md Queue 1 item 9a).
      active_set_size: the 'away'/'pairwise' buffer's capacity (the
        weakest-|beta| slot is evicted when a new FW atom enters a full one).
      lazy_cache: the 'lazy' rule's winner-cache capacity.
    """

    delta: float
    kappa: int = 194  # paper's top-2%/98% confidence default
    sampling: str = "uniform"
    block_size: int = 128
    max_iters: int = 50_000
    tol: float = 1e-3
    patience: int = 20  # consecutive sub-tol steps before stopping (stochastic)
    refresh_every: int = 64  # recompute S/F from residuals (fp32 drift control)
    eps_den: float = 1e-12
    renorm_threshold: float = 1e-6
    gap_rtol: float = 1e-6
    backend: str = "kernels"
    fuse_steps: int = 1
    sparse_kernel: Optional[bool] = None
    gather_mode: str = "auto"
    report_gap: bool = False
    m_tile: int = 512
    interpret: Optional[bool] = None
    dist: Optional[DistSpec] = None
    step_rule: str = "classic"
    active_set_size: int = 32
    lazy_cache: int = 16
    telemetry: Optional[TelemetrySpec] = None

    def __post_init__(self):
        if self.backend not in VALID_BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; valid choices: "
                f"{', '.join(VALID_BACKENDS)}"
            )
        if self.step_rule not in VALID_STEP_RULES:
            raise ValueError(
                f"unknown step_rule {self.step_rule!r}; valid choices: "
                f"{', '.join(VALID_STEP_RULES)}"
            )


@dataclass(frozen=True)
class CDConfig:
    """Cyclic / stochastic coordinate descent (penalized form, Glmnet-style)."""

    lam: float
    max_sweeps: int = 1000
    tol: float = 1e-3
    stochastic: bool = False


@dataclass(frozen=True)
class FISTAConfig:
    """FISTA on the penalized form; 'constrained' switches to l1-ball projection."""

    lam: float = 0.0
    delta: float = 0.0
    constrained: bool = False
    max_iters: int = 2000
    tol: float = 1e-3
    power_iters: int = 50  # Lipschitz estimation
