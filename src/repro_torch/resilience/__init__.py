"""Resilient solver runtime (the reference's ``resilience`` package).

Four layers, importable independently:

  * :mod:`repro_torch.resilience.faults`: seeded deterministic fault
    injection (the test harness; no-op hooks in production);
  * :mod:`repro_torch.resilience.guards`: the between-chunk numerical
    health watchdog and graceful-degradation ladder
    (``solve_resilient``), its check one launch of the ``health_flags``
    kernel on the kernels' backends;
  * :mod:`repro_torch.resilience.checkpoint`: atomic path
    checkpoint/resume packing for ``fw_path(..., resume_from=)``;
  * :mod:`repro_torch.resilience.validate`: early NaN/Inf input
    validation at the solver entry points.

Submodules load lazily (PEP 562): importing ``.faults`` or ``.validate``
never pulls the engine, so the low-level hooks stay cycle-free and cheap.
"""
from __future__ import annotations

_EXPORTS = {
    "FaultSpec": "faults",
    "FaultPlan": "faults",
    "InjectedKill": "faults",
    "inject": "faults",
    "active_plan": "faults",
    "GuardSpec": "guards",
    "UnrecoverableFaultError": "guards",
    "solve_resilient": "guards",
    "solve_resilient_sharded": "guards",
    "resilient_solve_fn": "guards",
    "fallback_config": "guards",
    "save_path_checkpoint": "checkpoint",
    "load_path_checkpoint": "checkpoint",
    "validate_inputs": "validate",
    "validation_enabled": "validate",
}

__all__ = sorted(_EXPORTS) + ["faults", "guards", "checkpoint", "validate"]


def __getattr__(name: str):
    import importlib

    if name in ("faults", "guards", "checkpoint", "validate"):
        return importlib.import_module(f"{__name__}.{name}")
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
