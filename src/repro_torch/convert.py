"""Carry the JAX reference's problem, config, state and index stream into
the port.

The system has no weights: what a caller carries across is the problem,
the config, a warm start or a mid-run state, and the sampled index
stream. Everything arrives as numpy arrays or plain dicts, so this module
imports nothing of the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine import EngineState, resolve_device
from repro_torch.core.fw_lasso import LassoCo
from repro_torch.core.solver_config import FWConfig
from repro_torch.core.vertex import StreamSampler

# the reference's backend words and their counterparts in the port
_BACKENDS = {"xla": "torch", "pallas": "kernels"}


def problem_from_numpy(Xt, y, device="cuda"):
    """``(Xt, y)`` as contiguous f32 tensors on ``device``."""
    dev = resolve_device(device)
    Xt = torch.from_numpy(np.ascontiguousarray(Xt, dtype=np.float32)).to(dev)
    y = torch.from_numpy(np.ascontiguousarray(y, dtype=np.float32)).to(dev)
    return Xt, y


def config_from_reference(fields: dict) -> FWConfig:
    """An ``FWConfig`` from the reference config's fields (for instance
    ``dataclasses.asdict(cfg)``): 'xla' becomes 'torch' and 'pallas'
    becomes 'kernels'; other backends raise."""
    fields = dict(fields)
    backend = fields.get("backend", "xla")
    if backend not in _BACKENDS:
        raise ValueError(
            f"only 'xla' and 'pallas' configs carry across, got {backend!r} "
            "('sparse' and 'distributed' are ROADMAP.md Queue 1 items 7 and 13)"
        )
    fields["backend"] = _BACKENDS[backend]
    unknown = set(fields) - {f.name for f in dataclasses.fields(FWConfig)}
    if unknown:
        raise ValueError(f"fields the port's FWConfig does not have: {sorted(unknown)}")
    return FWConfig(**fields)


def state_from_reference(arrays: dict, device="cuda") -> EngineState:
    """A lasso ``EngineState`` from the reference state's arrays, keyed by
    their names there: 'beta', 'scale', 'co.resid', 'co.s_quad',
    'co.f_lin', 'maxabs', 'step_inf', 'stall', 'n_dots', 'k'."""
    dev = resolve_device(device)

    def t(name, dtype=torch.float32):
        return torch.tensor(np.asarray(arrays[name]), dtype=dtype, device=dev)

    return EngineState(
        beta=t("beta"),
        scale=t("scale"),
        co=LassoCo(resid=t("co.resid"), s_quad=t("co.s_quad"), f_lin=t("co.f_lin")),
        maxabs=t("maxabs"),
        step_inf=t("step_inf"),
        stall=t("stall", torch.int32),
        n_dots=int(np.asarray(arrays["n_dots"])),
        k=int(np.asarray(arrays["k"])),
        i_star=torch.full((), -1, dtype=torch.int64, device=dev),
    )


def stream_from_reference(np_draws, device="cuda") -> StreamSampler:
    """A ``StreamSampler`` replaying the reference's ``(n_steps, k)`` draws
    (indices for 'uniform', block starts for 'block')."""
    dev = resolve_device(device)
    return StreamSampler(torch.tensor(np.asarray(np_draws), dtype=torch.int64, device=dev))
