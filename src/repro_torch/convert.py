"""Carry the JAX reference's problem, config, state and index stream into
the port.

The system has no weights: what a caller carries across is the problem,
the config, a warm start or a mid-run state (a baseline's result among
them), a telemetry ring, and the sampled index stream. Everything arrives as numpy arrays or plain dicts, so this module
imports nothing of the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import baselines
from repro_torch.core.engine import EngineState, resolve_device
from repro_torch.core.fw_elasticnet import ENCo
from repro_torch.core.fw_lasso import LassoCo
from repro_torch.core.fw_logistic import LogisticCo
from repro_torch.core.solver_config import FWConfig
from repro_torch.core.vertex import LaneStreamSampler, StreamSampler
from repro_torch.obs import telemetry as obs_telemetry
from repro_torch.sparse.matrix import SparseBlockMatrix

# the reference's backend words and their counterparts in the port
_BACKENDS = {"xla": "torch", "pallas": "kernels", "sparse": "sparse"}


def problem_from_numpy(Xt, y, device="cuda"):
    """``(Xt, y)`` as contiguous f32 tensors on ``device``."""
    dev = resolve_device(device)
    Xt = torch.from_numpy(np.ascontiguousarray(Xt, dtype=np.float32)).to(dev)
    y = torch.from_numpy(np.ascontiguousarray(y, dtype=np.float32)).to(dev)
    return Xt, y


def sparse_from_reference(values, rows, p: int, m: int, block_size: int, nnz_max: int,
                          device="cuda") -> SparseBlockMatrix:
    """The port's ``SparseBlockMatrix`` from the reference matrix's arrays
    (``np.asarray(mat.values)``, ``np.asarray(mat.rows)``) and its sizes."""
    dev = resolve_device(device)
    values = torch.tensor(np.asarray(values), device=dev)
    rows = torch.tensor(np.asarray(rows, dtype=np.int32), device=dev)
    if values.shape != rows.shape or values.shape[1:] != (block_size, nnz_max):
        raise ValueError(
            f"values and rows must be (nblocks, {block_size}, {nnz_max}), got "
            f"{tuple(values.shape)} and {tuple(rows.shape)}"
        )
    return SparseBlockMatrix(values=values, rows=rows, p=int(p), m=int(m),
                             block_size=int(block_size), nnz_max=int(nnz_max))


def config_from_reference(fields: dict) -> FWConfig:
    """An ``FWConfig`` from the reference config's fields (for instance
    ``dataclasses.asdict(cfg)``): 'xla' becomes 'torch', 'pallas' becomes
    'kernels' and 'sparse' keeps its name; 'distributed' raises."""
    fields = dict(fields)
    backend = fields.get("backend", "xla")
    if backend not in _BACKENDS:
        raise ValueError(
            f"the 'xla', 'pallas' and 'sparse' configs carry across, got {backend!r} "
            "('distributed' is ROADMAP.md Queue 1 item 13)"
        )
    fields["backend"] = _BACKENDS[backend]
    unknown = set(fields) - {f.name for f in dataclasses.fields(FWConfig)}
    if unknown:
        raise ValueError(f"fields the port's FWConfig does not have: {sorted(unknown)}")
    return FWConfig(**fields)


def state_from_reference(arrays: dict, device="cuda") -> EngineState:
    """An ``EngineState`` from the reference state's arrays, keyed by their
    names there: 'beta', 'scale', the co-state's fields, 'maxabs',
    'step_inf', 'stall', 'n_dots', 'k'. The co-state's keys say its oracle:
    'co.margin' the logistic's ``LogisticCo``; 'co.resid', 'co.s_quad',
    'co.f_lin' the lasso's ``LassoCo``, and with 'co.q_norm' the
    elastic-net's ``ENCo``. The step rule's state (``EngineState.rule``),
    where the reference state has one: 'rule.buffer' the away and pairwise
    rules' int32 active set (int64 in the port), 'rule.a_prev',
    'rule.v_prev', 'rule.drift' PARTAN's, 'rule.cache', 'rule.phi' the lazy
    rule's."""
    dev = resolve_device(device)

    def t(name, dtype=torch.float32):
        return torch.tensor(np.asarray(arrays[name]), dtype=dtype, device=dev)

    rule = ()
    if "rule.buffer" in arrays:
        rule = t("rule.buffer", torch.int64)
    elif "rule.a_prev" in arrays:
        rule = (t("rule.a_prev"), t("rule.v_prev"), t("rule.drift"))
    elif "rule.cache" in arrays:
        rule = (t("rule.cache", torch.int64), t("rule.phi"))

    if "co.margin" in arrays:
        co = LogisticCo(margin=t("co.margin"))
    elif "co.q_norm" in arrays:
        co = ENCo(resid=t("co.resid"), s_quad=t("co.s_quad"), f_lin=t("co.f_lin"),
                  q_norm=t("co.q_norm"))
    else:
        co = LassoCo(resid=t("co.resid"), s_quad=t("co.s_quad"), f_lin=t("co.f_lin"))
    return EngineState(
        beta=t("beta"),
        scale=t("scale"),
        co=co,
        maxabs=t("maxabs"),
        step_inf=t("step_inf"),
        stall=t("stall", torch.int32),
        n_dots=int(np.asarray(arrays["n_dots"])),
        k=int(np.asarray(arrays["k"])),
        i_star=torch.full((), -1, dtype=torch.int64, device=dev),
        rule=rule,
    )


def stream_from_reference(np_draws, device="cuda") -> StreamSampler:
    """A ``StreamSampler`` replaying the reference's ``(n_steps, k)`` draws
    (indices for 'uniform', block starts for 'block')."""
    dev = resolve_device(device)
    return StreamSampler(torch.tensor(np.asarray(np_draws), dtype=torch.int64, device=dev))


def lane_streams_from_reference(np_draws, device="cuda") -> LaneStreamSampler:
    """A ``LaneStreamSampler`` replaying the reference's per-lane draws: one
    ``(n_steps, k)`` array a lane (the scan of each lane's key, split off the
    chunk's key), in lane order."""
    dev = resolve_device(device)
    return LaneStreamSampler([torch.tensor(np.asarray(d), dtype=torch.int64, device=dev)
                              for d in np_draws])


def baseline_from_reference(arrays: dict, device="cuda") -> baselines.SolveResult:
    """A baselines ``SolveResult`` from a reference ``cd_solve`` or
    ``fista_solve`` result's arrays (``{k: np.asarray(v) for k, v in
    res._asdict().items()}``). Only 'alpha' is required, so a reference warm
    start alone carries across too: its ``.alpha`` (float32) is the
    ``alpha0`` the port's solvers take; 'objective', 'iterations', 'n_dots',
    'active' and 'converged' default to NaN, 0, 0, alpha's support and
    False. The counts become Python ints."""
    dev = resolve_device(device)
    alpha = torch.tensor(np.asarray(arrays["alpha"], dtype=np.float32), device=dev)
    return baselines.SolveResult(
        alpha=alpha,
        objective=torch.tensor(float(np.asarray(arrays.get("objective", np.nan))),
                               dtype=torch.float32, device=dev),
        iterations=int(np.asarray(arrays.get("iterations", 0))),
        n_dots=int(np.asarray(arrays.get("n_dots", 0))),
        active=int(np.asarray(arrays["active"])) if "active" in arrays
        else int(torch.count_nonzero(alpha)),
        converged=bool(np.asarray(arrays.get("converged", False))),
    )


def telemetry_from_reference(arrays: dict, device="cuda") -> obs_telemetry.TelemetryRing:
    """The port's ``TelemetryRing`` from a reference ring's numpy leaves,
    keyed by its field names (``{k: np.asarray(v) for k, v in
    ring._asdict().items()}``): 'cursor', 'flushed' and the record fields
    of ``obs.telemetry.RECORD_FIELDS``. A leading lane axis (a batched
    result's ring) gives a lane ring. The reference's float32 ``n_dots``
    becomes int64 (its empty slots' NaN -1)."""
    dev = resolve_device(device)
    cursor = np.asarray(arrays["cursor"])
    lanes = None if cursor.ndim == 0 else int(cursor.shape[0])
    capacity = int(np.asarray(arrays["k"]).shape[-1])
    ring = obs_telemetry.init_ring(obs_telemetry.TelemetrySpec(capacity=capacity), dev, lanes)
    for name in obs_telemetry.RECORD_FIELDS:
        value = np.asarray(arrays[name])
        if name == "n_dots":
            value = np.where(np.isnan(value), -1, value).astype(np.int64)
        dst = ring.field(name)
        dst.copy_(torch.from_numpy(np.ascontiguousarray(value)).to(dst.dtype))
    if lanes is None:
        return ring._replace(cursor=int(cursor), flushed=int(np.asarray(arrays["flushed"])))
    return ring._replace(cursor=[int(c) for c in cursor],
                         flushed=[int(f) for f in np.asarray(arrays["flushed"])],
                         dev_cursor=torch.tensor(cursor.astype(np.int64), device=dev))
