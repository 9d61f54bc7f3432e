"""Roofline terms of a step from its dry run (the port of
``repro.analysis.roofline``).

Three terms per (arch x mesh), in seconds:
  compute    = FLOPs_per_device / peak_FLOPs_per_chip
  memory     = bytes_per_device / HBM_bandwidth
  collective = wire_bytes_per_device / network_link_bandwidth

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` and the
collectives from the optimized HLO text (``parse_collectives``, kept here
for the same text). The port has no compiled module: its dry run runs the
step once on fake tensors under DTensor, and ``CostMode`` counts what each
rank's local ops do (``tally_collectives`` gives the collectives alone).
The wire-cost factors are the reference's (ring algorithms):
  all-reduce      2 x result bytes
  all-gather      result bytes (the gathered size)
  reduce-scatter  result bytes (a lower bound: the input is N x the result)
  all-to-all      result bytes
  collective-permute  result bytes
"""
from __future__ import annotations

import re
import threading
import weakref
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# NVIDIA H100 SXM 80GB HBM3 at 700 W, from its data sheet:
#   peak_flops  bf16 dense tensor-core FLOP/s per GPU;
#   hbm_bw      HBM3 bytes/s;
#   ici_bw      one 400 Gb/s NDR InfiniBand port per GPU, in bytes/s. A 16-wide
#               "model" axis spans two 8-GPU HGX nodes, so the network and not
#               NVLink (450 GB/s each way) is the slowest link that axis crosses.
H100 = {
    "peak_flops": 989e12,
    "hbm_bw": 3.35e12,
    "ici_bw": 50e9,
}

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")

_COLLECTIVE_OPS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# wire bytes per result byte, by kind
_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}


def _shape_bytes(type_str: str) -> int:
    """Sum byte sizes of every shape literal in an HLO result-type string."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(type_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def _empty_tallies() -> Dict[str, Dict[str, float]]:
    return {k: {"count": 0, "result_bytes": 0.0, "wire_bytes": 0.0} for k in _COLLECTIVE_OPS}


def parse_collectives(hlo_text: str) -> Dict[str, Dict[str, float]]:
    """Per-op-kind tallies of an optimized HLO module's text: {kind: {count,
    result_bytes, wire_bytes}} (shapes are per device)."""
    out = _empty_tallies()
    for line in hlo_text.splitlines():
        m = re.match(r"%?[\w.\-]+\s*=\s*(.+)$", line.strip())
        if not m:
            continue
        rhs = m.group(1)
        for kind in _COLLECTIVE_OPS:
            # match ` <type> kind(` — avoid -start/-done fusion suffixes
            opm = re.match(rf"^(\(?[\w\[\],\s{{}}]+\)?)\s+{kind}(-start)?\(", rhs)
            if opm:
                rbytes = _shape_bytes(opm.group(1))
                out[kind]["count"] += 1
                out[kind]["result_bytes"] += rbytes
                out[kind]["wire_bytes"] += _WIRE_FACTOR[kind] * rbytes
                break
    return out


def collective_bytes(hlo_text: str) -> float:
    tallies = parse_collectives(hlo_text)
    return sum(v["wire_bytes"] for v in tallies.values())


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    collectives: Dict[str, Dict[str, float]] = field(default_factory=dict)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> Dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "dominant": self.dominant,
            "collectives": self.collectives,
        }


def terms_from_counts(flops: float, bytes_accessed: float, tallies: Dict,
                      hw: Dict = H100) -> RooflineTerms:
    """The three terms of one device's FLOPs, bytes and collective tallies."""
    wire = sum(v["wire_bytes"] for v in tallies.values())
    return RooflineTerms(
        compute_s=flops / hw["peak_flops"],
        memory_s=bytes_accessed / hw["hbm_bw"],
        collective_s=wire / hw["ici_bw"],
        flops_per_device=flops,
        bytes_per_device=bytes_accessed,
        wire_bytes_per_device=wire,
        collectives=tallies,
    )


def roofline_terms(cost: Dict, hlo_text: str, hw: Dict = H100) -> RooflineTerms:
    """The terms of a cost dict ('flops', 'bytes accessed') and an HLO text's
    collectives."""
    return terms_from_counts(float(cost.get("flops", 0.0)), float(cost.get("bytes accessed", 0.0)),
                             parse_collectives(hlo_text), hw)


# ---------------------------------------------------------------------------
# Counting one rank's local ops (the port's cost analysis)
# ---------------------------------------------------------------------------

_COLLECTIVE_KIND = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
# ops that move no data of their own: allocation without a write, waits
_NO_BYTES = {"empty", "empty_strided", "empty_like", "wait_tensor", "detach", "lift_fresh",
             "_local_scalar_dense", "alias", "set_"}

_STATE = threading.local()  # .propagating: DTensor is deriving a global shape


def _propagating() -> bool:
    return getattr(_STATE, "propagating", 0) > 0


def _patch_sharding_propagation() -> None:
    """DTensor derives each op's global output shape by running the op on
    fake tensors of the global shapes (``ShardingPropagator.
    _propagate_tensor_meta_non_cached``), under the caller's fake mode
    and so in sight of a dispatch mode. Those runs are not the rank's
    work: mark them so that ``CostMode`` skips them. Done once a process."""
    from torch.distributed.tensor import _sharding_prop as sp

    prop = sp.ShardingPropagator
    inner = getattr(prop, "_propagate_tensor_meta_non_cached", None)
    if inner is None or getattr(inner, "_cost_mode_marked", False):
        return

    def marked(self, op_schema):
        _STATE.propagating = getattr(_STATE, "propagating", 0) + 1
        try:
            return inner(self, op_schema)
        finally:
            _STATE.propagating -= 1

    marked._cost_mode_marked = True
    prop._propagate_tensor_meta_non_cached = marked


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(args) -> int:
    """The rank count of a functional collective's group (its last str
    argument, the group's name)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    names = [a for a in args if isinstance(a, str)]
    if not names:
        return 2
    try:
        return _resolve_process_group(names[-1]).size()
    except Exception:  # noqa: BLE001 — an unknown group counts as a real one
        return 2


class CostMode(TorchDispatchMode):
    """Counts one rank's work below DTensor: each op on a local tensor
    (a DTensor op returns ``NotImplemented`` here, so DTensor runs it and
    its local ops and collectives come back to this mode).

    * ``flops``: what ``torch.utils.flop_counter`` counts (matrix products,
      convolutions, attention kernels), on the local shapes;
    * ``bytes``: eager's traffic, each non-view op's tensor operands read
      and its results written (a collective's are in ``tallies``);
    * ``tallies``: the functional collectives by the reference's kinds, one
      rank's result bytes and the wire factors above; a collective over a
      group of one rank moves nothing and is not counted;
    * ``peak_bytes``: the most bytes the tensors made under the mode held at
      once (a storage counts from the op that made it until it is freed).

    DTensor's global-shape propagation runs are not counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.tallies = _empty_tallies()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        _patch_sharding_propagation()

    def _track(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except Exception:  # noqa: BLE001 — a tensor without storage holds none
            return
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator):
            return out
        if _propagating():
            return out
        packet = func._overloadpacket
        name = packet.__name__
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if getattr(packet, "_qualified_op_name", "").startswith("_c10d_functional::"):
            kind = _COLLECTIVE_KIND.get(name)
            if kind is not None and _group_size(args) > 1:
                rbytes = float(sum(_tensor_bytes(t) for t in outs))
                tally = self.tallies[kind]
                tally["count"] += 1
                tally["result_bytes"] += rbytes
                tally["wire_bytes"] += _WIRE_FACTOR[kind] * rbytes
            if name != "wait_tensor":  # fake mode's wait makes a new tensor; eager's does not
                for t in outs:
                    self._track(t)
            return out
        if packet in self._flop_registry:
            self.flops += float(self._flop_registry[packet](*args, **kwargs, out_val=out))
        if not func.is_view and name not in _NO_BYTES and func.namespace == "aten":
            ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
            self.bytes += float(sum(_tensor_bytes(t) for t in ins + outs))
        if not any(r.alias_info for r in func._schema.returns):  # not a view, not in place
            for t in outs:
                self._track(t)
        return out

    def terms(self, hw: Dict = H100) -> RooflineTerms:
        return terms_from_counts(self.flops, self.bytes, self.tallies, hw)


def tally_collectives(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), its collective tallies)``: the functional
    collectives that DTensor issues while ``fn`` runs, in the layout of
    ``parse_collectives`` ({kind: {count, result_bytes, wire_bytes}}, one
    rank's bytes)."""
    with CostMode() as mode:
        out = fn(*args, **kwargs)
    return out, mode.tallies


# ---------------------------------------------------------------------------
# Model FLOPs and parameter counts
# ---------------------------------------------------------------------------


def model_flops(cfg, shape_kind: str, seq_len: int, global_batch: int) -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N D (inference), N = active params."""
    n_active = active_params(cfg)
    if shape_kind == "train":
        tokens = seq_len * global_batch
        return 6.0 * n_active * tokens
    if shape_kind == "prefill":
        tokens = seq_len * global_batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * global_batch


def _param_count(cfg, experts_counted) -> float:
    d, L = cfg.d_model, cfg.n_layers
    hd = cfg.resolved_head_dim
    attn = d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2  # wq, wo; wk, wv
    total = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    for i in range(L):
        layer = 0
        if cfg.family != "ssm":
            layer += attn
        if cfg.family in ("ssm", "hybrid"):
            di = cfg.d_inner
            layer += d * (2 * di + 2 * cfg.ssm_state + cfg.ssm_heads)
            layer += di * d
        if cfg.is_moe_layer(i):
            f = cfg.moe_d_ff or cfg.d_ff
            layer += experts_counted * 3 * d * f
            layer += cfg.n_shared_experts * 3 * d * f
            if cfg.moe_dense_residual:
                layer += 3 * d * cfg.d_ff
        elif cfg.d_ff:
            layer += 3 * d * cfg.d_ff
        total += layer
    if cfg.n_enc_layers:
        total += cfg.n_enc_layers * (attn + 3 * d * cfg.d_ff)
        total += L * attn  # cross attention
    return float(total)


def active_params(cfg) -> float:
    """Parameter count excluding non-routed experts (MoE: top-k active)."""
    return _param_count(cfg, cfg.experts_per_token)


def total_params(cfg) -> float:
    """All parameters (MoE: every expert)."""
    return _param_count(cfg, cfg.n_experts)
