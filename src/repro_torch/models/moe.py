"""Mixture-of-Experts with grouped, capacity-bounded token routing (the
port of ``repro.models.moe``).

The reference's "dropping" routing, group by group (a group is a batch
entry):
  * each group owns capacity = ceil(tokens_per_group * top_k * cf / E);
    assignments past it are dropped;
  * expert weights are stacked (E, D, F) and run as batched products over
    the experts, every expert on its capacity's slots;
  * top-k gates renormalized (DeepSeek-style), optional shared experts
    (kimi) and a dense parallel residual (arctic).

Ties route as ``jax.lax.top_k`` routes them (the lower expert first): the
top-k comes from a stable descending sort. A kept assignment owns a slot
no other assignment writes, so dispatch writes rows and adds nothing; the
dropped ones share one overflow slot that nothing reads. No kept row's
bits depend on the order of atomics.

Decode shapes (one token per sequence) route with a generous capacity
floor (cfg.min_capacity) so collisions do not drop tokens in practice.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models import sharding as sh_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (MLP, _activation, _dtype, _normal, _param, apply_mlp,
                                       dense_init, init_mlp)


class MoE(nn.Module):
    """``router`` (D, E) f32, ``w_gate``/``w_up`` (E, D, F), ``w_down``
    (E, F, D); ``shared`` and ``dense`` MLPs where the config has them."""

    def __init__(self, router, w_gate, w_up, w_down, shared: MLP | None = None,
                 dense: MLP | None = None):
        super().__init__()
        self.router, self.w_gate = _param(router), _param(w_gate)
        self.w_up, self.w_down = _param(w_up), _param(w_down)
        self.shared, self.dense = shared, dense


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> MoE:
    dt = _dtype(cfg)
    E, D, F = cfg.n_experts, cfg.d_model, cfg.moe_d_ff or cfg.d_ff
    scale_in = 1.0 / math.sqrt(D)
    scale_out = 1.0 / math.sqrt(F)
    router = dense_init(gen, D, E, torch.float32)  # fp32 routing logits
    w_gate = _normal(gen, (E, D, F), scale_in, dt)
    w_up = _normal(gen, (E, D, F), scale_in, dt)
    w_down = _normal(gen, (E, F, D), scale_out, dt)
    shared = (init_mlp(gen, cfg, d_ff=(cfg.moe_d_ff or cfg.d_ff) * cfg.n_shared_experts)
              if cfg.n_shared_experts else None)
    dense = init_mlp(gen, cfg, d_ff=cfg.d_ff) if cfg.moe_dense_residual else None
    return MoE(router, w_gate, w_up, w_down, shared, dense)


def _capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    cap = math.ceil(tokens_per_group * cfg.experts_per_token * cfg.capacity_factor / cfg.n_experts)
    return max(cap, cfg.min_capacity)


def _route(params: MoE, x: torch.Tensor, cfg: ModelConfig):
    """The routing: (gates (B, S, K) renormalized, expert ids (B, S, K),
    router logits (B, S, E))."""
    return _route_by(params.router, x, cfg)


def _route_by(router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig):
    K = cfg.experts_per_token
    logits = x.float() @ router  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[..., :K], idx[..., :K]
    gate_vals = gate_vals / torch.clamp(torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)
    return gate_vals, expert_idx, logits


def _positions(expert_idx: torch.Tensor, E: int) -> torch.Tensor:
    """Each assignment's position in its expert's queue, (B, S, K): the
    count of the group's earlier assignments (in (s, k) order) to the same
    expert, from a stable per-group sort."""
    Bsz, S, K = expert_idx.shape
    T = S * K
    dev = expert_idx.device
    flat_e = expert_idx.reshape(Bsz, T)  # (B, T) expert id per assignment
    order = torch.argsort(flat_e, dim=-1, stable=True)  # (B, T)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((Bsz, E), dtype=torch.int64, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, dim=-1) - counts  # (B, E)
    pos_sorted = torch.arange(T, device=dev)[None, :] - torch.gather(offsets, 1, sorted_e)
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)  # assignment order
    return pos.reshape(Bsz, S, K)


def _dispatch(router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig):
    """Routing, positions and the dispatch, group by group: (expert_in (B, E,
    C, D), dest (B, T), keep (B, S, K), gates (B, S, K))."""
    Bsz, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    C = _capacity(S, cfg)
    dev = x.device

    # ---- routing (fp32) ----------------------------------------------------
    gate_vals, expert_idx, _ = _route_by(router, x, cfg)

    # ---- position-in-expert; past capacity -> the overflow slot -------------
    pos = _positions(expert_idx, E)
    T = S * K
    keep = pos < C  # dropped assignments
    dest = torch.where(keep, expert_idx * C + pos, E * C)  # overflow slot

    # ---- dispatch: (B, S, D) -> (B, E*C+1, D), a write a kept slot ----------
    slots = E * C + 1
    row = (torch.arange(Bsz, device=dev)[:, None] * slots + dest.reshape(Bsz, T)).reshape(-1)
    src = x[:, :, None, :].expand(Bsz, S, K, D).reshape(Bsz * T, D)
    buf = torch.zeros((Bsz * slots, D), dtype=x.dtype, device=dev)
    buf.index_copy_(0, row, src)  # kept rows unique; the overflow slot is never read
    expert_in = buf.view(Bsz, slots, D)[:, :E * C].reshape(Bsz, E, C, D)
    return expert_in, dest.reshape(Bsz, T), keep, gate_vals


def _combine(expert_out: torch.Tensor, dest: torch.Tensor, keep: torch.Tensor,
             gate_vals: torch.Tensor) -> torch.Tensor:
    """Gather each assignment's expert output back and weight it by its
    gate: (B, S, D)."""
    Bsz, E, C, D = expert_out.shape
    S, K = keep.shape[1], keep.shape[2]
    T = S * K
    flat_out = torch.cat([expert_out.reshape(Bsz, E * C, D),
                          torch.zeros((Bsz, 1, D), dtype=expert_out.dtype,
                                      device=expert_out.device)], dim=1)
    gathered = torch.gather(flat_out, 1, dest.reshape(Bsz, T, 1).expand(Bsz, T, D))
    gathered = gathered.reshape(Bsz, S, K, D)
    w = torch.where(keep, gate_vals, 0.0).to(expert_out.dtype)
    return (w[..., None, :] @ gathered)[..., 0, :]  # sum over k, accumulated as a product


def _by_group(x: torch.Tensor, cfg: ModelConfig):
    """``(_dispatch, _combine)``, each run on every rank's own groups where
    ``x`` is a DTensor: the routing's sorts, counts and scatters have no
    sharding rule of DTensor's, and a group (a batch entry) routes alone, so
    each rank runs them on its batch rows (the reference's constraint puts
    the batch over the data axes) with the router whole. The router's
    gradient is then a sum over those axes (``Partial``)."""
    if not isinstance(x, DTensor):
        return functools.partial(_dispatch, cfg=cfg), _combine
    mesh = x.device_mesh
    rows = sh_lib.act_placements(tuple(x.shape), ("batch", None, None), mesh)
    whole = [Replicate()] * mesh.ndim
    summed = [Partial() if isinstance(p, Shard) else Replicate() for p in rows]
    dispatch = local_map(functools.partial(_dispatch, cfg=cfg),
                         out_placements=(rows, rows, rows, rows), in_placements=(whole, rows),
                         in_grad_placements=(summed, rows), device_mesh=mesh,
                         redistribute_inputs=True)
    combine = local_map(_combine, out_placements=rows, in_placements=(rows, rows, rows, rows),
                        device_mesh=mesh, redistribute_inputs=True)
    return dispatch, combine


def apply_moe(params: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, D). Groups = batch entries."""
    Bsz, S, D = x.shape
    E = cfg.n_experts
    C = _capacity(S, cfg)
    dispatch, combine = _by_group(x, cfg)
    expert_in, dest, keep, gate_vals = dispatch(params.router, x)

    # ---- expert computation: batched over the experts -----------------------
    # under weight-stationary rules the constraint shards the dispatch
    # buffer's expert dim over 'model' (the EP all-to-all) so expert weights
    # never move; baseline rules make it a no-op
    expert_in = sh_lib.constrain(expert_in, "batch", "experts_act", None, None)
    act = _activation(cfg.act)
    ein = expert_in.permute(1, 0, 2, 3).reshape(E, Bsz * C, D)
    h = act(torch.bmm(ein, params.w_gate)) * torch.bmm(ein, params.w_up)
    expert_out = torch.bmm(h, params.w_down).reshape(E, Bsz, C, D).permute(1, 0, 2, 3)
    expert_out = sh_lib.constrain(expert_out, "batch", "experts_act", None, None)

    # ---- combine: gather back + weight by gates ------------------------------
    y = combine(expert_out, dest, keep, gate_vals)

    # ---- always-on branches --------------------------------------------------
    if cfg.n_shared_experts:
        y = y + apply_mlp(params.shared, x, cfg)
    if cfg.moe_dense_residual:
        y = y + apply_mlp(params.dense, x, cfg)
    return y


def load_balance_loss(logits: torch.Tensor, expert_idx: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """Switch-style auxiliary loss (fraction routed x mean router prob)."""
    E = cfg.n_experts
    probs = torch.softmax(logits.float(), dim=-1)
    me = torch.mean(probs.reshape(-1, E), dim=0)
    onehot = torch.nn.functional.one_hot(expert_idx.reshape(-1).long(), E).float()
    ce = torch.mean(onehot, dim=0) * E
    return torch.sum(me * ce)
