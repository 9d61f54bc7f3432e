"""Optimizers from scratch: AdamW (f32 state) and Adafactor (factored)
(the port of ``repro.training.optimizers``).

AdamW keeps f32 m/v plus an f32 master copy when parameters are low
precision, the production recipe for <=80B configs. Adafactor keeps
factored second moments and no master copy, which is what lets the
0.5T-1T configs (arctic, kimi) fit.

The state is the reference's, leaf for leaf and shape for shape: a leaf
is a parameter of the reference's tree, keyed by its ``/``-joined path
there (``"layers/attn/wq"``). The port's model keeps a layer stack's
blocks as modules of their own (``layers.0.attn.wq``, ...), so the
blocks' tensors of one path make one leaf, stacked on a leading layer
axis, as the reference's ``lax.scan`` stack has them: Adafactor's
factoring and its RMS clip read the stacked leaf, and AdamW (elementwise)
moves each block's slice of it. A dict of tensors (nested or not) is a
tree of plain leaves. Every update is made in place under
``torch.no_grad()``, each f32 operation in the reference's order.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Shard

from repro_torch.utils.trees import tree_map

_CHUNK = 1 << 24  # elements an AdamW update handles at once (bounds its f32 temporaries)


class OptState(NamedTuple):
    step: torch.Tensor  # int32, 0-dim, on the parameters' device
    inner: Dict[str, Any]  # leaf path -> AdamLeaf | FactorLeaf


# ---------------------------------------------------------------------------
# Leaves: the reference's tree paths of a model's parameters
# ---------------------------------------------------------------------------


def named_leaves(tree) -> Dict[str, torch.Tensor]:
    """The tensors of ``tree`` by name: an ``nn.Module``'s parameters by
    their module names, a dict's leaves by their ``/``-joined paths (a flat
    dict keyed by parameter names is its own result, so gradients keyed
    as the module names them read the same)."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    out: Dict[str, torch.Tensor] = {}

    def walk(t, prefix):
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], prefix + (str(k),))
        else:
            out["/".join(prefix)] = t

    walk(tree, ())
    return out


def _path_of(name: str, module: bool) -> Tuple[str, int | None]:
    """A parameter's leaf path in the reference's tree and its layer (None
    outside a layer stack): ``layers.3.attn.wq`` -> ("layers/attn/wq", 3)."""
    if not module:
        return name, None
    parts = name.split(".")
    for i in range(len(parts) - 1):
        if parts[i + 1].isdigit():  # a block of a stack (layers, prefix_layers)
            return "/".join(parts[:i + 1] + parts[i + 2:]), int(parts[i + 1])
    return "/".join(parts), None


def leaf_groups(params) -> Dict[str, Tuple[List[str], bool]]:
    """Leaf path -> (the names of its tensors in layer order, stacked),
    in the reference's flatten order (sorted paths)."""
    module = isinstance(params, nn.Module)
    groups: Dict[str, List[Tuple[int, str]]] = {}
    stacked: Dict[str, bool] = {}
    for name in named_leaves(params):
        path, layer = _path_of(name, module)
        groups.setdefault(path, []).append((layer or 0, name))
        stacked[path] = layer is not None
    return {path: ([n for _, n in sorted(groups[path])], stacked[path])
            for path in sorted(groups, key=lambda p: p.split("/"))}


def _full_shape(tensors: List[torch.Tensor], stacked: bool) -> Tuple[int, ...]:
    return ((len(tensors),) if stacked else ()) + tuple(tensors[0].shape)


def _slices(x: torch.Tensor, stacked: bool) -> List[torch.Tensor]:
    """A leaf's state as one view a tensor of the group."""
    return list(x.unbind(0)) if stacked else [x]


def _empty_f32(tensors: List[torch.Tensor], stacked: bool) -> torch.Tensor:
    """An f32 tensor of the leaf's shape; for DTensors, laid out as they are
    (behind the stack's leading axis), each rank allocating its shard."""
    from repro_torch.models.sharding import contiguous_stride

    shape = _full_shape(tensors, stacked)
    t = tensors[0]
    if not isinstance(t, DTensor):
        return torch.empty(shape, dtype=torch.float32, device=t.device)
    plc = [Shard(p.dim + 1) if stacked and isinstance(p, Shard) else p for p in t.placements]
    loc = t.to_local()
    local = ((len(tensors),) if stacked else ()) + tuple(loc.shape)
    return DTensor.from_local(torch.empty(local, dtype=torch.float32, device=loc.device),
                              t.device_mesh, plc, run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def _stack_f32(tensors: List[torch.Tensor], stacked: bool) -> torch.Tensor:
    out = _empty_f32(tensors, stacked)
    for dst, t in zip(_slices(out, stacked), tensors):
        dst.copy_(t.detach())
    return out


def _step_tensor(params) -> torch.Tensor:
    dev = next(iter(named_leaves(params).values())).device
    return torch.zeros((), dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


class AdamLeaf(NamedTuple):
    m: torch.Tensor  # f32
    v: torch.Tensor  # f32
    master: torch.Tensor  # f32 master weights ((1,) placeholder for f32 params
    # — they are their own master; avoids a redundant copy)


@torch.no_grad()
def adamw_init(params) -> OptState:
    leaves = named_leaves(params)
    inner = {}
    for path, (names, stacked) in leaf_groups(params).items():
        ts = [leaves[n] for n in names]
        shape, dev = _full_shape(ts, stacked), ts[0].device
        if ts[0].dtype == torch.float32:
            master = torch.zeros((1,), dtype=torch.float32, device=dev)  # placeholder
        else:
            master = _stack_f32(ts, stacked)
        inner[path] = AdamLeaf(m=torch.zeros(shape, dtype=torch.float32, device=dev),
                               v=torch.zeros(shape, dtype=torch.float32, device=dev),
                               master=master)
    return OptState(step=_step_tensor(params), inner=inner)


def _adamw_piece(g, m, v, master, p, lr, bc1, bc2, b1, b2, eps, weight_decay):
    """One slice of a leaf, in place: the reference's ``leaf`` op for op."""
    gf = g.float()
    m.mul_(b1).add_((1 - b1) * gf)
    v.mul_(b2).add_((1 - b2) * gf * gf)
    update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    mst = p.float() if master is None else master
    new = mst - lr * (update + weight_decay * mst)
    if master is not None:
        master.copy_(new)
    p.copy_(new)


def _pieces(t: torch.Tensor) -> List[torch.Tensor]:
    """Row blocks of ``t`` of at most _CHUNK elements (views); a DTensor
    whole (its rank's shard bounds the temporaries, and a split of a
    sharded dim would gather it)."""
    if t.dim() == 0 or t.numel() <= _CHUNK or isinstance(t, DTensor):
        return [t]
    rows = max(1, _CHUNK // max(1, t[0].numel()))
    return list(torch.split(t, rows, dim=0))


@torch.no_grad()
def adamw_update(grads, state: OptState, params, lr, *, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1):
    """One AdamW step in place; returns ``(params, new state)`` (the same
    parameter and state tensors, the step advanced)."""
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    leaves, gl = named_leaves(params), named_leaves(grads)
    for path, (names, stacked) in leaf_groups(params).items():
        s = state.inner[path]
        ts = [leaves[n] for n in names]
        placeholder = ts[0].dtype == torch.float32  # its own master
        ms = _slices(s.m, stacked)
        vs = _slices(s.v, stacked)
        masters = [None] * len(ts) if placeholder else _slices(s.master, stacked)
        for n, p, m, v, mst in zip(names, ts, ms, vs, masters):
            g = gl[n]
            parts = [_pieces(x) for x in (g, m, v, p)]
            parts.append([None] * len(parts[0]) if mst is None else _pieces(mst))
            for gp, mp, vp, pp, sp in zip(parts[0], parts[1], parts[2], parts[3], parts[4]):
                _adamw_piece(gp, mp, vp, sp, pp, lr, bc1, bc2, b1, b2, eps, weight_decay)
    return params, OptState(step=step, inner=state.inner)


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018), simplified: factored v, no master copy
# ---------------------------------------------------------------------------


class FactorLeaf(NamedTuple):
    v_row: torch.Tensor  # f32, shape without last dim
    v_col: torch.Tensor  # f32, shape without second-to-last dim
    v_full: torch.Tensor  # f32 fallback for rank<2 leaves ((1,) where unused)


def _factored(shape) -> bool:
    return len(shape) >= 2


@torch.no_grad()
def adafactor_init(params) -> OptState:
    leaves = named_leaves(params)
    inner = {}
    for path, (names, stacked) in leaf_groups(params).items():
        ts = [leaves[n] for n in names]
        shape, dev = _full_shape(ts, stacked), ts[0].device

        def z(s):
            return torch.zeros(s, dtype=torch.float32, device=dev)

        if _factored(shape):
            inner[path] = FactorLeaf(v_row=z(shape[:-1]), v_col=z(shape[:-2] + shape[-1:]),
                                     v_full=z((1,)))
        else:
            inner[path] = FactorLeaf(v_row=z((1,)), v_col=z((1,)), v_full=z(shape))
    return OptState(step=_step_tensor(params), inner=inner)


@torch.no_grad()
def adafactor_update(grads, state: OptState, params, lr, *, decay: float = 0.8,
                     eps: float = 1e-30, clip_threshold: float = 1.0,
                     weight_decay: float = 0.0):
    """One Adafactor step in place; returns ``(params, new state)``. A
    stacked leaf is gathered into one f32 tensor, as the reference holds
    it, for its factored moments and its RMS clip."""
    step = state.step + 1
    t = step.float()
    beta2 = 1.0 - t ** -decay  # Adafactor schedule
    leaves, gl = named_leaves(params), named_leaves(grads)
    for path, (names, stacked) in leaf_groups(params).items():
        s = state.inner[path]
        ts = [leaves[n] for n in names]
        gf = _stack_f32([gl[n] for n in names], stacked)
        g2 = gf * gf + eps
        if _factored(gf.shape):
            v_row = beta2 * s.v_row + (1 - beta2) * torch.mean(g2, dim=-1)
            v_col = beta2 * s.v_col + (1 - beta2) * torch.mean(g2, dim=-2)
            row_mean = torch.mean(v_row, dim=-1, keepdim=True)
            update = gf * torch.rsqrt(v_row / torch.clamp(row_mean, min=eps))[..., None]
            update = update * torch.rsqrt(v_col)[..., None, :]
            s.v_row.copy_(v_row)
            s.v_col.copy_(v_col)
        else:
            v = beta2 * s.v_full + (1 - beta2) * g2
            update = gf * torch.rsqrt(v)
            s.v_full.copy_(v)
        del g2
        # update clipping by RMS
        rms = torch.sqrt(torch.mean(update * update) + 1e-30)
        update = update / torch.clamp(rms / clip_threshold, min=1.0)
        pf = _stack_f32(ts, stacked)
        new_p = pf - lr * (update + weight_decay * pf)
        for p, src in zip(ts, _slices(new_p, stacked)):
            p.copy_(src)
    return params, OptState(step=step, inner=state.inner)


# ---------------------------------------------------------------------------
# Common utilities
# ---------------------------------------------------------------------------


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in named_leaves(tree).values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    """``(grads scaled to a global norm of at most max_norm, the norm)``:
    each leaf cast to f32, scaled and cast back to its own dtype (a dict
    tree of gradients; a new tree)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def cosine_schedule(step, *, base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    t = torch.as_tensor(step).to(torch.float32)
    warm = base_lr * t / max(warmup, 1)
    progress = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * progress)))
    return torch.where(t < warmup, warm, cos)


def init_optimizer(name: str, params) -> OptState:
    return {"adamw": adamw_init, "adafactor": adafactor_init}[name](params)


def apply_optimizer(name: str, grads, state, params, lr):
    fn = {"adamw": adamw_update, "adafactor": adafactor_update}[name]
    return fn(grads, state, params, lr)
