"""Logical-axis sharding rules (MaxText-style) for params, batches, caches
(the port of ``repro.models.sharding``), on ``torch.distributed``'s
DeviceMesh and DTensor.

Every param gets logical axis names derived from its path and rank;
``rules`` map logical names to mesh axes. A dimension that does not divide
evenly by its mesh-axis size falls back to replication (e.g. hymba's 25
query heads on a 16-way model axis).

Mesh axes: ("data", "model") single-pod, ("pod", "data", "model") multi-pod.
Batch is sharded over ("pod","data") [DP], weights' heads/mlp/vocab/experts
over "model" [TP/EP], and large embed dims over "data" [FSDP/ZeRO-3-style]
when ``fsdp=True``.

A spec is a plain tuple with the content of jax's ``PartitionSpec``: an
entry per tensor dimension, None (replicated), a mesh axis name, or a
tuple of names (``("pod", "data")`` shards one dimension over both axes,
pod-major). ``placements`` turns a spec into a DTensor placement list, one
entry per mesh dimension. The spec functions read only ``mesh.shape``'s
sizes by name: a DeviceMesh, or any object whose ``shape`` is a dict of
axis sizes.

The port's ``LM`` keeps a layer stack's blocks as modules of their own
(``layers.3.attn.wq``); the reference stacks them (``layers/attn/wq`` with
a leading layer axis). ``logical_axes`` matches a parameter on its
reference path and gives the reference's axes without the stacked layer's
leading None.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import local_map

# ---------------------------------------------------------------------------
# Logical axes per param leaf (matched on the tree path suffix)
# ---------------------------------------------------------------------------

# pattern -> logical axes of the *unstacked* leaf (no layer dim)
_PARAM_AXES = [
    (r"embed/tok$", ("vocab", "embed")),
    (r"lm_head/w$", ("embed", "vocab")),
    (r"patch_proj$", ("embed", "embed2")),
    (r"encoder/frontend$", ("embed", "embed2")),
    (r"(attn|cross)/wq$", ("embed", "heads")),
    (r"(attn|cross)/wk$", ("embed", "kv_heads")),
    (r"(attn|cross)/wv$", ("embed", "kv_heads")),
    (r"(attn|cross)/wo$", ("heads", "embed")),
    (r"(attn|cross)/bq$", ("heads",)),
    (r"(attn|cross)/b[kv]$", ("kv_heads",)),
    (r"(mlp|shared|dense)/w_gate$", ("embed", "mlp")),
    (r"(mlp|shared|dense)/w_up$", ("embed", "mlp")),
    (r"(mlp|shared|dense)/w_down$", ("mlp", "embed")),
    (r"moe/router$", ("embed", None)),
    (r"moe/w_gate$", ("experts", "moe_embed", "moe_mlp")),
    (r"moe/w_up$", ("experts", "moe_embed", "moe_mlp")),
    (r"moe/w_down$", ("experts", "moe_mlp", "moe_embed")),
    (r"ssm/in_proj$", ("embed", "mlp")),
    (r"ssm/out_proj$", ("mlp", "embed")),
    (r"ssm/conv_w$", (None, "mlp")),
    (r"ssm/conv_b$", ("mlp",)),
    (r"ssm/(A_log|D|dt_bias)$", (None,)),
    (r"(norm|ln1|ln2|ln1_post|ln2_post|ln_cross|final_norm)(/scale)?$", (None,)),
]

# logical axis -> mesh axis (None = replicate)
DEFAULT_RULES: Dict[str, Optional[str]] = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "embed": None,  # flipped to "data" under fsdp
    "embed2": None,
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,
    "act_embed": None,  # residual-stream feature dim ('model' = seq-par/TP-act)
    # MoE expert weights: baseline mirrors dense rules (embed FSDP-gathered
    # per microbatch). The weight-stationary alternative sets moe_mlp ->
    # 'data' + experts_act -> 'model' so expert weights never move and
    # tokens all-to-all instead.
    "moe_embed": None,  # flipped to "data" under fsdp (baseline)
    "moe_mlp": None,
    "experts_act": None,  # expert dim of dispatch buffers
}


def weight_stationary_moe_rules(fsdp_dense: bool = True) -> Dict:
    """Rules for the weight-stationary MoE scheme."""
    rules = dict(DEFAULT_RULES)
    if fsdp_dense:
        rules["embed"] = "data"
    rules["moe_embed"] = None
    rules["moe_mlp"] = "data"
    rules["experts_act"] = "model"
    return rules


# ---------------------------------------------------------------------------
# Meshes and placements
# ---------------------------------------------------------------------------


def mesh_shape(mesh) -> Dict[str, int]:
    """A mesh's axis sizes by name: a DeviceMesh's dimension names and sizes,
    or a stand-in's ``shape`` dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def placements(spec: Tuple, mesh) -> list:
    """The DTensor placements (one per mesh dimension) of a spec: a mesh
    axis that shards tensor dimension d is ``Shard(d)``, the rest
    ``Replicate()``. Where one dimension takes several axes they must come
    in the mesh's order (pod-major), as DTensor shards them."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes of dimension {d} are not in the mesh's order")
        for i in idx:
            out[i] = Shard(d)
    return out


# ---------------------------------------------------------------------------
# Activation sharding constraints (mesh context set by the launcher; no-op
# without one)
# ---------------------------------------------------------------------------

_ACT_CTX: Dict[str, object] = {"mesh": None, "rules": None}


class activation_mesh:
    """Context manager: enable activation constraints under this mesh."""

    def __init__(self, mesh, rules: Optional[Dict] = None):
        self.mesh = mesh
        self.rules = dict(rules or DEFAULT_RULES)

    def __enter__(self):
        self._saved = dict(_ACT_CTX)
        _ACT_CTX["mesh"] = self.mesh
        _ACT_CTX["rules"] = self.rules
        return self

    def __exit__(self, *exc):
        _ACT_CTX.update(self._saved)


def act_placements(shape: Tuple[int, ...], axes: Tuple, mesh) -> list:
    """The placements of an activation of ``shape`` with these logical axes,
    under the active context's rules (the defaults without one)."""
    return placements(spec_for(shape, axes, mesh, _ACT_CTX["rules"] or DEFAULT_RULES), mesh)


def constrain(x, *axes):
    """The reference's ``with_sharding_constraint`` by logical axis names:
    without a context, ``x`` itself; under ``activation_mesh``, a DTensor
    redistributed to the spec's placements (a plain tensor, not
    distributed, is returned as it is)."""
    mesh = _ACT_CTX["mesh"]
    if mesh is None or not is_dtensor(x):
        return x
    want = act_placements(tuple(x.shape), axes, mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


# ---------------------------------------------------------------------------
# The model's ops on DTensors: where DTensor has no rule for an op, or its
# own choice would gather what the reference's layout keeps cut, an
# explicit rule (``local_map``: each rank on its own shards); on plain
# tensors each is the plain op
# ---------------------------------------------------------------------------


def shard_ways(x: torch.Tensor, dim: int) -> int:
    """The number of shards that dimension ``dim`` of ``x`` is cut into
    (1 for a tensor that is not a DTensor)."""
    if not is_dtensor(x):
        return 1
    return math.prod(x.device_mesh.size(i) for i in _shard_dims(x, dim % x.dim()))


def split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """``(..., n * hd) -> (..., n, hd)``. Under DTensor the mesh axes that
    shard the last dim keep it only where their size divides the ``n``
    heads (the reference's fallback for heads, e.g. 2 KV heads on a 4-way
    axis); the others are gathered first, by an explicit redistribute."""
    if is_dtensor(x) and n % shard_ways(x, -1):
        cut = _shard_dims(x, x.dim() - 1)
        x = x.redistribute(x.device_mesh, [Replicate() if i in cut else p
                                           for i, p in enumerate(x.placements)])
    return x.reshape(*x.shape[:-1], n, hd)


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def wrap_local(local: torch.Tensor, mesh, placements, shape) -> torch.Tensor:
    """A DTensor of global ``shape`` from this rank's ``local`` shard (its
    placements even: no check, no collective)."""
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def zeros(shape, dtype, device, mesh, spec) -> torch.Tensor:
    """A DTensor of zeros of global ``shape`` laid out by ``spec`` on
    ``mesh``; each rank allocates its shard only."""
    plc = placements(spec, mesh)
    local = list(shape)
    for i, p in enumerate(plc):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    return wrap_local(torch.zeros(local, dtype=dtype, device=device), mesh, plc, shape)


def _shard_dims(x: torch.Tensor, dim: int):
    """The mesh dimensions that shard dimension ``dim`` of DTensor ``x``."""
    return [i for i, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == dim]


def _shard_index(mesh, mesh_dims) -> int:
    """This rank's shard of a dimension cut over ``mesh_dims`` (nested, the
    first the outermost)."""
    coord = mesh.get_coordinate()
    idx = 0
    for i in mesh_dims:
        idx = idx * mesh.size(i) + coord[i]
    return idx


def linear(x: torch.Tensor, w: torch.Tensor, fn=None) -> torch.Tensor:
    """``fn(x, w)`` (``torch.matmul`` by default) of activations (..., d_in)
    and a weight (d_in, d_out). On DTensors by an explicit rule
    (``local_map``), the tensor- and data-parallel product that GSPMD
    derives from the reference's specs: on each mesh axis the weight keeps
    its cut of the columns where x is whole (the result cut alike) or its
    cut of the contraction where x's last dim is cut alike (a partial sum),
    and is gathered elsewhere (the FSDP all-gather, over the axes that cut
    x's rows); each rank multiplies its rows by its columns. The weight's
    gradient is each rank's rows' sum (``Partial`` over the axes that cut
    the rows), which the gather's backward reduce-scatters."""
    if not (isinstance(x, DTensor) or isinstance(w, DTensor)):
        return x @ w if fn is None else fn(x, w)
    fn = fn or torch.matmul
    mesh = (x if is_dtensor(x) else w).device_mesh
    whole = [Replicate()] * mesh.ndim
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, whole, run_check=False)
    if not is_dtensor(w):
        w = DTensor.from_local(w, mesh, whole, run_check=False)
    last = x.dim() - 1
    xp, wp, outp, gx, gw = [], [], [], [], []
    for px, pw in zip(x.placements, w.placements):
        if isinstance(px, Shard) and px.dim == last and pw == Shard(0):  # the contraction cut
            xp.append(px), wp.append(pw), outp.append(Partial()), gx.append(px), gw.append(pw)
        elif isinstance(px, Shard) and px.dim < last:  # the rows cut: the weight gathered
            xp.append(px), wp.append(Replicate()), outp.append(px), gx.append(px)
            gw.append(Partial())
        elif pw == Shard(1):  # the columns cut: x whole
            xp.append(Replicate()), wp.append(pw), outp.append(Shard(last)), gx.append(Partial())
            gw.append(pw)
        else:
            xp.append(Replicate()), wp.append(Replicate()), outp.append(Replicate())
            gx.append(Replicate()), gw.append(Replicate())
    x, w = x.redistribute(mesh, xp), w.redistribute(mesh, wp)
    return local_map(fn, out_placements=outp, in_placements=(xp, wp), in_grad_placements=(gx, gw),
                     device_mesh=mesh)(x, w)


def embedding(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, table)``. Where a mesh axis shards the table's
    vocab, by an explicit rule (``local_map``): the table gathered over
    every other axis (the FSDP gather of its embed dim), each rank looks up
    the tokens in its vocab rows (zeros elsewhere), and the result is a sum
    over the vocab's axes (``Partial``); the table's gradient is its rows'
    scatter, summed over the axes that shard the tokens."""
    if not is_dtensor(table) or not _shard_dims(table, 0):
        return F.embedding(tokens, table)
    mesh = table.device_mesh
    vocab_dims = _shard_dims(table, 0)
    tok_plc = list(tokens.placements) if is_dtensor(tokens) else [Replicate()] * mesh.ndim
    tab_plc = [Shard(0) if i in vocab_dims else Replicate() for i in range(mesh.ndim)]
    out_plc = [Partial() if i in vocab_dims else tok_plc[i] for i in range(mesh.ndim)]
    grad_plc = [Shard(0) if i in vocab_dims else
                (Partial() if isinstance(tok_plc[i], Shard) else Replicate())
                for i in range(mesh.ndim)]
    rows = table.shape[0]
    for i in vocab_dims:
        rows //= mesh.size(i)
    lo = _shard_index(mesh, vocab_dims) * rows

    def lookup(tok, tab):
        rel = tok - lo
        hit = (rel >= 0) & (rel < tab.shape[0])
        out = F.embedding(torch.where(hit, rel, torch.zeros_like(rel)), tab)
        return out * hit[..., None].to(out.dtype)

    fn = local_map(lookup, out_placements=out_plc, in_placements=(tok_plc, tab_plc),
                   in_grad_placements=(tok_plc, grad_plc), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(tokens, table)


class _LogSoftmaxCut(torch.autograd.Function):
    """``log_softmax`` over a last dim that a mesh axis cuts: ``x - lse``,
    the max and the sum of exps reduced over the cut; the backward
    ``g - softmax * sum(g)`` reduces its one value a row before it meets
    the cut dim (DTensor would carry the partial sum out to the vocab's
    width and reduce-scatter that)."""

    @staticmethod
    def forward(ctx, x):
        m = torch.amax(x, dim=-1, keepdim=True)
        out = x - (m + torch.log(torch.sum(torch.exp(x - m), dim=-1, keepdim=True)))
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        total = _whole_over_cut(torch.sum(g, dim=-1, keepdim=True), out)
        return g - torch.exp(out) * total


def _whole_over_cut(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (a reduction over ``like``'s cut last dim) made whole over the
    mesh axes of that cut."""
    cut = _shard_dims(like, like.dim() - 1)
    return t.redistribute(t.device_mesh, [Replicate() if i in cut else p
                                          for i, p in enumerate(t.placements)])


def log_softmax_last(x: torch.Tensor) -> torch.Tensor:
    """``torch.log_softmax(x, dim=-1)``. Where a mesh axis cuts the last
    dim (the vocab), by ``_LogSoftmaxCut``: two all-reduces of one value a
    row forward, one backward, instead of the logits gathered."""
    if not is_dtensor(x) or not _shard_dims(x, x.dim() - 1):
        return torch.log_softmax(x, dim=-1)
    return _LogSoftmaxCut.apply(x)


def take_last(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``torch.gather(x, -1, index[..., None])[..., 0]``. On a DTensor by an
    explicit rule (``local_map``; DTensor's own gather backward would
    allocate the whole of x's gradient on every rank): each rank takes the
    indices in its range of the last dim (zeros elsewhere), a sum over the
    axes that cut that dim (``Partial``)."""
    last = x.dim() - 1
    if not is_dtensor(x):
        return torch.gather(x, -1, index[..., None])[..., 0]
    mesh = x.device_mesh
    dims = _shard_dims(x, last)
    x_plc = list(x.placements)
    idx_plc = [Replicate() if i in dims else p for i, p in enumerate(x_plc)]
    out_plc = [Partial() if i in dims else p for i, p in enumerate(x_plc)]
    width = x.shape[-1] // shard_ways(x, last)
    lo = _shard_index(mesh, dims) * width

    def take(xl, il):
        rel = il.long() - lo
        hit = (rel >= 0) & (rel < xl.shape[-1])
        got = torch.gather(xl, -1, torch.where(hit, rel, torch.zeros_like(rel))[..., None])[..., 0]
        return got * hit.to(got.dtype)

    fn = local_map(take, out_placements=out_plc, in_placements=(x_plc, idx_plc),
                   in_grad_placements=(x_plc, idx_plc), device_mesh=mesh, redistribute_inputs=True)
    return fn(x, index)


def write_prefix(cache: torch.Tensor, layer: int, value: torch.Tensor) -> None:
    """``cache[layer, :, :S] = value``: a prompt's (B, S, ...) entries at
    the first S positions of one layer of a (L, B, max_seq, ...) cache.
    Where a mesh axis cuts the cache's positions (the long-context cut of
    the K/V cache), by an explicit rule: the prompt gathered over those
    axes, and each rank writes the part of it that falls in its range of
    positions into its own shard."""
    if not is_dtensor(cache) or not _shard_dims(cache, 2):
        cache[layer, :, :value.shape[1]] = value
        return
    mesh = cache.device_mesh
    dims = _shard_dims(cache, 2)
    want = [Replicate() if i in dims or not isinstance(p, Shard) else Shard(p.dim - 1)
            for i, p in enumerate(cache.placements)]
    if not is_dtensor(value):
        value = DTensor.from_local(value, mesh, [Replicate()] * mesh.ndim, run_check=False)
    value = value.redistribute(mesh, want).to_local()
    local = cache.to_local()
    n = local.shape[2]
    lo = _shard_index(mesh, dims) * n
    hi = min(lo + n, value.shape[1])
    if hi > lo:
        local[layer, :, :hi - lo] = value[:, lo:hi]


def argmax_last(x: torch.Tensor) -> torch.Tensor:
    """``torch.argmax(x, dim=-1)`` of a (B, V) tensor (the first maximum).
    Where a mesh axis shards V, in two stages: each rank's first maximum
    and its index, then the candidates gathered over the vocab's axes
    (``ways`` values a row) and the first maximum among them."""
    if not is_dtensor(x) or not _shard_dims(x, 1):
        return torch.argmax(x, dim=-1)
    mesh = x.device_mesh
    vocab_dims = _shard_dims(x, 1)
    ways = shard_ways(x, 1)
    loc = x.to_local()
    val, idx = torch.max(loc, dim=-1)
    idx = idx + _shard_index(mesh, vocab_dims) * loc.shape[-1]
    cand = (x.shape[0], ways)
    whole = [Replicate() if i in vocab_dims else p for i, p in enumerate(x.placements)]
    vals = wrap_local(val[:, None], mesh, x.placements, cand).redistribute(mesh, whole)
    idxs = wrap_local(idx[:, None], mesh, x.placements, cand).redistribute(mesh, whole)
    pick = torch.argmax(vals.to_local(), dim=-1, keepdim=True)
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in whole]
    return wrap_local(torch.gather(idxs.to_local(), 1, pick)[:, 0], mesh, rows, (x.shape[0],))


class _MergeHeads(torch.autograd.Function):
    """``(..., n, hd) -> (..., n * hd)`` of a DTensor, made on the local
    shards (a cut of the heads is a cut of the merged dim, heads-major), with
    the contiguous strides of a plain reshape's result, so that a product
    with it folds into one matrix product as the plain one does. The
    backward lays the cotangent out as the result first."""

    @staticmethod
    def forward(ctx, x):
        last = x.dim() - 1
        if any(isinstance(p, Shard) and p.dim == last for p in x.placements):
            x = x.redistribute(x.device_mesh, [Replicate() if isinstance(p, Shard) and
                                               p.dim == last else p for p in x.placements])
        ctx.shape, ctx.in_placements = tuple(x.shape), tuple(x.placements)
        loc = x.to_local()
        out = wrap_local(loc.reshape(*loc.shape[:-2], loc.shape[-2] * loc.shape[-1]),
                         x.device_mesh, x.placements, ctx.shape[:-2] + (ctx.shape[-2] * ctx.shape[-1],))
        ctx.placements = tuple(out.placements)
        return out

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        loc = g.to_local()
        n_local = loc.shape[-1] // ctx.shape[-1]
        return wrap_local(loc.reshape(*loc.shape[:-1], n_local, ctx.shape[-1]), g.device_mesh,
                          ctx.in_placements, ctx.shape)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``(..., n, hd) -> (..., n * hd)``, the inverse of ``split_heads``."""
    if is_dtensor(x):
        return _MergeHeads.apply(x)
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def reference_path(name: str) -> str:
    """A parameter's path in the reference's tree: ``layers.3.attn.wq`` ->
    ``layers/attn/wq`` (a stack's block index dropped), ``embed.tok`` ->
    ``embed/tok``."""
    parts = [p for p in name.split(".") if not p.isdigit()]
    return "/".join(parts)


def _named(params) -> Dict[str, torch.Tensor]:
    """An ``LM``'s parameters by module name, or a dict's tensors by key."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _axes_of(path: str, ndim: int) -> Tuple:
    for pat, axes in _PARAM_AXES:
        if re.search(pat, path):
            extra = ndim - len(axes)
            assert extra >= 0, f"{path}: rank {ndim} < {axes}"
            return (None,) * extra + tuple(axes)
    return (None,) * ndim  # unknown leaves replicate


def logical_axes(params) -> Dict[str, Tuple]:
    """Logical-axis tuples by parameter name (an ``LM``'s module names, or a
    dict's keys read as reference paths). A leaf of higher rank than its
    pattern (a stacked leaf) gets leading Nones."""
    return {name: _axes_of(reference_path(name), t.dim()) for name, t in _named(params).items()}


def _axis_size(mesh, axis) -> int:
    shape = mesh_shape(mesh)
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= shape.get(a, 1)
        return n
    return int(shape.get(axis, 1))


def spec_for(shape: Tuple[int, ...], axes: Tuple, mesh, rules: Dict[str, Optional[str]]) -> Tuple:
    """A spec with divisibility fallback to replication; a mesh axis shards
    at most one dimension."""
    sizes = mesh_shape(mesh)
    spec = []
    used = set()
    for dim, name in zip(shape, axes):
        mesh_axis = rules.get(name) if name else None
        if mesh_axis is None:
            spec.append(None)
            continue
        axes_tuple = mesh_axis if isinstance(mesh_axis, tuple) else (mesh_axis,)
        axes_tuple = tuple(a for a in axes_tuple if a in sizes and a not in used)
        size = 1
        for a in axes_tuple:
            size *= sizes[a]
        if not axes_tuple or size == 1 or dim % size != 0:
            spec.append(None)
            continue
        used.update(axes_tuple)
        spec.append(axes_tuple[0] if len(axes_tuple) == 1 else axes_tuple)
    return tuple(spec)


def _param_rules(fsdp: bool, rules) -> Dict:
    rules = dict(rules or DEFAULT_RULES)
    if fsdp:
        rules["embed"] = "data"
        if rules.get("moe_mlp") is None:
            rules["moe_embed"] = "data"  # baseline: FSDP MoE weights too
    return rules


def param_specs(params, mesh, fsdp: bool = False, rules=None) -> Dict[str, Tuple]:
    """Specs by parameter name for a (shape-only) model or dict of tensors."""
    rules = _param_rules(fsdp, rules)
    axes = logical_axes(params)
    return {name: spec_for(tuple(t.shape), axes[name], mesh, rules)
            for name, t in _named(params).items()}


def param_shardings(params, mesh, fsdp: bool = False, rules=None) -> Dict[str, list]:
    """DTensor placements by parameter name."""
    return {name: placements(s, mesh)
            for name, s in param_specs(params, mesh, fsdp=fsdp, rules=rules).items()}


def distribute_params(model: nn.Module, mesh, fsdp: bool = False, rules=None) -> nn.Module:
    """Replace each of ``model``'s parameters, in place, by a DTensor of its
    placements on ``mesh`` (this rank's shard of the tensor, which every
    rank holds whole: no collective). Returns the model."""
    shardings = param_shardings(model, mesh, fsdp=fsdp, rules=rules)
    for name, p in list(model.named_parameters()):
        owner = model.get_submodule(name.rpartition(".")[0]) if "." in name else model
        leaf = name.rpartition(".")[2]
        with torch.no_grad():
            d = distribute_tensor(p.detach(), mesh, shardings[name], src_data_rank=None)
        owner._parameters[leaf] = nn.Parameter(d, requires_grad=p.requires_grad)
    return model


# ---------------------------------------------------------------------------
# Batch / cache shardings
# ---------------------------------------------------------------------------


def batch_specs(batch_shapes: Dict, mesh, rules=None) -> Dict[str, Tuple]:
    """tokens/frames/patches: shard the leading batch dim over DP axes."""
    rules = dict(rules or DEFAULT_RULES)
    return {k: spec_for(tuple(v.shape), ("batch",) + (None,) * (v.dim() - 1), mesh, rules)
            for k, v in batch_shapes.items()}


def cache_spec(name: str, shape: Tuple[int, ...], mesh, rules=None) -> Tuple:
    """The spec of the cache's part ``name`` (its key) of ``shape``."""
    rules = dict(rules or DEFAULT_RULES)
    if name.endswith("len"):
        return spec_for(shape, ("batch",), mesh, rules)
    if name.endswith("k") or name.endswith("v"):
        if shape[3] % _axis_size(mesh, "model") == 0:
            return spec_for(shape, (None, "batch", None, "kv_heads", None), mesh, rules)
        rules["kv_seq"] = "model"
        return spec_for(shape, (None, "batch", "kv_seq", None, None), mesh, rules)
    if name.endswith("conv"):
        return spec_for(shape, (None, "batch", None, "mlp"), mesh, rules)
    if name.endswith("ssm"):
        return spec_for(shape, (None, "batch", "mlp", None, None), mesh, rules)
    if name.endswith("memory"):
        return spec_for(shape, ("batch", None, None), mesh, rules)
    return (None,) * len(shape)


def cache_specs(cache_shapes: Dict, mesh, rules=None) -> Dict[str, Tuple]:
    """Decode cache: (L, B, S, KV, hd) -> B over DP, KV over model when it
    divides; otherwise the seq dim takes the model axis (long-context)."""
    return {k: cache_spec(k, tuple(v.shape), mesh, rules) for k, v in cache_shapes.items()}
