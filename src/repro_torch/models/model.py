"""Composable decoder / encoder-decoder LM covering all assigned families
(the port of ``repro.models.model``, its serving half).

Blocks are pre-norm residual (optionally sandwich-norm, gemma2); the mixer
is attention, SSD, or both in parallel (hymba, ``0.5 * (attn + ssm)``);
the FFN is a gated MLP, an MoE layer, or absent (mamba2, d_ff=0). The
model is an ``nn.Module``: a ``ModuleList`` of blocks (``layers``), a
``prefix_layers`` list for kimi's ``first_k_dense`` dense layers, the
encoder, the embedding and the head. The layers run as a Python loop.

Entry points:
  init_params(key, cfg, device)             -> LM (the parameters)
  forward(params, batch, cfg)               -> fp32 logits (train/prefill)
  init_cache(cfg, batch, max_seq, dtype)    -> decode cache dict
  prefill(params, batch, cfg, max_seq)      -> (logits_last, cache)
  decode_step(params, tokens, cache, cfg)   -> (logits, cache)
  loss_fn(params, batch, cfg)               -> (loss, metrics)

With gradients on and ``cfg.remat``, each block runs under
``torch.utils.checkpoint`` (non-reentrant): only the block's input is
kept, and the backward recomputes the block, as the reference's
``jax.checkpoint(..., nothing_saveable)`` does. The parameters carry no
gradient by default (serving); ``training.init_train_state`` turns it on.
The reference's sharding constraints (``sharding.constrain``) sit where
the reference has them: without ``sharding.activation_mesh`` each returns
its input.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from torch.utils.checkpoint import checkpoint

from repro_torch.core.engine import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import sharding as sh_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    _dtype,
    _param,
    apply_mlp,
    dense_init,
    embed_tokens,
    init_embedding,
    init_lm_head,
    init_mlp,
    init_rmsnorm,
    lm_logits,
    rmsnorm,
)

# ---------------------------------------------------------------------------
# Per-layer flags
# ---------------------------------------------------------------------------


def local_layer_flags(cfg: ModelConfig, n_layers: int) -> np.ndarray:
    """Boolean array: True where the layer uses local (sliding) attention."""
    if cfg.global_layer_indices:
        flags = np.ones(n_layers, bool)
        for i in cfg.global_layer_indices:
            if i < n_layers:
                flags[i] = False
        return flags
    return np.array(
        [cfg.pattern_for_layer(i) == "local" for i in range(n_layers)], bool
    )


def _has_attn(cfg: ModelConfig) -> bool:
    return cfg.family != "ssm"


def _has_ssm(cfg: ModelConfig) -> bool:
    return cfg.family in ("ssm", "hybrid")


def _has_ffn(cfg: ModelConfig) -> bool:
    return cfg.d_ff > 0 or cfg.n_experts > 0


# ---------------------------------------------------------------------------
# Modules and init
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """One layer; a part the config does not have is None. Names are the
    reference's block keys."""

    PARTS = ("ln1", "attn", "ssm", "ln_cross", "cross", "ln2", "moe", "mlp", "ln1_post",
             "ln2_post")

    def __init__(self, **parts):
        super().__init__()
        for name in self.PARTS:
            setattr(self, name, parts.get(name))


class Encoder(nn.Module):
    def __init__(self, frontend, layers, norm):
        super().__init__()
        self.frontend = _param(frontend)
        self.layers = nn.ModuleList(layers)
        self.norm = norm


class LM(nn.Module):
    """The parameters: ``embed``, ``prefix_layers`` (kimi's dense first
    layers, else None), ``layers``, ``encoder`` (enc-dec, else None),
    ``patch_proj`` (VLM, else None), ``final_norm`` and ``lm_head``."""

    def __init__(self, cfg: ModelConfig, embed, prefix_layers, layers, encoder, patch_proj,
                 final_norm, lm_head):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        self.prefix_layers = None if prefix_layers is None else nn.ModuleList(prefix_layers)
        self.layers = nn.ModuleList(layers)
        self.encoder = encoder
        self.patch_proj = None if patch_proj is None else _param(patch_proj)
        self.final_norm = final_norm
        self.lm_head = lm_head

    def stacks(self):
        """(blocks, index of the first) of each decoder stack, in order."""
        if self.prefix_layers is None:
            return [(self.layers, 0)]
        return [(self.prefix_layers, 0), (self.layers, len(self.prefix_layers))]


def _init_block(gen: torch.Generator, cfg: ModelConfig, *, use_moe: bool,
                cross: bool = False) -> Block:
    dt = _dtype(cfg)
    dev = gen.device
    p = {"ln1": init_rmsnorm(cfg.d_model, dt, dev)}
    if _has_attn(cfg):
        p["attn"] = attn_lib.init_attention(gen, cfg)
    if _has_ssm(cfg):
        p["ssm"] = ssm_lib.init_ssm(gen, cfg)
    if cross:
        p["ln_cross"] = init_rmsnorm(cfg.d_model, dt, dev)
        p["cross"] = attn_lib.init_attention(gen, cfg)
    if _has_ffn(cfg):
        p["ln2"] = init_rmsnorm(cfg.d_model, dt, dev)
        if use_moe:
            p["moe"] = moe_lib.init_moe(gen, cfg)
        else:
            p["mlp"] = init_mlp(gen, cfg)
    if cfg.sandwich_norm:
        p["ln1_post"] = init_rmsnorm(cfg.d_model, dt, dev)
        if _has_ffn(cfg):
            p["ln2_post"] = init_rmsnorm(cfg.d_model, dt, dev)
    return Block(**p)


def _generator(key, device) -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(int(key))


def init_params(key, cfg: ModelConfig, device="cuda") -> LM:
    """The model's parameters, drawn on ``device`` from ``key`` (a seed or a
    ``torch.Generator`` on that device) with the reference's shapes, scales
    and dtypes; the draws are the port's own, not the reference's."""
    dev = resolve_device(device)
    gen = _generator(key, dev)
    if gen.device.type != dev.type:
        raise ValueError(f"the generator is on {gen.device}, the parameters go on {dev}")
    dt = _dtype(cfg)
    with torch.no_grad():
        embed = init_embedding(gen, cfg)
        prefix = None
        if cfg.n_experts and cfg.first_k_dense:
            prefix = [_init_block(gen, cfg, use_moe=False) for _ in range(cfg.first_k_dense)]
        n_main = cfg.n_layers - cfg.first_k_dense if cfg.n_experts else cfg.n_layers
        layers = [_init_block(gen, cfg, use_moe=cfg.n_experts > 0, cross=cfg.cross_attention)
                  for _ in range(n_main)]
        encoder = None
        if cfg.n_enc_layers:
            frontend = dense_init(gen, cfg.d_model, cfg.d_model, dt)
            encoder = Encoder(frontend, [_init_block(gen, cfg, use_moe=False)
                                         for _ in range(cfg.n_enc_layers)],
                              init_rmsnorm(cfg.d_model, dt, dev))
        patch_proj = dense_init(gen, cfg.d_model, cfg.d_model, dt) if cfg.n_prefix_embeds else None
        final_norm = init_rmsnorm(cfg.d_model, dt, dev)
        head = init_lm_head(gen, cfg)
    return LM(cfg, embed, prefix, layers, encoder, patch_proj, final_norm, head)


# ---------------------------------------------------------------------------
# Block apply (full sequence)
# ---------------------------------------------------------------------------


def _residual_layout(y: torch.Tensor) -> torch.Tensor:
    """A sublayer's output in the residual stream's layout: the layout that
    GSPMD propagates from the reference's constraint on the stream
    (``constrain(x, "batch", "seq", "act_embed")``); DTensor propagates
    none, and would carry the output projection's partial sums on. Without
    ``sharding.activation_mesh``, ``y`` itself."""
    return sh_lib.constrain(y, "batch", "seq", "act_embed")


def _ffn(block: Block, out: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The block's second half: cross attention is the caller's; this is
    the FFN residual (MLP or MoE, sandwich-normed)."""
    if block.ln2 is None:
        return out
    h2 = rmsnorm(block.ln2, out, cfg.norm_eps)
    ff = moe_lib.apply_moe(block.moe, h2, cfg) if block.moe is not None else apply_mlp(
        block.mlp, h2, cfg)
    ff = _residual_layout(ff)
    if cfg.sandwich_norm:
        ff = rmsnorm(block.ln2_post, ff, cfg.norm_eps)
    return out + ff


def _cross(block: Block, out: torch.Tensor, memory, cfg: ModelConfig) -> torch.Tensor:
    if memory is None or block.cross is None:
        return out
    hc = rmsnorm(block.ln_cross, out, cfg.norm_eps)
    return out + _residual_layout(attn_lib.cross_attend(block.cross, hc, memory, cfg))


def _apply_block(
    block: Block,
    x: torch.Tensor,
    positions: torch.Tensor,
    is_local: bool,
    cfg: ModelConfig,
    *,
    causal: bool = True,
    memory: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    h = rmsnorm(block.ln1, x, cfg.norm_eps)
    mix = 0.0
    if block.attn is not None:
        mix = _residual_layout(attn_lib.attend(block.attn, h, positions, cfg,
                                               is_local=is_local, causal=causal))
    if block.ssm is not None:
        s = _residual_layout(ssm_lib.apply_ssm(block.ssm, h, cfg))
        mix = 0.5 * (mix + s) if block.attn is not None else s
    if cfg.sandwich_norm:
        mix = rmsnorm(block.ln1_post, mix, cfg.norm_eps)
    x = x + mix
    x = _cross(block, x, memory, cfg)
    return _ffn(block, x, cfg)


def _scan_stack(
    blocks,
    x: torch.Tensor,
    positions: torch.Tensor,
    local_flags,
    cfg: ModelConfig,
    *,
    causal: bool = True,
    memory: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    remat = cfg.remat and torch.is_grad_enabled()
    for block, is_local in zip(blocks, local_flags):
        if remat:
            x = checkpoint(_apply_block, block, x, positions, bool(is_local), cfg, causal=causal,
                           memory=memory, use_reentrant=False)
        else:
            x = _apply_block(block, x, positions, bool(is_local), cfg, causal=causal,
                             memory=memory)
    return x


# ---------------------------------------------------------------------------
# Forward / loss
# ---------------------------------------------------------------------------


def _arange_positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def _encode(params: LM, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Encoder over stub frame embeddings (B, S_enc, D)."""
    enc = params.encoder
    x = sh_lib.linear(frames.to(_dtype(cfg)), enc.frontend)
    x = sh_lib.constrain(x, "batch", "seq", "act_embed")
    positions = _arange_positions(x.shape[0], x.shape[1], x.device)
    x = _scan_stack(enc.layers, x, positions, [False] * cfg.n_enc_layers, cfg, causal=False)
    return rmsnorm(enc.norm, x, cfg.norm_eps)


def _decoder_inputs(params: LM, batch: Dict, cfg: ModelConfig):
    """Token embeddings (+ multimodal prefix) and positions for the decoder."""
    x = embed_tokens(params.embed, batch["tokens"], cfg)
    prefix_len = 0
    if cfg.n_prefix_embeds and "patches" in batch:
        patches = sh_lib.linear(batch["patches"].to(x.dtype), params.patch_proj)
        x = torch.cat([patches, x], dim=1)
        prefix_len = patches.shape[1]
    B, S = x.shape[:2]
    x = sh_lib.constrain(x, "batch", "seq", "act_embed")
    return x, _arange_positions(B, S, x.device), prefix_len


def forward(params: LM, batch: Dict, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence forward -> fp32 logits over the decoder positions."""
    memory = _encode(params, batch["frames"], cfg) if cfg.n_enc_layers else None
    x, positions, prefix_len = _decoder_inputs(params, batch, cfg)
    flags = local_layer_flags(cfg, cfg.n_layers)
    for blocks, off in params.stacks():
        x = _scan_stack(blocks, x, positions, flags[off:off + len(blocks)], cfg, memory=memory)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    if prefix_len:
        x = x[:, prefix_len:]
    return lm_logits(params.lm_head, params.embed, x, cfg)


def loss_fn(params: LM, batch: Dict, cfg: ModelConfig):
    """Next-token cross entropy in f32. batch['tokens'] has S+1 positions."""
    tokens = batch["tokens"]
    inputs = dict(batch)
    inputs["tokens"] = tokens[:, :-1]
    labels = tokens[:, 1:].long()
    # the logits are not kept: log_softmax's backward reads its output
    logp = sh_lib.log_softmax_last(forward(params, inputs, cfg))  # (B, S, V) f32
    ll = sh_lib.take_last(logp, labels)
    loss = -torch.mean(ll)
    metrics = {"loss": loss, "ppl_proxy": torch.exp(torch.clamp(loss, max=20.0))}
    return loss, metrics


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, device="cuda",
               mesh=None) -> Dict:
    """The decode cache, each part stacked over the layers: ``k``/``v``
    (L, B, max_seq, KV, hd), ``conv`` (L, B, W-1, conv_dim), ``ssm``
    (L, B, H, P, N) f32, ``len`` (B,) int32. With a ``mesh``, DTensors laid
    out by ``sharding.cache_specs`` (each rank allocates its shard)."""
    dt = dtype if isinstance(dtype, torch.dtype) else (
        getattr(torch, dtype) if dtype else _dtype(cfg))
    hd = cfg.resolved_head_dim
    L = cfg.n_layers
    parts = {"len": ((batch,), torch.int32)}
    if _has_attn(cfg):
        parts["k"] = ((L, batch, max_seq, cfg.n_kv_heads, hd), dt)
        parts["v"] = ((L, batch, max_seq, cfg.n_kv_heads, hd), dt)
    if _has_ssm(cfg):
        parts["conv"] = ((L, batch, cfg.ssm_conv_width - 1, ssm_lib.conv_dim(cfg)), dt)
        parts["ssm"] = ((L, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), torch.float32)
    if mesh is None:
        return {k: torch.zeros(shape, dtype=d, device=device) for k, (shape, d) in parts.items()}
    return {k: sh_lib.zeros(shape, d, device, mesh, sh_lib.cache_spec(k, shape, mesh))
            for k, (shape, d) in parts.items()}


@torch.no_grad()
def prefill(params: LM, batch: Dict, cfg: ModelConfig, max_seq: int):
    """Process the prompt, build the cache, return last-position logits.

    The prompt occupies positions [0, S) in every row (S includes a VLM's
    patches); the cache is ``max(max_seq, S)`` long. Each layer's K/V go to
    its slice of the cache; an SSM layer leaves its final state and the
    prompt's last W-1 pre-conv inputs."""
    memory = _encode(params, batch["frames"], cfg) if cfg.n_enc_layers else None
    x, positions, prefix_len = _decoder_inputs(params, batch, cfg)
    B, S = x.shape[:2]
    mesh = x.device_mesh if sh_lib.is_dtensor(x) else None
    cache = init_cache(cfg, B, max(max_seq, S), device=x.device, mesh=mesh)
    flags = local_layer_flags(cfg, cfg.n_layers)

    for blocks, off in params.stacks():
        for j, block in enumerate(blocks):
            li = off + j
            h = rmsnorm(block.ln1, x, cfg.norm_eps)
            mix = 0.0
            if block.attn is not None:
                mix, kv = attn_lib.attend_with_kv(block.attn, h, positions, cfg,
                                                  is_local=bool(flags[li]))
                mix = _residual_layout(mix)
                sh_lib.write_prefix(cache["k"], li, kv.k)
                sh_lib.write_prefix(cache["v"], li, kv.v)
            if block.ssm is not None:
                s, state, xbc = ssm_lib._apply_ssm(block.ssm, h, cfg)
                s = _residual_layout(s)
                mix = 0.5 * (mix + s) if block.attn is not None else s
                cache["ssm"][li] = state
                # conv cache: the prompt's last W-1 conv inputs, from row 0
                tail = xbc[:, -(cfg.ssm_conv_width - 1):, :]
                cache["conv"][li, :, :tail.shape[1]] = tail
            if cfg.sandwich_norm:
                mix = rmsnorm(block.ln1_post, mix, cfg.norm_eps)
            out = _cross(block, x + mix, memory, cfg)
            x = _ffn(block, out, cfg)

    cache["len"] = torch.full((B,), S, dtype=torch.int32, device=x.device)
    if memory is not None:
        cache["memory"] = memory

    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    logits = lm_logits(params.lm_head, params.embed, x[:, -1:], cfg)
    return logits, cache


@torch.no_grad()
def decode_step(params: LM, tokens: torch.Tensor, cache: Dict, cfg: ModelConfig):
    """One decode step. tokens: (B, 1) -> (logits (B,1,V), updated cache).

    The cache's K/V, conv and SSM tensors are updated in place (clone them
    first to decode twice from one state); ``len`` is a new tensor."""
    x = embed_tokens(params.embed, tokens, cfg)
    x = sh_lib.constrain(x, "batch", "seq", "act_embed")
    memory = cache.get("memory")
    flags = local_layer_flags(cfg, cfg.n_layers)
    cache_len = cache["len"]
    slots = None
    if "k" in cache and cfg.ragged_decode:
        slots = attn_lib.cache_slots(cache_len, cache["k"].shape[2])

    for blocks, off in params.stacks():
        for j, block in enumerate(blocks):
            li = off + j
            h = rmsnorm(block.ln1, x, cfg.norm_eps)
            mix = 0.0
            if block.attn is not None:
                kv = KVCache(k=cache["k"][li], v=cache["v"][li])
                mix, _ = attn_lib.decode_attend(block.attn, h, kv, cache_len, cfg,
                                                is_local=bool(flags[li]), slots=slots)
                mix = _residual_layout(mix)
            if block.ssm is not None:
                sc = ssm_lib.SSMCache(conv=cache["conv"][li], state=cache["ssm"][li])
                s, sc = ssm_lib.decode_ssm(block.ssm, h, sc, cfg)
                s = _residual_layout(s)
                mix = 0.5 * (mix + s) if block.attn is not None else s
                cache["conv"][li] = sc.conv
                cache["ssm"][li] = sc.state
            if cfg.sandwich_norm:
                mix = rmsnorm(block.ln1_post, mix, cfg.norm_eps)
            out = _cross(block, x + mix, memory, cfg)
            x = _ffn(block, out, cfg)

    cache["len"] = cache_len + 1
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    logits = lm_logits(params.lm_head, params.embed, x, cfg)
    return logits, cache
