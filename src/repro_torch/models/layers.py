"""Shared neural layers: norms, RoPE, gated MLP, embeddings (the port of
``repro.models.layers``).

Parameters live in small ``nn.Module`` containers whose attribute names
are the reference's dict keys (``RMSNorm.scale``, ``MLP.w_gate``, ...),
weights in the reference's ``(in, out)`` layout. ``init_*`` draws them on
the generator's device; the apply functions are stateless functions of a
container and tensors, as the reference's are of a dict. Matmuls run in
the config dtype (bf16 products accumulate in f32 where the entry points
turn off cuBLAS's reduced-precision bf16 reductions), with f32 norm
statistics, f32 RoPE and f32 logits.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch._subclasses.fake_tensor import is_fake

from repro_torch.models import sharding as sh_lib
from repro_torch.models.config import ModelConfig

_DRAW_CHUNK = 1 << 27  # f32 elements a draw holds at once (512 MB)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    dt = getattr(torch, cfg.dtype, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {cfg.dtype!r}")
    return dt


def _param(t: torch.Tensor) -> nn.Parameter:
    """A serving parameter: no gradient, so no autograd graph is kept."""
    return nn.Parameter(t, requires_grad=False)


def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """``N(0, scale^2)`` draws made in f32 on the generator's device and cast
    to ``dtype``, a slice of the first axis at a time, so that an expert
    stack's f32 draw never sits whole beside its cast."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    flat = out.view(shape[0], -1)
    # a fake tensor (the dry run's stand-ins) holds no memory: one draw
    rows = flat.shape[0] if is_fake(out) else max(1, _DRAW_CHUNK // max(1, flat.shape[1]))
    for i in range(0, flat.shape[0], rows):
        blk = flat[i:i + rows]
        blk.copy_(torch.randn(blk.shape, generator=gen, device=gen.device,
                              dtype=torch.float32).mul_(scale))
    return out


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype) -> torch.Tensor:
    return _normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype)


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (x: (..., d), w: (d, n)) with an f32 result, the
    reference's ``preferred_element_type=float32``. On the card a bf16
    product with an f32 output (cuBLAS accumulates in f32); elsewhere the
    f32 product of the upcast operands: products of bf16 values are exact
    in f32, so with TF32 off the two are the same function. On an H100 the
    first reads the bf16 head once, 2.2x faster than an f32 copy of it at
    deepseek-7b's head (see PERF.md)."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return _MatmulF32.apply(x, w)
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


class _MatmulF32(torch.autograd.Function):
    """The card's bf16 product with an f32 output, differentiable (``torch.mm``
    with ``out_dtype`` has no derivative): the backward is the upcast
    route's, the f32 cotangent times the upcast operands, each gradient cast
    to its operand's dtype (the reference's dot transpose)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).float()
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = (g2 @ w.float().t()).to(x.dtype).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            gw = (x.reshape(-1, x.shape[-1]).float().t() @ g2).to(w.dtype)
        return gx, gw


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = _param(scale)


def init_rmsnorm(d: int, dtype, device="cuda") -> RMSNorm:
    return RMSNorm(torch.ones((d,), dtype=dtype, device=device))


def rmsnorm(params: RMSNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + params.scale.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)  # (head_dim/2,)


@functools.lru_cache(maxsize=64)
def _rope_frequencies_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_frequencies`` made once a (head_dim, theta, device): a decode
    step applies RoPE twice a layer. Callers do not write to it."""
    return rope_frequencies(head_dim, theta, device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) integers. Rotates split halves
    (not interleaved pairs) in f32."""
    hd = x.shape[-1]
    # a fake tensor's table is made anew: the cache outlives its fake mode
    freqs = (rope_frequencies(hd, float(theta), x.device) if is_fake(x)
             else _rope_frequencies_on(hd, float(theta), x.device))
    angles = positions[..., None].float() * freqs  # (B, S, hd/2)
    sin = torch.sin(angles)[:, :, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = _param(w_gate), _param(w_up), _param(w_down)


def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff: int = 0) -> MLP:
    d_ff = d_ff or cfg.d_ff
    dt = _dtype(cfg)
    return MLP(dense_init(gen, cfg.d_model, d_ff, dt), dense_init(gen, cfg.d_model, d_ff, dt),
               dense_init(gen, d_ff, cfg.d_model, dt))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with the sigmoid as ``1 / (1 + exp(-x))``, an op
    at a time: in bf16 each op rounds, as the reference's expanded
    logistic does (a fused ``F.silu`` rounds once and differs in ~1 in 3
    elements)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s tanh form as written there, an op at a time, its
    constants in the input's dtype."""
    c = torch.tensor(math.sqrt(2.0 / math.pi), dtype=torch.float32).to(x.dtype)
    k = torch.tensor(0.044715, dtype=torch.float32).to(x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x))))
    return x * cdf


def _activation(name: str):
    # jax.nn.gelu defaults to its tanh form, so "gelu" is the tanh form too
    return {"silu": silu, "gelu": _gelu_tanh, "gelu_tanh": _gelu_tanh}[name]


def apply_mlp(params: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = _activation(cfg.act)
    h = act(sh_lib.linear(x, params.w_gate)) * sh_lib.linear(x, params.w_up)
    return sh_lib.linear(h, params.w_down)


# ---------------------------------------------------------------------------
# Embeddings / LM head
# ---------------------------------------------------------------------------


class Embedding(nn.Module):
    def __init__(self, tok: torch.Tensor):
        super().__init__()
        self.tok = _param(tok)


def init_embedding(gen: torch.Generator, cfg: ModelConfig) -> Embedding:
    # scale 1/sqrt(d): O(1) logits whether tied or not
    return Embedding(_normal(gen, (cfg.vocab_size, cfg.d_model), 1.0 / math.sqrt(cfg.d_model),
                             _dtype(cfg)))


def embed_tokens(params: Embedding, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = sh_lib.embedding(tokens, params.tok)
    if cfg.tie_embeddings:
        # gemma-style sqrt(d) scaling when the table doubles as the LM head:
        # the f32 square root rounded to the activation dtype first
        x = x * torch.sqrt(torch.tensor(float(cfg.d_model))).to(x.dtype)
    return x


class LMHead(nn.Module):
    """The untied head's ``w`` (d_model, vocab); no parameter when tied."""

    def __init__(self, w=None):
        super().__init__()
        self.w = None if w is None else _param(w)


def init_lm_head(gen: torch.Generator, cfg: ModelConfig) -> LMHead:
    if cfg.tie_embeddings:
        return LMHead()
    return LMHead(dense_init(gen, cfg.d_model, cfg.vocab_size, _dtype(cfg)))


def lm_logits(head: LMHead, embed: Embedding, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final projection, f32 output, optional logit softcapping (gemma2)."""
    w = embed.tok.t() if cfg.tie_embeddings else head.w
    logits = sh_lib.linear(x, w, _matmul_f32)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def softcap(x: torch.Tensor, cap) -> torch.Tensor:
    return cap * torch.tanh(x / cap)
