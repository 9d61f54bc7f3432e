"""Mamba2 / SSD (state-space duality) blocks — arXiv:2405.21060 (the port
of ``repro.models.ssm``).

Implements the chunked SSD algorithm (quadratic intra-chunk + decayed
inter-chunk state passing) for training/prefill, and the O(1)-per-token
recurrent step for decode. Grouping G=1 (single B/C group broadcast over
heads), depthwise causal conv of width 4, gated RMSNorm, SiLU.

``torch.einsum`` fixes no contraction order for three or more operands,
so the SSD products agree with the reference to f32 rounding, not bits.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models import sharding as sh_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (RMSNorm, _dtype, _normal, _param, dense_init,
                                       init_rmsnorm, rmsnorm, silu)


class SSMCache(NamedTuple):
    conv: torch.Tensor  # (B, W-1, conv_dim) last inputs of the causal conv
    state: torch.Tensor  # (B, H, P, N) recurrent SSM state


def conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state  # x, B, C channels (G=1)


class SSM(nn.Module):
    def __init__(self, in_proj, conv_w, conv_b, A_log, D, dt_bias, norm: RMSNorm, out_proj):
        super().__init__()
        self.in_proj, self.conv_w, self.conv_b = _param(in_proj), _param(conv_w), _param(conv_b)
        self.A_log, self.D, self.dt_bias = _param(A_log), _param(D), _param(dt_bias)
        self.norm = norm
        self.out_proj = _param(out_proj)


def init_ssm(gen: torch.Generator, cfg: ModelConfig) -> SSM:
    dt = _dtype(cfg)
    dev = gen.device
    H = cfg.ssm_heads
    N = cfg.ssm_state
    d_in_proj = 2 * cfg.d_inner + 2 * N + H  # z, x, B, C, dt
    in_proj = dense_init(gen, cfg.d_model, d_in_proj, dt)
    conv_w = _normal(gen, (cfg.ssm_conv_width, conv_dim(cfg)), 0.1, dt)
    # Mamba2 reference init: A ~ -Uniform(1, 16); dt sampled log-uniform in
    # [1e-3, 1e-1] through an inverse-softplus bias.
    a_init = torch.rand((H,), generator=gen, device=dev) * 15.0 + 1.0
    dt_init = torch.exp(torch.rand((H,), generator=gen, device=dev)
                        * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))  # softplus^{-1}(dt)
    return SSM(in_proj, conv_w, torch.zeros((conv_dim(cfg),), dtype=dt, device=dev),
               torch.log(a_init), torch.ones((H,), device=dev), dt_bias,
               init_rmsnorm(cfg.d_inner, dt, dev), dense_init(gen, cfg.d_inner, cfg.d_model, dt))


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``einsum`` with jnp's type promotion (bf16 with f32 gives f32)."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def _split_in_proj(z_x_b_c_dt: torch.Tensor, cfg: ModelConfig):
    N = cfg.ssm_state
    di = cfg.d_inner
    z, xbc, dt = torch.split(z_x_b_c_dt, [di, di + 2 * N, cfg.ssm_heads], dim=-1)
    return z, xbc, dt  # xbc = [x, B, C] conv channels


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with kernel (W, C): the taps
    summed in order, as the reference's unrolled loop sums them."""
    W = w.shape[0]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(W):
        out = out + pad[:, i:i + xbc.shape[1], :] * w[i]
    return out + b


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T) lower-tri segment sums; -inf above diagonal."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_scan(
    x: torch.Tensor,  # (B, S, H, P) inputs (dt already applied by caller)
    dA: torch.Tensor,  # (B, S, H)  = dt * A  (negative)
    Bmat: torch.Tensor,  # (B, S, N)  G=1 group
    Cmat: torch.Tensor,  # (B, S, N)
    chunk: int,
    initial_state: torch.Tensor | None = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. Returns (y (B,S,H,P), final_state (B,H,P,N))."""
    Bsz, S, H, P = x.shape
    N = Bmat.shape[-1]
    if S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    C_ = S // chunk

    xc = x.reshape(Bsz, C_, chunk, H, P)
    Ac = dA.reshape(Bsz, C_, chunk, H).permute(0, 3, 1, 2)  # (B, H, C, L)
    Bc = Bmat.reshape(Bsz, C_, chunk, N)
    Cc = Cmat.reshape(Bsz, C_, chunk, N)

    A_cumsum = torch.cumsum(Ac, dim=-1)  # (B, H, C, L)

    # 1. intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(Ac))  # (B, H, C, L, L)
    Y_diag = _einsum("bcln,bcsn,bhcls,bcshp->bclhp", Cc, Bc, L, xc)

    # 2. per-chunk end states
    decay_states = torch.exp(A_cumsum[..., -1:] - A_cumsum)  # (B, H, C, L)
    states = _einsum("bcln,bhcl,bclhp->bchpn", Bc, decay_states, xc)

    # 3. inter-chunk recurrence (a loop over chunks), the state in f32
    chunk_decay = torch.exp(A_cumsum[..., -1])  # (B, H, C) f32
    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    states = states.float()
    entry = []
    for c in range(C_):
        entry.append(state)  # the state *entering* chunk c
        state = state * chunk_decay[:, :, c, None, None] + states[:, c]
    entry_states = torch.stack(entry, dim=1)  # (B, C, H, P, N)

    # 4. contribution of the entering state to each position in the chunk
    state_decay = torch.exp(A_cumsum)  # (B, H, C, L)
    Y_off = _einsum("bcln,bchpn,bhcl->bclhp", Cc, entry_states, state_decay)

    y = (Y_diag + Y_off).to(x.dtype).reshape(Bsz, S, H, P)
    return y, state


def _ssd_scan_on_mesh(x, dA, Bmat, Cmat, chunk: int):
    """``ssd_scan`` of DTensors, each rank on its own rows and heads by an
    explicit rule (``local_map``): the scan runs along the sequence, which
    stays whole; x's and dA's cut of the heads is kept, B and C are whole
    over it."""
    import functools

    xp = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate() for p in x.placements]
    bp = [p if p == Shard(0) else Replicate() for p in xp]
    statep = [Shard(1) if p == Shard(2) else p for p in xp]  # (B, H, P, N)
    return local_map(functools.partial(ssd_scan, chunk=chunk), out_placements=(xp, statep),
                     in_placements=(xp, xp, bp, bp), device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x, dA, Bmat, Cmat)


def apply_ssm(params: SSM, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    y, _ = apply_ssm_with_state(params, x, cfg)
    return y


def apply_ssm_with_state(params: SSM, x: torch.Tensor, cfg: ModelConfig):
    y, state, _ = _apply_ssm(params, x, cfg)
    return y, state


def _apply_ssm(params: SSM, x: torch.Tensor, cfg: ModelConfig):
    """``apply_ssm_with_state`` that also returns the pre-conv ``xbc`` (the
    prompt's conv cache is its last W-1 rows; the reference recomputes the
    projection for it, which gives the same values)."""
    S = x.shape[1]
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state

    zxbcdt = sh_lib.linear(x, params.in_proj)
    z, xbc_in, dt = _split_in_proj(zxbcdt, cfg)
    xbc = silu(_causal_conv(xbc_in, params.conv_w, params.conv_b))
    xs, Bmat, Cmat = torch.split(xbc, [cfg.d_inner, N, N], dim=-1)

    dt = F.softplus(dt.float() + params.dt_bias)  # (B,S,H)
    A = -torch.exp(params.A_log)  # (H,)
    xs_h = sh_lib.split_heads(xs, H, P)
    x_dt = xs_h * dt[..., None].to(xs.dtype)
    dA = dt * A  # (B, S, H) fp32

    # pad to a chunk multiple; padded steps are identity (dA=0, x=0) so the
    # final state is exact for any S
    S_pad = -(-S // cfg.ssm_chunk) * cfg.ssm_chunk
    if S_pad != S:
        pad = S_pad - S
        x_dt = F.pad(x_dt, (0, 0, 0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
        Bmat = F.pad(Bmat, (0, 0, 0, pad))
        Cmat = F.pad(Cmat, (0, 0, 0, pad))

    scan = _ssd_scan_on_mesh if sh_lib.is_dtensor(x_dt) else ssd_scan
    y, final_state = scan(x_dt, dA, Bmat, Cmat, cfg.ssm_chunk)
    if S_pad != S:
        y = y[:, :S]
    y = y + params.D.to(y.dtype)[None, None, :, None] * xs_h
    y = sh_lib.merge_heads(y)
    y = y * silu(z)
    y = rmsnorm(params.norm, y, cfg.norm_eps)
    return sh_lib.linear(y, params.out_proj), final_state, xbc_in


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device="cuda") -> SSMCache:
    return SSMCache(
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim(cfg)), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                          dtype=torch.float32, device=device),
    )


def decode_ssm(
    params: SSM,
    x: torch.Tensor,  # (B, 1, D)
    cache: SSMCache,
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, SSMCache]:
    """Single-token recurrent step: h <- exp(dt A) h + dt B x ; y = C h + D x.
    The recurrence runs in f32; the conv over the window is one einsum."""
    Bsz = x.shape[0]
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state

    zxbcdt = sh_lib.linear(x[:, 0], params.in_proj)  # (B, proj)
    z, xbc, dt = _split_in_proj(zxbcdt, cfg)

    # conv over the cached window + current input
    window = torch.cat([cache.conv, xbc[:, None, :]], dim=1)  # (B, W, C)
    conv_out = _einsum("bwc,wc->bc", window, params.conv_w) + params.conv_b
    xbc_t = silu(conv_out)
    new_conv = window[:, 1:, :]

    xs, Bmat, Cmat = torch.split(xbc_t, [cfg.d_inner, N, N], dim=-1)
    dt = F.softplus(dt.float() + params.dt_bias)  # (B, H)
    A = -torch.exp(params.A_log)  # (H,)
    dA = torch.exp(dt * A)  # (B, H)

    xs_h = sh_lib.split_heads(xs, H, P).float()
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt, Bmat.float(), xs_h)
    state = cache.state * dA[..., None, None] + dBx  # (B, H, P, N)
    y = torch.einsum("bhpn,bn->bhp", state, Cmat.float())
    y = y + params.D[None, :, None] * xs_h
    y = y.reshape(Bsz, cfg.d_inner).to(x.dtype)
    y = y * silu(z)
    y = rmsnorm(params.norm, y, cfg.norm_eps)
    out = sh_lib.linear(y, params.out_proj)[:, None, :]  # (B, 1, D)
    return out, SSMCache(conv=new_conv, state=state)
