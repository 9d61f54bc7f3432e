"""Grouped-query attention with RoPE, KV cache, sliding windows, softcap
(the port of ``repro.models.attention``).

Covers every attention variant in the assigned pool:
  * GQA with arbitrary (n_heads, n_kv_heads), optional QKV bias (qwen2),
  * local/global alternation + attn-logit softcapping (gemma2),
  * bidirectional encoder attention + cross attention (seamless),
  * one-token decode against a preallocated KV cache (serve_step).

The algebra is the reference's as written: scores in f32 from the operands
(exact products of bf16 values), softcap before the mask, masked scores
set to ``NEG_INF``, the softmax in f32 cast to the activation dtype before
it weights v. ``scaled_dot_product_attention`` takes neither the softcap
nor that order, so it is not used here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models import sharding as sh_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _dtype, _param, apply_rope, dense_init, softcap

NEG_INF = -2.0**30  # large-negative fp32/bf16-safe mask value


class KVCache(NamedTuple):
    """Per-layer slice of the decode cache."""

    k: torch.Tensor  # (B, max_seq, KV, hd)
    v: torch.Tensor  # (B, max_seq, KV, hd)


class Attention(nn.Module):
    """``wq``, ``wk``, ``wv``, ``wo`` in (in, out) layout; ``bq``, ``bk``,
    ``bv`` with ``qkv_bias``, else None."""

    def __init__(self, wq, wk, wv, wo, bq=None, bk=None, bv=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = _param(wq), _param(wk), _param(wv), _param(wo)
        self.bq, self.bk, self.bv = (None if b is None else _param(b) for b in (bq, bk, bv))


def init_attention(gen: torch.Generator, cfg: ModelConfig, cross: bool = False) -> Attention:
    dt = _dtype(cfg)
    ws = (dense_init(gen, cfg.d_model, cfg.q_dim, dt), dense_init(gen, cfg.d_model, cfg.kv_dim, dt),
          dense_init(gen, cfg.d_model, cfg.kv_dim, dt), dense_init(gen, cfg.q_dim, cfg.d_model, dt))
    if not cfg.qkv_bias:
        return Attention(*ws)
    dev = gen.device
    return Attention(*ws, torch.zeros((cfg.q_dim,), dtype=dt, device=dev),
                     torch.zeros((cfg.kv_dim,), dtype=dt, device=dev),
                     torch.zeros((cfg.kv_dim,), dtype=dt, device=dev))


def _project_qkv(params: Attention, xq: torch.Tensor, xkv: torch.Tensor, cfg: ModelConfig):
    hd = cfg.resolved_head_dim
    q = sh_lib.linear(xq, params.wq)
    k = sh_lib.linear(xkv, params.wk)
    v = sh_lib.linear(xkv, params.wv)
    if cfg.qkv_bias:
        q = q + params.bq
        k = k + params.bk
        v = v + params.bv
    return (sh_lib.split_heads(q, cfg.n_heads, hd), sh_lib.split_heads(k, cfg.n_kv_heads, hd),
            sh_lib.split_heads(v, cfg.n_kv_heads, hd))


def _sqrt_f32(n: int) -> torch.Tensor:
    """sqrt(n) in f32, as the reference's ``jnp.sqrt(hd)``: a 0-dim CPU
    tensor, which a device tensor's op takes as a scalar (no launch)."""
    return torch.sqrt(torch.tensor(float(n)))


def _sdpa(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, KV, hd)
    v: torch.Tensor,  # (B, Skv, KV, hd)
    mask: Optional[torch.Tensor],  # broadcastable to (B, H, Sq, Skv) or None
    cfg: ModelConfig,
    *,
    decode: bool = False,
) -> torch.Tensor:
    """SDPA with GQA, fp32 softmax. Head h reads KV head h // (H // KV), as
    the reference's ``jnp.repeat`` of the KV heads gives it; the heads are
    grouped in the products instead of repeated in memory. Outside
    ``decode`` the operands take the reference's constraints; a decode
    step keeps the cache's layout. DTensor operands go to
    ``_sdpa_on_mesh``."""
    if not decode:
        q = sh_lib.constrain(q, "batch", "seq", "heads", None)
    if sh_lib.is_dtensor(q):
        return _sdpa_on_mesh(q, k, v, mask, cfg, decode)
    return _weighted(torch.softmax(_scores(q, k, mask, cfg), dim=-1).to(q.dtype), v)


def _scores(q, k, mask, cfg: ModelConfig) -> torch.Tensor:
    """The masked f32 scores (B, H, Sq, Skv), the KV heads grouped."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4)  # (B, KV, G, Sq, hd)
    kt = k.permute(0, 2, 3, 1).unsqueeze(2)  # (B, KV, 1, hd, Skv)
    scores = (qg.float() @ kt.float()).reshape(B, H, Sq, Skv)
    scores = scores / _sqrt_f32(hd)
    if cfg.attn_softcap:
        scores = softcap(scores, cfg.attn_softcap)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    return scores


def _weighted(probs, v) -> torch.Tensor:
    """``probs`` (B, H, Sq, Skv) times the values (B, Skv, KV, hd), the KV
    heads grouped: (B, Sq, H, hd)."""
    B, H, Sq, Skv = probs.shape
    KV, hd = v.shape[2], v.shape[3]
    out = probs.reshape(B, KV, H // KV, Sq, Skv) @ v.permute(0, 2, 1, 3).unsqueeze(2)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


def _sdpa_on_mesh(q, k, v, mask, cfg: ModelConfig, decode: bool) -> torch.Tensor:
    """``_sdpa`` of DTensors, each rank on its own rows and heads by an
    explicit rule (``local_map``): the batch and the heads may be cut (the
    KV heads with the query heads, repeated as the reference repeats them
    where a cut of the query heads does not divide them), and the keys'
    positions (a decode step's cache cut over its sequence, when its KV
    heads do not divide the "model" axis). A cut of the positions is the
    reference's flash-decode: each rank's scores over its positions, their
    max and sum of exps reduced over the cut (``Partial``), and the
    weighted values summed; the query heads are whole on those axes."""
    mesh = q.device_mesh
    seq = {i for i, p in enumerate(k.placements) if isinstance(p, Shard) and p.dim == 1}
    qp = [p if isinstance(p, Shard) and p.dim in (0, 2) and i not in seq else Replicate()
          for i, p in enumerate(q.placements)]
    q = q.redistribute(mesh, qp)
    H, KV = q.shape[2], k.shape[2]
    if KV % sh_lib.shard_ways(q, 2):
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    if not decode:
        kv_axis = "heads" if k.shape[2] == H else "kv_heads"
        k = sh_lib.constrain(k, "batch", "kv_seq", kv_axis, None)
        v = sh_lib.constrain(v, "batch", "kv_seq", kv_axis, None)
    kp = [Shard(1) if i in seq else p for i, p in enumerate(qp)]
    k, v = k.redistribute(mesh, kp), v.redistribute(mesh, kp)
    if mask is not None:
        if not sh_lib.is_dtensor(mask):
            mask = DTensor.from_local(mask, mesh, [Replicate()] * mesh.ndim, run_check=False)
        mask = mask.redistribute(mesh, [
            Shard(3) if i in seq else
            Shard(0) if p == Shard(0) and mask.shape[0] > 1 else Replicate()
            for i, p in enumerate(qp)])
    mp = mask.placements if mask is not None else None
    if not seq:
        return local_map(lambda q_, k_, v_, m_: _weighted(
            torch.softmax(_scores(q_, k_, m_, cfg), dim=-1).to(q_.dtype), v_),
            out_placements=qp, in_placements=(qp, kp, kp, mp), device_mesh=mesh)(q, k, v, mask)

    # (B, H, Sq, Skv) scores: the query heads' cut is dim 1 there, the positions' dim 3
    sp = [Shard(3) if i in seq else Shard(1) if p == Shard(2) else p for i, p in enumerate(qp)]
    scores = local_map(lambda q_, k_, m_: _scores(q_, k_, m_, cfg), out_placements=sp,
                       in_placements=(qp, kp, mp), device_mesh=mesh)(q, k, mask)
    top = local_map(lambda s_: torch.amax(s_, dim=-1),
                    out_placements=[Partial("max") if i in seq else p for i, p in enumerate(sp)],
                    in_placements=(sp,), device_mesh=mesh)(scores.detach())
    whole = [Replicate() if i in seq else p for i, p in enumerate(sp)]  # (B, H, Sq) rows
    summed = [Partial() if i in seq else p for i, p in enumerate(sp)]
    top = top.redistribute(mesh, whole)

    def partials(s_, t_, v_):
        e = torch.exp(s_ - t_[..., None])
        return torch.sum(e, dim=-1), _weighted(e.to(q.dtype), v_)

    total, acc = local_map(partials, out_placements=(summed, [Partial() if i in seq else p
                                                              for i, p in enumerate(qp)]),
                           in_placements=(sp, whole, kp), device_mesh=mesh)(scores, top, v)
    total = total.redistribute(mesh, whole)
    acc = acc.redistribute(mesh, qp)
    return (acc.float() / total.permute(0, 2, 1)[..., None]).to(q.dtype)


def _streaming_sdpa(
    q: torch.Tensor,  # (B, S, H, hd) — RoPE already applied
    k: torch.Tensor,  # (B, S, H, hd) — KV heads already repeated
    v: torch.Tensor,
    cfg: ModelConfig,
    is_local: bool,
) -> torch.Tensor:
    """Flash-style attention: an outer loop over query chunks, an inner one
    over KV chunks with an online max and sum. Peak score memory is
    O(qc * kc) a step instead of O(S^2); the FLOPs match the dense masked
    form (which also computes the full square).

    Local (sliding-window) layers with window <= chunk visit a fixed band of
    2 chunks, {qi - 1, qi} (chunk 0 twice at qi = 0: the second visit
    doubles l and acc, which cancel in acc / l)."""
    B, S, H, hd = q.shape
    C = min(cfg.streaming_chunk, S)
    if cfg.sliding_window:
        C = min(C, max(cfg.sliding_window, 128))
    nq = S // C
    dev = q.device
    scale = 1.0 / _sqrt_f32(hd)

    qc = q.reshape(B, nq, C, H, hd)
    kc = k.reshape(B, nq, C, H, hd)
    vc = v.reshape(B, nq, C, H, hd)
    q_pos = torch.arange(S, device=dev).reshape(nq, C)
    kv_off = torch.arange(C, device=dev)

    def attend_block(qi, q_blk, kv_idx, k_blk, v_blk, m, l, acc):
        """Online-softmax update of one (q_blk, kv_blk) pair."""
        s = torch.einsum("bchd,bkhd->bhck", q_blk.float(), k_blk.float()) * scale
        if cfg.attn_softcap:
            s = softcap(s, cfg.attn_softcap)
        qp = q_pos[qi][:, None]  # (C, 1)
        kp = (kv_idx * C + kv_off)[None, :]  # (1, C)
        mask = kp <= qp
        if cfg.sliding_window and is_local:
            mask = mask & (kp > qp - cfg.sliding_window)
        s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))  # (B, H, C)
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + torch.sum(p, dim=-1)
        acc_new = acc * corr[..., None] + torch.einsum(
            "bhck,bkhd->bhcd", p.to(q.dtype).float(), v_blk.float())
        return m_new, l_new, acc_new

    band = bool(cfg.sliding_window and cfg.sliding_window <= C and is_local)
    outs = []
    for qi in range(nq):
        q_blk = qc[:, qi]  # (B, C, H, hd)
        state = (torch.full((B, H, C), NEG_INF, dtype=torch.float32, device=dev),
                 torch.zeros((B, H, C), dtype=torch.float32, device=dev),
                 torch.zeros((B, H, C, hd), dtype=torch.float32, device=dev))
        kv_chunks = (max(qi - 1, 0), qi) if band else range(nq)
        for kj in kv_chunks:
            state = attend_block(qi, q_blk, kj, kc[:, kj], vc[:, kj], *state)
        _, l, acc = state
        out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
        outs.append(out.transpose(1, 2))  # (B, C, H, hd)
    return torch.cat(outs, dim=1)


def causal_mask(Sq: int, Skv: int, window: int = 0, offset: int = 0,
                device=None) -> torch.Tensor:
    """(1, 1, Sq, Skv) boolean mask. ``offset`` = absolute position of query 0.
    ``window`` > 0 restricts to a sliding window (local attention)."""
    qpos = torch.arange(Sq, device=device)[:, None] + offset
    kpos = torch.arange(Skv, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m = m & (kpos > qpos - window)
    return m[None, None]


def attend(
    params: Attention,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    *,
    is_local: bool = False,
    causal: bool = True,
) -> torch.Tensor:
    """Full-sequence attention (training / prefill without cache return)."""
    out, _ = attend_with_kv(params, x, positions, cfg, is_local=is_local, causal=causal)
    return out


def attend_with_kv(
    params: Attention,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    *,
    is_local: bool = False,
    causal: bool = True,
) -> Tuple[torch.Tensor, KVCache]:
    S = x.shape[1]
    q, k, v = _project_qkv(params, x, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if causal and S >= cfg.streaming_attn_threshold and S % min(cfg.streaming_chunk, S) == 0:
        G = cfg.n_heads // k.shape[2]
        kf = k.repeat_interleave(G, dim=2) if G != 1 else k
        vf = v.repeat_interleave(G, dim=2) if G != 1 else v
        qs = sh_lib.constrain(q, "batch", "seq", "heads", None)
        kf = sh_lib.constrain(kf, "batch", "kv_seq", "heads", None)
        vf = sh_lib.constrain(vf, "batch", "kv_seq", "heads", None)
        out = _streaming_sdpa(qs, kf, vf, cfg, is_local)
    else:
        mask = None  # non-causal: every key, the reference's all-true mask
        if causal:
            window = cfg.sliding_window if (cfg.sliding_window and is_local) else 0
            mask = causal_mask(S, S, window=window, device=x.device)
        out = _sdpa(q, k, v, mask, cfg)
    out = sh_lib.linear(sh_lib.merge_heads(out), params.wo)
    return out, KVCache(k=k, v=v)


def cross_attend(
    params: Attention,
    x: torch.Tensor,
    memory: torch.Tensor,
    cfg: ModelConfig,
) -> torch.Tensor:
    """Encoder-decoder cross attention (no RoPE on cross keys, full mask)."""
    q, k, v = _project_qkv(params, x, memory, cfg)
    out = _sdpa(q, k, v, None, cfg)
    return sh_lib.linear(sh_lib.merge_heads(out), params.wo)


def cache_slots(cache_len: torch.Tensor, max_seq: int):
    """Where one decode step writes each row's K/V in a layer's cache viewed
    as (B * max_seq, KV * hd): row b at ``b * max_seq + cache_len[b]``, and
    a 0/1 weight that is 0 for a row already at ``max_seq`` (whose one-hot
    in the reference is all zeros: nothing is written). The same for every
    layer of a step, so ``decode_step`` computes it once."""
    B = cache_len.shape[0]
    base = torch.arange(B, device=cache_len.device) * max_seq
    idx = base + torch.clamp(cache_len, max=max_seq - 1)
    return idx, (cache_len < max_seq)[:, None]


def _write_kv_sharded(cache: KVCache, k: torch.Tensor, v: torch.Tensor, cache_len: torch.Tensor,
                      ragged: bool) -> None:
    """A decode step's K/V written into a sharded cache (DTensors) as the
    reference writes them, by a one-hot over the cache's positions, an
    elementwise op that each rank runs on its own rows, heads and positions
    of the cache: ``ragged`` adds each row's K/V at its own length (nothing
    at a full row's), else every row takes row 0's length, clamped into the
    cache, and is overwritten there."""
    max_seq = cache.k.shape[1]
    kpos = torch.arange(max_seq, device=cache_len.device)[None, :]
    if ragged:
        hit = (kpos == cache_len[:, None]).to(cache.k.dtype)[:, :, None, None]  # (B, S, 1, 1)
        cache.k.add_(k.to(cache.k.dtype) * hit)
        cache.v.add_(v.to(cache.v.dtype) * hit)
    else:
        hit = (kpos == torch.clamp(cache_len[:1], max=max_seq - 1)[:, None])[:, :, None, None]
        cache.k.copy_(torch.where(hit, k.to(cache.k.dtype), cache.k))
        cache.v.copy_(torch.where(hit, v.to(cache.v.dtype), cache.v))


def decode_attend(
    params: Attention,
    x: torch.Tensor,  # (B, 1, D) current token activations
    cache: KVCache,  # preallocated (B, max_seq, KV, hd)
    cache_len: torch.Tensor,  # (B,) current lengths (tokens already in cache)
    cfg: ModelConfig,
    *,
    is_local: bool = False,
    slots=None,
) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode: append K/V at cache_len, attend over the prefix.

    The cache's tensors are updated in place and returned (the reference
    returns new arrays; its serve step donates the old ones). ``ragged``:
    each row adds its K/V at its own length (``slots``, from
    ``cache_slots`` when not given), the reference's one-hot add, whose
    indices are unique, with no cache-sized temporaries; else every row is
    written at row 0's length, clamped into the cache as the reference's
    ``dynamic_update_slice`` clamps it."""
    B = x.shape[0]
    max_seq = cache.k.shape[1]
    positions = cache_len[:, None]  # (B, 1)
    q, k, v = _project_qkv(params, x, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if sh_lib.is_dtensor(cache.k):
        _write_kv_sharded(cache, k, v, cache_len, cfg.ragged_decode)
    elif cfg.ragged_decode:
        idx, keep = slots if slots is not None else cache_slots(cache_len, max_seq)
        row = k.shape[2] * k.shape[3]
        keep = keep.to(k.dtype)
        cache.k.view(B * max_seq, row).index_add_(0, idx, k.reshape(B, row) * keep)
        cache.v.view(B * max_seq, row).index_add_(0, idx, v.reshape(B, row) * keep)
    else:
        pos = torch.clamp(cache_len[:1], max=max_seq - 1).long()
        cache.k.index_copy_(1, pos, k.to(cache.k.dtype))
        cache.v.index_copy_(1, pos, v.to(cache.v.dtype))

    kpos = torch.arange(max_seq, device=x.device)[None, :]
    valid = kpos <= cache_len[:, None]
    if cfg.sliding_window and is_local:
        valid = valid & (kpos > (cache_len[:, None] - cfg.sliding_window))
    mask = valid[:, None, None, :]  # (B, 1, 1(Sq), max_seq)

    out = _sdpa(q, cache.k, cache.v, mask, cfg, decode=True)
    out = sh_lib.linear(sh_lib.merge_heads(out), params.wo)
    return out, cache
