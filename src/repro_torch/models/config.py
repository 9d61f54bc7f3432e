"""Model configuration covering all assigned architecture families.

One frozen dataclass drives the composable decoder/enc-dec stack in
models/model.py: dense GQA transformers, MoE (token-dropping grouped
routing), Mamba2 SSD, hybrid (parallel attn+SSM), encoder-decoder, and
VLM/audio backbones with stub frontends.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention
    rope_theta: float = 1e4
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    sliding_window: int = 0  # 0 -> no local attention anywhere
    # cycled over layers; entries: "global" | "local"
    layer_pattern: Tuple[str, ...] = ("global",)
    # explicit overrides (e.g. hymba: global attention only at {0, mid, last})
    global_layer_indices: Tuple[int, ...] = ()
    sandwich_norm: bool = False  # gemma2: post-norms after attn/mlp

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    moe_dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    n_shared_experts: int = 0  # kimi/deepseek-style always-on expert
    first_k_dense: int = 0  # first k layers use a dense FFN instead of MoE
    capacity_factor: float = 1.25
    min_capacity: int = 8

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # encoder-decoder
    n_enc_layers: int = 0
    cross_attention: bool = False

    # multimodal stub frontends (precomputed embeddings from input_specs)
    n_prefix_embeds: int = 0  # e.g. ViT patch embeddings for VLM

    # serving: per-row cache positions (continuous batching), written in
    # place at each row's length; False = the uniform-length route (every
    # row written at row 0's length)
    ragged_decode: bool = True

    # streaming (flash-style) attention for sequences >= this threshold:
    # online-softmax over KV chunks, O(S*chunk) score memory instead of
    # O(S^2); local layers use a static 2-chunk band. Default off.
    streaming_attn_threshold: int = 1 << 60
    streaming_chunk: int = 1024

    # misc
    norm_eps: float = 1e-6
    act: str = "silu"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"  # activation/param dtype
    # training: remat recomputes each block in the backward
    # (torch.utils.checkpoint, models/model.py) and optimizer picks the
    # train step's update; scan_layers is the reference's lax.scan knob, kept
    # so that configs compare field for field and read by nothing (the
    # port's layers run as a Python loop, eagerly)
    remat: bool = True
    scan_layers: bool = True
    optimizer: str = "adamw"  # adamw | adafactor (framework default per arch)

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM state or sliding-window-only attention."""
        if self.family == "ssm":
            return True
        if self.family == "hybrid":
            return True  # SSM heads + sliding-window attention
        return False

    def pattern_for_layer(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def is_moe_layer(self, i: int) -> bool:
        return self.n_experts > 0 and i >= self.first_k_dense

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        base = dict(
            n_layers=min(self.n_layers, 2 + self.first_k_dense),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            moe_d_ff=128 if self.n_experts else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=32,
            n_enc_layers=min(self.n_enc_layers, 2),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            n_prefix_embeds=min(self.n_prefix_embeds, 8),
            dtype="float32",
            min_capacity=4,
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)
