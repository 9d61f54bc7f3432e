"""kimi-k2-1t-a32b [moe] — trillion-param MoE (arXiv:2501.kimi2).

61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840; MoE 384 experts
top-8 with 1 shared expert; first layer dense (DeepSeek-V3-style).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=18432,  # dense first layer FFN (DSv3-style wide dense layer)
    vocab_size=163840,
    rope_theta=5e4,
    n_experts=384,
    experts_per_token=8,
    moe_d_ff=2048,
    n_shared_experts=1,
    first_k_dense=1,
    optimizer="adafactor",
)
