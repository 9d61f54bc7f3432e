"""arctic-480b [moe] — 128 experts top-2 + dense residual
(hf:Snowflake/snowflake-arctic-base).

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000; every layer has a
dense FFN residual in parallel with the MoE branch (dense-MoE hybrid).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    rope_theta=1e4,
    n_experts=128,
    experts_per_token=2,
    moe_d_ff=4864,
    moe_dense_residual=True,
    optimizer="adafactor",
)
