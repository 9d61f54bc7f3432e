"""seamless-m4t-medium [audio] — enc-dec backbone (arXiv:2308.11596).

12L decoder + 12L encoder, d_model=1024 16H (kv=16) d_ff=4096
vocab=256206. The speech frontend is a STUB: input_specs() provides
precomputed frame embeddings (B, S_enc, d_model) for the encoder.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    rope_theta=1e4,
    n_enc_layers=12,
    cross_attention=True,
    optimizer="adamw",
)
