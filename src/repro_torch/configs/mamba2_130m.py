"""mamba2-130m [ssm] — SSD, attention-free (arXiv:2405.21060).

24L d_model=768, d_ff=0 (pure Mamba blocks, no MLP), vocab=50280,
ssm_state=128, expand=2 -> d_inner=1536, head_dim=64 -> 24 SSD heads.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    tie_embeddings=True,
    optimizer="adamw",
)
