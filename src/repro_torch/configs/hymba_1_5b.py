"""hymba-1.5b [hybrid] — parallel attention + mamba heads (arXiv:2411.13676).

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16;
sliding-window attention everywhere except global layers {0, 16, 31}.
head_dim=64 (25 x 64 = 1600).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    rope_theta=1e4,
    sliding_window=1024,
    global_layer_indices=(0, 16, 31),
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    optimizer="adamw",
)
