"""gemma2-9b [dense] — local/global alternation + softcaps (arXiv:2408.00118).

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000; head_dim=256,
sliding_window=4096 on local layers, attn softcap 50, logit softcap 30,
sandwich norms, GeGLU, tied embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    rope_theta=1e4,
    sliding_window=4096,
    layer_pattern=("local", "global"),
    attn_softcap=50.0,
    logit_softcap=30.0,
    sandwich_norm=True,
    act="gelu_tanh",
    tie_embeddings=True,
    optimizer="adamw",
)
