"""internvl2-76b [vlm] — InternViT + LLM backbone (arXiv:2404.16821).

Backbone: 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
The ViT frontend is a STUB: input_specs() provides 256 precomputed patch
embeddings per image, projected and prepended to the token sequence.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=1e6,
    n_prefix_embeds=256,
    optimizer="adafactor",
)
