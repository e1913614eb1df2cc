"""InternVL2-1B [arXiv:2404.16821]: InternViT frontend (STUB — precomputed
patch embeddings via input_specs) + Qwen2-0.5B-class LM backbone."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    mlp_type="swiglu",
    frontend="vision_stub",
    n_frontend_tokens=256,
)
