"""Gemma-7B [arXiv:2403.08295]: GeGLU, head_dim=256 (16 heads x 256 > d_model)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256_000,
    mlp_type="geglu",
    tie_embeddings=True,
)
