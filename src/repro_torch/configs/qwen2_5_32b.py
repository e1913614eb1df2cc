"""Qwen2.5-32B [hf:Qwen/Qwen2.5-0.5B family; hf-verified dims for 32B]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,       # Qwen2-family QKV bias
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
)
