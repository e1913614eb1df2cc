"""Granite-3.0 1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    moe=True,
    n_experts=32,
    top_k=8,
    moe_interleave=1,
    mlp_type="swiglu",
)
