"""Zamba2-1.2B [arXiv:2411.15242]: Mamba2 backbone + shared attention blocks.

38 Mamba2 blocks; a shared transformer block (2 alternating weight sets) is
invoked after every 6th block, Zamba2-style (LoRA-per-invocation omitted —
DESIGN.md §5).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm=True,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    attn_every=6,
    n_shared_attn=2,
    mlp_type="swiglu",
)
