"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-* family; unverified].

MoE 128 routed experts, top-1, plus one shared expert; MoE layers interleaved
every 2nd layer (matches the 400B-total / 17B-active budget — DESIGN.md §5).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    moe=True,
    n_experts=128,
    top_k=1,
    moe_interleave=2,
    n_shared_experts=1,
    mlp_type="swiglu",
)
