"""HuBERT-XLarge [arXiv:2106.07447]: encoder-only; conv frontend is a STUB
(precomputed frame embeddings). vocab=504 target units."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    is_encoder=True,
    causal=False,
    mlp_type="gelu",
    frontend="audio_stub",
)
