"""Architecture configs + input-shape registry for the assigned pool.

A copy of ``repro.configs.base``, kept in the port so that it imports
nothing of the reference package. Every architecture is a frozen
:class:`ArchConfig`; reduced versions (``cfg.reduced()``) are used by the CPU
tests. ``use_pallas`` is kept as a field so that a config written for the
reference compares field by field, but it selects nothing here: the device
of the tensors decides the attention route (``kernels.ops``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Iterable

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "get_config", "ALL_ARCHS", "cells_for"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | vlm | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # layer flavour
    mlp_type: str = "swiglu"  # swiglu | geglu | gelu
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    causal: bool = True
    is_encoder: bool = False

    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    moe_interleave: int = 1  # MoE replaces the FFN every Nth layer
    n_shared_experts: int = 0
    router: str = "topk"  # topk | potus (beyond-paper Lyapunov router)
    capacity_factor: float = 1.25
    potus_router_beta: float = 1.0  # price weight on expert virtual queues

    # SSM / hybrid
    ssm: bool = False
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4
    attn_every: int = 0  # hybrid: shared attention block after every Nth block
    n_shared_attn: int = 0

    # modality frontend stubs (precomputed embeddings via input_specs)
    frontend: str | None = None  # vision_stub | audio_stub
    n_frontend_tokens: int = 0

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # attention blocking for long sequences (XLA path)
    attn_chunk: int = 2048
    dense_attn_max_seq: int = 8192  # use one-shot einsum attention below this

    use_pallas: bool = False
    # optional PartitionSpec (as a tuple) constraining residual activations
    # at layer boundaries, e.g. ("data", "model", None) = Megatron-SP
    act_sharding: tuple | None = None
    # constrain router logits/probs to token-sharded + replicated-expert
    # layout (top_k over an expert-sharded axis otherwise gathers per layer)
    router_replicate_hint: bool = False
    # EP layout: which mesh axis experts shard over; the expert-FFN inner dim
    # takes the other axis ("model" -> ff over data, "data" -> ff over model)
    ep_axis: str = "model"
    # explicit shard_map expert parallelism (all_to_all dispatch) instead of
    # the GSPMD scatter/gather lowering — see models/moe_ep.py
    moe_ep_shardmap: bool = False

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.ssm and self.attn_every == 0

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k cell."""
        return self.ssm  # pure SSM or hybrid-with-rare-attn

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter accounting (roofline MODEL_FLOPS) -------------------
    def _ffn_params(self, d_ff: int) -> int:
        n_mats = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        return n_mats * self.d_model * d_ff

    def _layer_params(self, layer_idx: int) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        p = 0
        if self.ssm:
            d_in = self.ssm_expand * d
            nheads = d_in // self.ssm_headdim
            # in_proj -> [z, x, B, C, dt], conv, out_proj, A/D/dt_bias, norm
            p += d * (2 * d_in + 2 * self.ssm_state + nheads)
            p += (d_in + 2 * self.ssm_state) * self.ssm_conv
            p += d_in * d + 3 * nheads + 2 * d
        else:
            p += d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
            p += (self.n_heads * hd) * d
            p += 2 * d  # norms
            if self.moe and (layer_idx % self.moe_interleave == self.moe_interleave - 1):
                p += self.n_experts * self._ffn_params(self.d_ff)
                p += self.n_shared_experts * self._ffn_params(self.d_ff)
                p += d * self.n_experts  # router
            else:
                dense_ff = self.d_ff if not self.moe else max(self.d_ff, 4 * d)
                p += self._ffn_params(dense_ff if self.moe else self.d_ff)
        return p

    def param_count(self) -> int:
        p = self.vocab_size * self.d_model  # embedding
        if not self.tie_embeddings:
            p += self.vocab_size * self.d_model
        p += sum(self._layer_params(li) for li in range(self.n_layers))
        if self.attn_every:  # shared attention blocks (hybrid)
            d, hd = self.d_model, self.resolved_head_dim
            per = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d + 2 * d
            p += self.n_shared_attn * per
        return p

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: only top_k experts count)."""
        if not self.moe:
            return self.param_count()
        full = self.param_count()
        n_moe_layers = sum(
            1 for li in range(self.n_layers) if li % self.moe_interleave == self.moe_interleave - 1
        )
        inactive = n_moe_layers * (self.n_experts - self.top_k) * self._ffn_params(self.d_ff)
        return full - inactive

    # ---- smoke-test shrink ----------------------------------------------
    def reduced(self) -> "ArchConfig":
        kw = dict(
            n_layers=max(2, min(4, self.n_layers)),
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)) if self.n_kv_heads < self.n_heads else 4,
            d_ff=256,
            vocab_size=512,
            head_dim=32 if self.head_dim else 0,
            param_dtype="float32",
            compute_dtype="float32",
            attn_chunk=64,
            dense_attn_max_seq=128,
        )
        if self.moe:
            # generous capacity so smoke tests see no token drops
            kw.update(n_experts=4, top_k=min(self.top_k, 2),
                      moe_interleave=self.moe_interleave, capacity_factor=4.0)
        if self.ssm:
            kw.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16)
        if self.attn_every:
            kw.update(attn_every=2, n_shared_attn=2, n_layers=4)
        if self.frontend:
            kw.update(n_frontend_tokens=8)
        return self.with_(**kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

ALL_ARCHS = [
    "qwen2_5_32b",
    "gemma_7b",
    "stablelm_3b",
    "deepseek_7b",
    "llama4_maverick_400b",
    "granite_moe_1b",
    "zamba2_1_2b",
    "internvl2_1b",
    "hubert_xlarge",
    "mamba2_1_3b",
]


def get_config(name: str) -> ArchConfig:
    mod = importlib.import_module(f"{__package__}.{name.replace('-', '_')}")
    return mod.CONFIG


def cells_for(cfg: ArchConfig) -> Iterable[ShapeSpec]:
    """Shape cells applicable to an architecture (skips per DESIGN.md §5)."""
    for s in SHAPES.values():
        if cfg.is_encoder and s.kind == "decode":
            continue  # encoder-only: no autoregressive step
        if s.name == "long_500k" and not cfg.subquadratic:
            continue  # needs sub-quadratic attention
        yield s
