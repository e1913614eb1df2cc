"""Shared model building blocks in PyTorch — the port's counterpart of
``repro.models.common`` for the dense decoder.

Modules: :class:`RMSNorm`, :class:`MLP` (swiglu, geglu, gelu) and
:class:`Attention` (``_qkv``, the full-sequence ``forward`` and the one-token
``decode``); functions :func:`rms_norm`, :func:`rope`, :func:`apply_rope` and
:func:`einsum` (promoting mixed operands as ``jnp.einsum`` does).
The reference's bfloat16 rounding points are kept: ``rms_norm`` normalises
in float32, casts to ``x``'s type, then multiplies by the weight;
``rope`` works in float32 and ``apply_rope`` casts back.

Attention has one route: ``kernels.ops`` (or the namespace passed as
``ops``, e.g. ``kernels.ops.plain`` to compare routes on the card), which
launches the hand-written flash and decode attention kernels on CUDA
tensors and takes their plain versions on CPU tensors. The reference's
``use_pallas=False`` paths (``_dense_attention``, ``_chunked_attention``)
are not carried over as separate routes; ``cfg.use_pallas`` selects nothing.

Linear layers are ``nn.Linear`` (weight (out, in)); the reference's leaves
are (in, out) and ``convert.model_params_from_numpy`` transposes them.
"""
from __future__ import annotations

from functools import reduce

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["DTYPES", "einsum", "rms_norm", "rope", "apply_rope", "RMSNorm", "MLP", "Attention"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _ops(ops):
    if ops is None:
        from ..kernels import ops
    return ops


def einsum(eq, *operands):
    """``torch.einsum`` over operands promoted to one type first, as
    ``jnp.einsum`` promotes them (``torch.einsum`` refuses mixed types)."""
    dtype = reduce(torch.promote_types, (t.dtype for t in operands))
    return torch.einsum(eq, *(t.to(dtype) for t in operands))


# ---------------------------------------------------------------------------
# Normalization / rotary embedding
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps: float = 1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope(positions, head_dim: int, theta: float):
    """(..., S) int positions -> cos/sin of shape (..., S, head_dim//2)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, D); cos/sin: (B, S, D//2) or (S, D//2)."""
    x1, x2 = x.chunk(2, dim=-1)
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, dtype=None, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d, dtype=dtype, device=device))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """``w_out(act(w_gate x) * w_up x)`` for swiglu/geglu, ``w_out(gelu(w_in x))``
    for gelu. GELU is the tanh approximation, ``jax.nn.gelu``'s default."""

    def __init__(self, d_model: int, d_ff: int, mlp_type: str, dtype=None, device=None):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device)
        self.mlp_type = mlp_type
        if mlp_type in ("swiglu", "geglu"):
            self.w_gate = nn.Linear(d_model, d_ff, **kw)
            self.w_up = nn.Linear(d_model, d_ff, **kw)
        elif mlp_type == "gelu":
            self.w_in = nn.Linear(d_model, d_ff, **kw)
        else:
            raise ValueError(f"unknown mlp_type {mlp_type!r}")
        self.w_out = nn.Linear(d_ff, d_model, **kw)

    def forward(self, x):
        if self.mlp_type == "swiglu":
            h = F.silu(self.w_gate(x)) * self.w_up(x)
        elif self.mlp_type == "geglu":
            h = F.gelu(self.w_gate(x), approximate="tanh") * self.w_up(x)
        else:
            h = F.gelu(self.w_in(x), approximate="tanh")
        return self.w_out(h)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """GQA self-attention with rotary embeddings; q/k/v biases when
    ``cfg.qkv_bias`` (Qwen2-style)."""

    def __init__(self, cfg, dtype=None, device=None):
        super().__init__()
        D, HD = cfg.d_model, cfg.resolved_head_dim
        kw = dict(dtype=dtype, device=device)
        self.n_heads, self.n_kv_heads, self.head_dim = cfg.n_heads, cfg.n_kv_heads, HD
        self.rope_theta, self.causal = cfg.rope_theta, cfg.causal
        self.wq = nn.Linear(D, cfg.n_heads * HD, bias=cfg.qkv_bias, **kw)
        self.wk = nn.Linear(D, cfg.n_kv_heads * HD, bias=cfg.qkv_bias, **kw)
        self.wv = nn.Linear(D, cfg.n_kv_heads * HD, bias=cfg.qkv_bias, **kw)
        self.wo = nn.Linear(cfg.n_heads * HD, D, bias=False, **kw)

    def _qkv(self, x, positions):
        B, S, _ = x.shape
        HD = self.head_dim
        q = self.wq(x).reshape(B, S, self.n_heads, HD)
        k = self.wk(x).reshape(B, S, self.n_kv_heads, HD)
        v = self.wv(x).reshape(B, S, self.n_kv_heads, HD)
        cos, sin = rope(positions, HD, self.rope_theta)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def forward(self, x, positions, ops=None):
        """Self-attention over a full sequence (forward / prefill): x (B, S, D),
        positions (S,). Returns ``(out (B, S, D), (k, v))``, k/v (B, S, Hkv, HD)."""
        B, S, _ = x.shape
        q, k, v = self._qkv(x, positions)
        out = _ops(ops).flash_attention(q, k, v, causal=self.causal)
        return self.wo(out.reshape(B, S, self.n_heads * self.head_dim)), (k, v)

    def decode(self, x, k_cache, v_cache, pos, ops=None):
        """Single-token attention against a KV cache: x (B, 1, D); caches
        (B, Smax, Hkv, HD); pos (B,) write positions. Writes this token's k/v
        into the caches in place at ``pos`` (the reference returns updated
        copies) and returns out (B, 1, D)."""
        B = x.shape[0]
        q, k, v = self._qkv(x, pos[:, None])
        bidx, at = torch.arange(B, device=x.device), pos.long()
        k_cache[bidx, at] = k[:, 0].to(k_cache.dtype)
        v_cache[bidx, at] = v[:, 0].to(v_cache.dtype)
        out = _ops(ops).decode_attention(q[:, 0], k_cache, v_cache, pos)
        return self.wo(out.reshape(B, 1, -1))
