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

Tensor-parallel training (``tp``, the model mesh's ``"model"`` axis of m
ranks; ``training.train_loop``) runs the Megatron layout: a rank holds
``n_heads/m`` query heads of ``wq`` (the rows of the stored weight, and of
its bias) and the matching input columns of ``wo``, ``n_kv_heads/m`` kv
heads of ``wk``/``wv``, and ``d_ff/m`` of the MLP's inner dim (rows of
``w_gate``/``w_up``/``w_in``, input columns of ``w_out``); the norms stay
whole. Each cut block starts with ``distributed.copy_to`` and ends with
``distributed.reduce_from`` over ``tp``: the gelu MLP (an encoder's) as
the gated ones, ``gelu(w_in x)`` on the rank's inner units and ``w_out``'s
matching columns, the ranks' outputs summed. Where the kv heads do not divide
over the ranks (:func:`tp_cut`), ``wk``/``wv`` stay whole on every rank,
their gradients summed over the ranks, and each rank uses the kv heads its
query heads read; where ``d_ff`` does not, the MLP runs whole on every
rank. The blocks are cut by ``training.train_loop.shard_train_state``.
"""
from __future__ import annotations

from functools import reduce

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.context import SOLO, copy_to, reduce_from

__all__ = ["DTYPES", "einsum", "rms_norm", "rope", "apply_rope", "tp_cut", "RMSNorm", "MLP",
           "Attention"]

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


def tp_cut(n: int, tp) -> bool:
    """Whether a dim of ``n`` heads, kv heads, inner units or vocabulary
    entries is cut over the model axis ``tp``: over more than one rank, when
    they divide."""
    return tp.size > 1 and n % tp.size == 0


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
        self.mlp_type, self.d_ff = mlp_type, d_ff
        if mlp_type in ("swiglu", "geglu"):
            self.w_gate = nn.Linear(d_model, d_ff, **kw)
            self.w_up = nn.Linear(d_model, d_ff, **kw)
        elif mlp_type == "gelu":
            self.w_in = nn.Linear(d_model, d_ff, **kw)
        else:
            raise ValueError(f"unknown mlp_type {mlp_type!r}")
        self.w_out = nn.Linear(d_ff, d_model, **kw)

    def forward(self, x, tp=SOLO, tag: str = "tp"):
        """``tp``: the model axis; when it cuts ``d_ff`` (:func:`tp_cut`) this
        rank holds its block of the inner units and the output is summed over
        the ranks, the collectives counted under ``tag``."""
        cut = tp_cut(self.d_ff, tp)
        if cut:
            x = copy_to(x, tp, tag)
        if self.mlp_type == "swiglu":
            h = F.silu(self.w_gate(x)) * self.w_up(x)
        elif self.mlp_type == "geglu":
            h = F.gelu(self.w_gate(x), approximate="tanh") * self.w_up(x)
        else:
            h = F.gelu(self.w_in(x), approximate="tanh")
        return reduce_from(self.w_out(h), tp, tag) if cut else self.w_out(h)


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

    def _qkv(self, x, positions, tp=SOLO):
        B, S, _ = x.shape
        HD = self.head_dim
        q = self.wq(x).reshape(B, S, -1, HD)
        if tp.size > 1 and not tp_cut(self.n_kv_heads, tp):
            # wk/wv whole on every rank: their gradients are each rank's part
            k, v = (F.linear(x, copy_to(w.weight, tp),
                             None if w.bias is None else copy_to(w.bias, tp))
                    for w in (self.wk, self.wv))
        else:
            k, v = self.wk(x), self.wv(x)
        k, v = k.reshape(B, S, -1, HD), v.reshape(B, S, -1, HD)
        cos, sin = rope(positions, HD, self.rope_theta)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def _kv_heads(self, k, v, tp):
        """The kv heads that this rank's query heads read, from every kv
        head (``n_kv_heads`` not cut over ``tp``): one group of them when the
        rank's query heads fall into whole groups or into one, else a kv head
        for each query head."""
        H, G = self.n_heads // tp.size, self.n_heads // self.n_kv_heads
        idx = [(tp.index * H + i) // G for i in range(H)]
        n = idx[-1] - idx[0] + 1
        if H % n == 0 and idx == [idx[0] + i // (H // n) for i in range(H)]:
            return k.narrow(2, idx[0], n), v.narrow(2, idx[0], n)
        at = torch.tensor(idx, device=k.device)
        return k.index_select(2, at), v.index_select(2, at)

    def forward(self, x, positions, ops=None, tp=SOLO):
        """Self-attention over a full sequence (forward / prefill): x (B, S, D),
        positions (S,). Returns ``(out (B, S, D), (k, v))``, k/v (B, S, Hkv, HD).
        ``tp``: the model axis, over which this rank holds its block of the
        heads (``tp.size`` > 1: the output summed over the ranks, k/v the
        rank's)."""
        B, S, _ = x.shape
        if tp.size > 1:
            x = copy_to(x, tp)
        q, k, v = self._qkv(x, positions, tp)
        if tp.size > 1 and not tp_cut(self.n_kv_heads, tp):
            k, v = self._kv_heads(k, v, tp)
        out = _ops(ops).flash_attention(q, k, v, causal=self.causal)
        out = self.wo(out.reshape(B, S, q.shape[2] * self.head_dim))
        return (reduce_from(out, tp) if tp.size > 1 else out), (k, v)

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
