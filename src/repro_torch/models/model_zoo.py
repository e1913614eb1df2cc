"""The dense decoder of the model zoo in PyTorch — the port's counterpart of
``repro.models.model_zoo`` for ``family`` dense (and the VLM configs with
``frontend=None``).

  init(cfg, generator, device)                  -> DenseDecoder (random weights)
  forward(model, cfg, batch)                    -> (logits (B, S, V), aux)
  prefill(model, cfg, batch, max_len)           -> (logits (B, 1, V), cache)
  decode_step(model, cfg, token, pos, cache)    -> (logits (B, 1, V), cache)
  cache_spec(cfg, batch, max_len) / init_cache(cfg, batch, max_len, device)

The reference scans over stacked layer parameters; here the layers are an
``nn.ModuleList`` run in a Python loop. Attention runs the hand-written
flash and decode attention kernels on CUDA tensors and their plain versions
on CPU tensors (``models.common``); every function takes ``ops=`` to choose
another route (``kernels.ops.plain`` to compare routes on the card). The
entry points run on the card unless the caller asks for the CPU.

``decode_step`` updates the cache in place and returns it (the reference
returns a new one). The reference's ``_constrain_cache`` is a GSPMD sharding
hint; the port has no device mesh, so it is left out.

Mixture-of-experts, SSM, hybrid and encoder configs and the modality
frontends raise ``NotImplementedError`` naming the ROADMAP.md item that
ports them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .common import DTYPES, MLP, Attention, RMSNorm

__all__ = ["DenseDecoder", "init", "forward", "prefill", "decode_step", "cache_spec",
           "init_cache", "check_supported"]

_NOT_PORTED = (
    ("moe", "mixture-of-experts layers (models/moe.py, moe_ep.py)"),
    ("ssm", "SSM blocks (models/mamba.py and ssd_intra_chunk_kernel, kernel 7)"),
    ("attn_every", "hybrid shared-attention stacks (models/mamba.py)"),
    ("is_encoder", "encoder-only models"),
    ("frontend", "modality frontends (pass cfg.with_(frontend=None) for the text decoder)"),
)


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a config the port does not run yet."""
    for field, what in _NOT_PORTED:
        if getattr(cfg, field):
            raise NotImplementedError(
                f"{cfg.name}: {what} are not ported yet (ROADMAP.md, section 1, module item "
                f"11); the port runs dense decoders")


class Block(nn.Module):
    """Pre-norm transformer block: ``x + attn(ln1 x)``, then ``x + mlp(ln2 x)``."""

    def __init__(self, cfg, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, **kw)
        self.attn = Attention(cfg, **kw)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, **kw)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_type, **kw)

    def forward(self, x, positions, ops=None):
        h, kv = self.attn(self.ln1(x), positions, ops)
        x = x + h
        return x + self.mlp(self.ln2(x)), kv

    def decode(self, x, k_cache, v_cache, pos, ops=None):
        x = x + self.attn.decode(self.ln1(x), k_cache, v_cache, pos, ops)
        return x + self.mlp(self.ln2(x))


class DenseDecoder(nn.Module):
    """Token embedding, ``cfg.n_layers`` blocks, final norm and the LM head
    (the embedding itself when ``cfg.tie_embeddings``). Parameters are in
    ``cfg.param_dtype``; the state_dict names mirror the reference's tree
    (``embed``, ``blocks.{i}.attn.wq.weight``, ``final_norm.weight``, ...)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        check_supported(cfg)
        kw = dict(dtype=DTYPES[cfg.param_dtype], device=device)
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model, **kw))
        self.blocks = nn.ModuleList(Block(cfg, **kw) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, **kw)
        self.lm_head = (None if cfg.tie_embeddings
                        else nn.Linear(cfg.d_model, cfg.vocab_size, bias=False, **kw))


def _fill_(name: str, p: torch.Tensor, generator: torch.Generator) -> None:
    """One parameter, drawn as ``repro.models.common.Leaf.materialize`` draws
    its leaf: the embedding N(0, 1) * 0.02, biases zero, norm weights one,
    every matrix N(0, 1) / sqrt(fan_in), drawn in float32 and cast."""
    if name.endswith("bias"):
        p.zero_()
    elif p.dim() == 1:
        p.fill_(1.0)
    else:
        scale = 0.02 if name == "embed" else 1.0 / math.sqrt(p.shape[1])  # (out, in): fan_in
        draw = torch.randn(p.shape, generator=generator, dtype=torch.float32, device=p.device)
        p.copy_(draw.mul_(scale))


@torch.no_grad()
def init(cfg, generator: torch.Generator, device="cuda") -> DenseDecoder:
    """A :class:`DenseDecoder` with random weights drawn from ``generator``
    (a ``torch.Generator`` on ``device``), on the card unless ``device="cpu"``.
    The numbers differ from the reference's ``jax.random`` draws; to hold the
    two against each other, load the reference's weights with
    ``convert.model_params_from_numpy``. Gradients are off."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = DenseDecoder(cfg)
    model = model.to_empty(device=device).requires_grad_(False)
    for name, p in model.named_parameters():
        _fill_(name, p, generator)
    return model


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _embed_input(model, cfg, batch):
    return model.embed[batch["tokens"]].to(DTYPES[cfg.compute_dtype])


def _unembed(model, cfg, x):
    w = model.embed if model.lm_head is None else model.lm_head.weight
    return F.linear(x, w).to(DTYPES[cfg.compute_dtype])


@torch.no_grad()
def forward(model, cfg, batch, *, ops=None):
    """Full-sequence forward. Returns (logits (B, S, V), aux dict)."""
    x = _embed_input(model, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    for block in model.blocks:
        x, _ = block(x, positions, ops)
    logits = _unembed(model, cfg, model.final_norm(x))
    zero = torch.zeros((1,), dtype=torch.float32, device=x.device)
    return logits, dict(moe_aux_loss=zero[0], router_state=zero)


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def cache_spec(cfg, batch: int, max_len: int) -> dict:
    """``{name: (shape, dtype)}`` of the decode cache: k and v, each
    (n_layers, batch, max_len, n_kv_heads, head_dim) in the compute type."""
    check_supported(cfg)
    kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": (kv, DTYPES[cfg.compute_dtype]), "v": (kv, DTYPES[cfg.compute_dtype])}


def init_cache(cfg, batch: int, max_len: int, device="cuda") -> dict:
    """A zeroed decode cache, on the card unless ``device="cpu"``."""
    device = resolve_device(device)
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in cache_spec(cfg, batch, max_len).items()}


@torch.no_grad()
def prefill(model, cfg, batch, max_len: int, *, ops=None):
    """Process a prompt and build the decode cache. Returns (logits of the
    last position (B, 1, V), cache)."""
    x = _embed_input(model, cfg, batch)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    cache = init_cache(cfg, x.shape[0], max_len, x.device)
    for i, block in enumerate(model.blocks):
        x, (k, v) = block(x, positions, ops)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    # the norm is per position, so normalising the last one alone is the same
    return _unembed(model, cfg, model.final_norm(x[:, -1:])), cache


@torch.no_grad()
def decode_step(model, cfg, token, pos, cache, *, ops=None):
    """One serving step: token (B, 1) ids, pos (B,) write positions. Returns
    (logits (B, 1, V), cache), the cache updated in place."""
    x = _embed_input(model, cfg, {"tokens": token})
    for i, block in enumerate(model.blocks):
        x = block.decode(x, cache["k"][i], cache["v"][i], pos, ops)
    return _unembed(model, cfg, model.final_norm(x)), cache
