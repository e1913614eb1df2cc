"""The decoders of the model zoo in PyTorch — the port's counterpart of
``repro.models.model_zoo`` for the dense family (and the VLM configs with
``frontend=None``), the SSM family (Mamba2) and the hybrid family (Mamba2
blocks with shared attention blocks, Zamba2-style).

  init(cfg, generator, device)                  -> DenseDecoder or SSMDecoder (random weights)
  forward(model, cfg, batch)                    -> (logits (B, S, V), aux)
  prefill(model, cfg, batch, max_len)           -> (logits (B, 1, V), cache)
  decode_step(model, cfg, token, pos, cache)    -> (logits (B, 1, V), cache)
  cache_spec(cfg, batch, max_len) / init_cache(cfg, batch, max_len, device)

The reference scans over stacked layer parameters; here the layers are an
``nn.ModuleList`` run in a Python loop. Attention runs the hand-written
flash and decode attention kernels on CUDA tensors and their plain versions
on CPU tensors (``models.common``), and the Mamba2 blocks the SSD
intra-chunk kernel likewise (``models.mamba``), in ``forward`` and in
``prefill``; every function takes ``ops=`` to choose another route
(``kernels.ops.plain`` to compare routes on the card). The entry points run
on the card unless the caller asks for the CPU.

``decode_step`` updates the cache in place and returns it (the reference
returns a new one). The reference's ``_constrain_cache`` is a GSPMD sharding
hint; the port has no device mesh, so it is left out.

Mixture-of-experts and encoder configs and the modality frontends raise
``NotImplementedError`` naming the ROADMAP.md item that ports them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .common import DTYPES, MLP, Attention, RMSNorm
from .mamba import (Mamba2Block, mamba_block, mamba_cache_spec, mamba_decode_step,
                    ssd_chunked_with_state)

__all__ = ["DenseDecoder", "SSMDecoder", "init", "forward", "prefill", "decode_step",
           "cache_spec", "init_cache", "check_supported", "ssd_chunked_with_state"]

# (config field, what it needs, ROADMAP.md section 1 item that ports it)
_NOT_PORTED = (
    ("moe", "mixture-of-experts layers (models/moe.py, moe_ep.py)", 6),
    ("is_encoder", "encoder-only models", 7),
    ("frontend", "modality frontends (pass cfg.with_(frontend=None) for the text decoder)", 7),
)


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a config the port does not run yet."""
    for field, what, item in _NOT_PORTED:
        if getattr(cfg, field):
            raise NotImplementedError(
                f"{cfg.name}: {what} are not ported yet (ROADMAP.md, section 1, module item "
                f"{item}); the port runs dense, SSM and hybrid decoders")


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


class SSMDecoder(nn.Module):
    """Token embedding, ``cfg.n_layers`` Mamba2 blocks, for a hybrid config
    (``cfg.attn_every``) ``cfg.n_shared_attn`` shared attention/MLP blocks
    invoked after every ``attn_every``-th Mamba2 block (weight set
    ``invocation % n_shared_attn``), the final norm and the LM head (the
    embedding itself when ``cfg.tie_embeddings``). The state_dict names
    mirror the reference's tree (``blocks.{i}.in_proj.weight``,
    ``blocks.{i}.conv_w``, ``shared_attn.{j}.attn.wq.weight``, ...)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        check_supported(cfg)
        kw = dict(dtype=DTYPES[cfg.param_dtype], device=device)
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model, **kw))
        self.blocks = nn.ModuleList(Mamba2Block(cfg, **kw) for _ in range(cfg.n_layers))
        self.shared_attn = (nn.ModuleList(Block(cfg, **kw) for _ in range(cfg.n_shared_attn))
                            if cfg.attn_every else None)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, **kw)
        self.lm_head = (None if cfg.tie_embeddings
                        else nn.Linear(cfg.d_model, cfg.vocab_size, bias=False, **kw))


def _fill_(name: str, p: torch.Tensor, generator: torch.Generator) -> None:
    """One parameter, drawn as ``repro.models.common.Leaf.materialize`` draws
    its leaf: the embedding N(0, 1) * 0.02, the Mamba2 conv weight N(0, 1) *
    0.5, biases (``conv_b`` and ``dt_bias`` among them) zero, the other
    vectors (norm weights, ``A_log``, ``D``) one, every other matrix
    N(0, 1) / sqrt(fan_in), drawn in float32 and cast."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf.endswith("bias") or leaf == "conv_b":
        p.zero_()
    elif p.dim() == 1:
        p.fill_(1.0)
    else:
        scale = (0.02 if name == "embed" else 0.5 if leaf == "conv_w"
                 else 1.0 / math.sqrt(p.shape[1]))  # nn.Linear (out, in): fan_in
        draw = torch.randn(p.shape, generator=generator, dtype=torch.float32, device=p.device)
        p.copy_(draw.mul_(scale))


@torch.no_grad()
def init(cfg, generator: torch.Generator, device="cuda") -> nn.Module:
    """A :class:`DenseDecoder` (an :class:`SSMDecoder` for ``cfg.ssm``) with
    random weights drawn from ``generator`` (a ``torch.Generator`` on
    ``device``), on the card unless ``device="cpu"``. The numbers differ from
    the reference's ``jax.random`` draws; to hold the two against each other,
    load the reference's weights with ``convert.model_params_from_numpy``.
    Gradients are off."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = (SSMDecoder if cfg.ssm else DenseDecoder)(cfg)
    model = model.to_empty(device=device).requires_grad_(False)
    for name, p in model.named_parameters():
        _fill_(name, p, generator)
    return model


def _hybrid_groups(cfg) -> list[tuple[int, int, bool]]:
    """[(start, stop, attn_after)] segments of the Mamba2 stack; one segment
    without attention when the config is not hybrid."""
    if not cfg.attn_every:
        return [(0, cfg.n_layers, False)]
    groups = []
    s = 0
    while s < cfg.n_layers:
        e = min(s + cfg.attn_every, cfg.n_layers)
        groups.append((s, e, e - s == cfg.attn_every))
        s = e
    return groups


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
    if cfg.ssm:
        for gi, (s, e, attn_after) in enumerate(_hybrid_groups(cfg)):
            for block in model.blocks[s:e]:
                x = mamba_block(block, x, cfg, ops=ops) + x
            if attn_after:
                x, _ = model.shared_attn[gi % cfg.n_shared_attn](x, positions, ops)
    else:
        for block in model.blocks:
            x, _ = block(x, positions, ops)
    logits = _unembed(model, cfg, model.final_norm(x))
    zero = torch.zeros((1,), dtype=torch.float32, device=x.device)
    return logits, dict(moe_aux_loss=zero[0], router_state=zero)


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def cache_spec(cfg, batch: int, max_len: int) -> dict:
    """``{name: (shape, dtype)}`` of the decode cache. Dense: k and v, each
    (n_layers, batch, max_len, n_kv_heads, head_dim) in the compute type.
    SSM: conv (n_layers, batch, ssm_conv - 1, channels) and ssm (n_layers,
    batch, H, P, S), float32; a hybrid adds k and v with one entry per shared
    attention invocation, not per layer."""
    check_supported(cfg)
    cdt = DTYPES[cfg.compute_dtype]
    spec = {}
    if cfg.ssm:
        (conv, conv_dt), (ssm, ssm_dt) = mamba_cache_spec(cfg, batch)
        spec["conv"] = ((cfg.n_layers,) + conv, conv_dt)
        spec["ssm"] = ((cfg.n_layers,) + ssm, ssm_dt)
        if not cfg.attn_every:
            return spec
        n_kv = sum(1 for *_r, a in _hybrid_groups(cfg) if a)
    else:
        n_kv = cfg.n_layers
    kv = (n_kv, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return dict(spec, k=(kv, cdt), v=(kv, cdt))


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
    if cfg.ssm:
        x = _ssm_prefill(model, cfg, x, cache, positions, ops)
    else:
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
    if cfg.ssm:
        x = _ssm_decode(model, cfg, x, pos, cache, ops)
    else:
        for i, block in enumerate(model.blocks):
            x = block.decode(x, cache["k"][i], cache["v"][i], pos, ops)
    return _unembed(model, cfg, model.final_norm(x)), cache


def _ssm_prefill(model, cfg, x, cache, positions, ops):
    """The Mamba2 stack (and the hybrid's shared attention blocks) over the
    prompt, writing each block's final conv window and SSM state, and each
    attention invocation's k/v, into ``cache``. Returns x."""
    S = x.shape[1]
    attn_idx = 0
    for gi, (s, e, attn_after) in enumerate(_hybrid_groups(cfg)):
        for li in range(s, e):
            y, conv_st, ssm_st = mamba_block(model.blocks[li], x, cfg, ops=ops, with_state=True)
            x = x + y
            cache["conv"][li] = conv_st
            cache["ssm"][li] = ssm_st
        if attn_after:
            x, (k, v) = model.shared_attn[gi % cfg.n_shared_attn](x, positions, ops)
            cache["k"][attn_idx, :, :S] = k
            cache["v"][attn_idx, :, :S] = v
            attn_idx += 1
    return x


def _ssm_decode(model, cfg, x, pos, cache, ops):
    """One token through the Mamba2 stack and the shared attention blocks,
    updating ``cache`` in place. Returns x."""
    attn_idx = 0
    for gi, (s, e, attn_after) in enumerate(_hybrid_groups(cfg)):
        for li in range(s, e):
            y, conv_st, ssm_st = mamba_decode_step(model.blocks[li], x, cfg, cache["conv"][li],
                                                   cache["ssm"][li])
            x = x + y
            cache["conv"][li] = conv_st
            cache["ssm"][li] = ssm_st
        if attn_after:
            block = model.shared_attn[gi % cfg.n_shared_attn]
            x = block.decode(x, cache["k"][attn_idx], cache["v"][attn_idx], pos, ops)
            attn_idx += 1
    return x
