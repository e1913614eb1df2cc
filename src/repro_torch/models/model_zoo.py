"""The model zoo in PyTorch — the port's counterpart of
``repro.models.model_zoo``: the dense family, the VLM configs (their
``vision_stub`` patch embeddings before the tokens), the encoder-only
configs (``audio_stub`` frame embeddings in place of a token embedding),
the mixture-of-experts family (``models.moe``), the SSM family (Mamba2) and
the hybrid family (Mamba2 blocks with shared attention blocks,
Zamba2-style).

  init(cfg, generator, device)                  -> DenseDecoder or SSMDecoder (random weights)
  forward(model, cfg, batch, router_state)      -> (logits (B, S, V), aux)
  prefill(model, cfg, batch, max_len)           -> (logits (B, 1, V), cache)
  decode_step(model, cfg, token, pos, cache)    -> (logits (B, 1, V), cache)
  cache_spec(cfg, batch, max_len) / init_cache(cfg, batch, max_len, device)
  template(cfg) / axes(cfg)                     -> each parameter's logical axes

A batch holds ``tokens`` (B, S) for a decoder; ``patches`` (B, Np, D) and
``tokens`` (B, S - Np) for a ``vision_stub`` config; ``embeddings``
(B, S, D) for an encoder, which has no token embedding and no decode step.

The reference scans over stacked layer parameters; here the layers are an
``nn.ModuleList`` run in a Python loop. Attention runs the hand-written
flash and decode attention kernels on CUDA tensors and their plain versions
on CPU tensors (``models.common``), and the Mamba2 blocks the SSD
intra-chunk kernel likewise (``models.mamba``), in ``forward`` and in
``prefill``; every function takes ``ops=`` to choose another route
(``kernels.ops.plain`` to compare routes on the card). The entry points run
on the card unless the caller asks for the CPU.

``forward`` builds an autograd graph when grad is enabled and the weights
require it (``init(..., requires_grad=True)``, as ``training`` draws
them); on the card the flash attention kernel's backward is a kernel too
(``kernels.ops.flash_attention``). ``remat`` re-runs each block in the
backward pass instead of keeping its activations: ``"full"`` keeps nothing
(``torch.utils.checkpoint``), ``"dots"`` keeps the matrix products and
``"dots_no_batch"`` those without a batch axis (selective activation
checkpointing), the reference's ``REMAT_POLICIES``. ``prefill`` and
``decode_step`` run without grad.

In an MoE config, layer ``i`` holds an MoE FFN in place of its MLP when
``i % moe_interleave == moe_interleave - 1`` (the reference's ``sub{i}``
scan units, flattened in layer order). One (E,) POTUS router state is
threaded through the layers in order, each MoE layer's updated state
feeding the next layer's prices, as the reference's scan carry does;
``forward`` starts it from zeros unless given one and returns the last
state with the sum of the layers' ``aux_loss``; ``prefill`` and
``decode_step`` start each call from zeros and discard it.

``decode_step`` updates the cache in place and returns it (the reference
returns a new one). The reference's ``_constrain_cache`` is a GSPMD sharding
hint. ``moe_ep_shardmap`` picks the expert-parallel dispatch
(``models.moe_ep.moe_ffn_ep``) when a model mesh is set
(``distributed.context.set_mesh``, the model's experts placed on it by
``moe_ep.place_``), as the reference's ``_moe_dispatch`` does; without a
mesh every rank runs ``moe_ffn`` and computes the same result. Under a
mesh the ranks run every entry point together (SPMD), on the same inputs.

``forward(..., axis=)`` is the data-parallel train step's: the batch is
this rank's rows of a global batch cut over ``axis`` (the mesh's
``"data"`` axis), and each MoE layer computes its routing over the global
batch (``moe.moe_ffn``'s ``axis``), or, with ``moe_ep_shardmap`` and a
mesh, takes and returns this rank's rows (``moe_ep.moe_ffn_ep``'s
``rows``). The axis travels as an argument down to the blocks, so that
``remat``'s re-run of a block in the backward pass, outside any context
the caller set, issues the same collectives.

``forward(..., tp=)`` is the tensor-parallel train step's: the model mesh's
``"model"`` axis, over which each rank holds its blocks of the decoder's
weights (``models.common``; ``training.train_loop.shard_train_state`` cuts
them): in an MoE layer E/m of the experts (``moe.moe_ffn``'s ``tp``), or
under the expert-parallel route its F/m block of each of its experts
(``moe_ep.moe_ffn_ep``, which reads the mesh's "model" axis). The embedding
``(vocab, embed)`` is vocab-parallel: each rank looks up the ids in its
range of the vocabulary, writes zeros elsewhere, and the ranks' lookups
are summed (``distributed.reduce_from``); the LM head is cut by its
vocabulary rows, so the logits are this rank's vocabulary block (with
``tie_embeddings`` the one cut leaf serves both). A vocabulary that does
not divide over the ranks (granite-moe-1b's 49155 over 2 or 4) stays whole
on every rank: the lookup and the head then take no ``copy_to`` or
``reduce_from`` (their gradients are the same on every model rank) and the
logits are whole. A ``vision_stub`` config's patches join after the
lookup's sum, whole on every rank, and an encoder's frame embeddings enter
the first block whole (the blocks' ``copy_to`` gives these inputs no
gradient); an encoder's head is cut as a decoder's. It travels down to the
blocks as ``axis`` does.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..distributed.context import SOLO, copy_to, get_mesh, reduce_from
from .common import DTYPES, MLP, Attention, RMSNorm, tp_cut
from .mamba import (Mamba2Block, mamba_block, mamba_cache_spec, mamba_decode_step,
                    ssd_chunked_with_state)
from .moe import MoE, init_router_state, moe_ffn
from .moe_ep import moe_ffn_ep

__all__ = ["DenseDecoder", "SSMDecoder", "Leaf", "is_moe_layer", "init", "fill_", "template",
           "axes", "forward", "prefill", "decode_step", "cache_spec", "init_cache",
           "check_supported", "ssd_chunked_with_state", "REMAT_POLICIES"]

FRONTENDS = (None, "vision_stub", "audio_stub")

_aten = torch.ops.aten
#: the ops whose outputs each remat policy keeps for the backward pass: "none" re-runs
#: nothing, "full" keeps no op's output
REMAT_POLICIES = {
    "none": None,
    "full": (),
    "dots": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default),
    "dots_no_batch": (_aten.mm.default, _aten.addmm.default),
}


def check_supported(cfg) -> None:
    """Raise ``ValueError`` for a frontend other than the reference's two
    stubs (which would otherwise run silently as a text decoder)."""
    if cfg.frontend not in FRONTENDS:
        raise ValueError(f"{cfg.name}: frontend {cfg.frontend!r} is not one of {FRONTENDS}")


class Block(nn.Module):
    """Pre-norm transformer block: ``x + attn(ln1 x)``, then ``x + ffn(ln2 x)``
    with ``ffn`` the MLP, or with ``use_moe`` the MoE FFN (``moe``)."""

    def __init__(self, cfg, use_moe: bool = False, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, **kw)
        self.attn = Attention(cfg, **kw)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, **kw)
        self.mlp = None if use_moe else MLP(cfg.d_model, cfg.d_ff, cfg.mlp_type, **kw)
        self.moe = MoE(cfg, **kw) if use_moe else None

    def ffn(self, x, cfg=None, router_state=None, axis=SOLO, tp=SOLO):
        """``x + ffn(ln2 x)``. Returns (x, router state, aux): an MoE block
        (which reads its router settings from ``cfg``) passes its updated
        state on (the given one without a state) and its layer's ``aux``
        (``moe.moe_ffn``'s); an MLP block the state as given and None.
        ``axis``: the axis ``x``'s rows are cut over, ``tp`` the model axis
        that cuts the MLP or the experts (:func:`forward`; the
        expert-parallel route reads the mesh's own "model" axis)."""
        h_in = self.ln2(x)
        if self.moe is None:
            return x + self.mlp(h_in, tp), router_state, None
        mesh = get_mesh() if cfg.moe_ep_shardmap else None
        if mesh is not None:
            h, aux = moe_ffn_ep(self.moe, h_in, cfg, mesh, router_state, axis)
        else:
            h, aux = moe_ffn(self.moe, h_in, cfg, router_state, axis, tp)
        rs = aux["router_state"] if aux["router_state"] is not None else router_state
        return x + h, rs, aux

    def forward(self, x, positions, ops=None, cfg=None, router_state=None, axis=SOLO,
                tp=SOLO):
        """Self-attention over a full sequence, then :meth:`ffn`. Returns
        (x, (k, v), router state, the MoE layer's aux or None)."""
        h, kv = self.attn(self.ln1(x), positions, ops, tp)
        x, router_state, aux = self.ffn(x + h, cfg, router_state, axis, tp)
        return x, kv, router_state, aux

    def decode(self, x, k_cache, v_cache, pos, ops=None, cfg=None, router_state=None):
        """One token against the KV cache, then :meth:`ffn`. Returns
        (x, router state)."""
        x = x + self.attn.decode(self.ln1(x), k_cache, v_cache, pos, ops)
        return self.ffn(x, cfg, router_state)[:2]


class DenseDecoder(nn.Module):
    """Token embedding (none for an encoder), ``cfg.n_layers`` blocks (MoE
    blocks where :func:`is_moe_layer`), final norm and the LM head (the
    embedding itself when ``cfg.tie_embeddings``, never for an encoder).
    Parameters are in ``cfg.param_dtype``; the state_dict names mirror the
    reference's tree (``embed``, ``blocks.{i}.attn.wq.weight``,
    ``blocks.{i}.moe.w_gate``, ``final_norm.weight``, ...)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        check_supported(cfg)
        kw = dict(dtype=DTYPES[cfg.param_dtype], device=device)
        self.embed = (None if cfg.is_encoder
                      else nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model, **kw)))
        self.blocks = nn.ModuleList(Block(cfg, is_moe_layer(cfg, i), **kw)
                                    for i in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, **kw)
        self.lm_head = (None if cfg.tie_embeddings and not cfg.is_encoder
                        else nn.Linear(cfg.d_model, cfg.vocab_size, bias=False, **kw))


def is_moe_layer(cfg, i: int) -> bool:
    """Whether layer ``i`` holds an MoE FFN: the last block of each scan unit
    of ``moe_interleave`` blocks in the reference."""
    return bool(cfg.moe) and i % cfg.moe_interleave == cfg.moe_interleave - 1


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
    its leaf: the embedding and the MoE router N(0, 1) * 0.02, the Mamba2
    conv weight N(0, 1) * 0.5, biases (``conv_b`` and ``dt_bias`` among them)
    zero, the other vectors (norm weights, ``A_log``, ``D``) one, every other
    matrix N(0, 1) / sqrt(fan_in), drawn in float32 and cast. The fan-in of
    an ``nn.Linear`` weight (out, in) is ``shape[1]``, of an expert tensor
    (E, in, out) kept in the reference's layout ``shape[-2]``."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf.endswith("bias") or leaf == "conv_b":
        p.zero_()
    elif p.dim() == 1:
        p.fill_(1.0)
    else:
        fan_in = p.shape[-2] if p.dim() == 3 else p.shape[1]
        scale = (0.02 if name == "embed" or leaf == "router" else 0.5 if leaf == "conv_w"
                 else 1.0 / math.sqrt(fan_in))
        draw = torch.randn(p.shape, generator=generator, dtype=torch.float32, device=p.device)
        p.copy_(draw.mul_(scale))


@torch.no_grad()
def fill_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``module`` in place, in ``named_parameters``
    order, as :func:`init` draws a decoder's (an :class:`MoE` alone, say).
    Returns the module."""
    for name, p in module.named_parameters():
        _fill_(name, p, generator)
    return module


@torch.no_grad()
def init(cfg, generator: torch.Generator, device="cuda", *, requires_grad: bool = False
         ) -> nn.Module:
    """A :class:`DenseDecoder` (an :class:`SSMDecoder` for ``cfg.ssm``) with
    random weights drawn from ``generator`` (a ``torch.Generator`` on
    ``device``), on the card unless ``device="cpu"``. The numbers differ from
    the reference's ``jax.random`` draws; to hold the two against each other,
    load the reference's weights with ``convert.model_params_from_numpy``.
    Gradients are off unless ``requires_grad`` (training)."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = (SSMDecoder if cfg.ssm else DenseDecoder)(cfg)
    return fill_(model.to_empty(device=device), generator).requires_grad_(requires_grad)


# ---------------------------------------------------------------------------
# Templates: the logical axes of every parameter (the sharding rules read them)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter's template: ``shape`` and logical ``axes`` in the
    reference leaf's dim order, its stacked ``"layers"`` axis dropped, and
    ``perm``, the reference dim that each of the port tensor's dims is
    (``(1, 0)`` for an ``nn.Linear`` weight, the reference's (in, out)
    matrix transposed)."""

    shape: tuple
    axes: tuple
    perm: tuple

    @property
    def port_axes(self) -> tuple:
        return tuple(self.axes[d] for d in self.perm)


_MLP_AXES = {"w_gate.weight": ("embed", "ff"), "w_up.weight": ("embed", "ff"),
             "w_in.weight": ("embed", "ff"), "w_out.weight": ("ff", "embed")}
#: the reference leaf's logical axes of each parameter, by its name within a block (or at
#: the top of the model); the ``nn.Linear`` weights among them are stored transposed
_AXES = {
    "embed": ("vocab", "embed"), "lm_head.weight": ("embed", "vocab"),
    "final_norm.weight": ("embed",), "ln1.weight": ("embed",), "ln2.weight": ("embed",),
    "attn.wq.weight": ("embed", "heads"), "attn.wk.weight": ("embed", "kv"),
    "attn.wv.weight": ("embed", "kv"), "attn.wo.weight": ("heads", "embed"),
    "attn.wq.bias": ("heads",), "attn.wk.bias": ("kv",), "attn.wv.bias": ("kv",),
    **{f"mlp.{k}": v for k, v in _MLP_AXES.items()},
    **{f"moe.shared.{k}": v for k, v in _MLP_AXES.items()},
    # the router and the experts keep the reference's layout
    "moe.router": ("embed", "experts"), "moe.w_gate": ("experts", "embed", "ff"),
    "moe.w_up": ("experts", "embed", "ff"), "moe.w_down": ("experts", "ff", "embed"),
    # Mamba2 (the conv weight (K, channels) is not a linear map: kept as it is)
    "norm.weight": ("embed",), "in_proj.weight": ("embed", "ff"), "conv_w": (None, "ff"),
    "conv_b": ("ff",), "A_log": ("heads",), "D": ("heads",), "dt_bias": ("heads",),
    "gate_norm.weight": ("ff",), "out_proj.weight": ("ff", "embed"),
}
_LINEAR_WEIGHTS = {"lm_head.weight", "in_proj.weight", "out_proj.weight",
                   *(f"attn.w{x}.weight" for x in "qkvo"),
                   *(f"mlp.{k}" for k in _MLP_AXES), *(f"moe.shared.{k}" for k in _MLP_AXES)}


def _leaf(name: str, p: torch.Tensor) -> Leaf:
    parts = name.split(".")
    key = ".".join(parts[2:]) if parts[0] in ("blocks", "shared_attn") else name
    if key not in _AXES:
        raise KeyError(f"no logical axes for parameter {name!r}")
    if key in _LINEAR_WEIGHTS:
        return Leaf(tuple(reversed(p.shape)), _AXES[key], (1, 0))
    return Leaf(tuple(p.shape), _AXES[key], tuple(range(p.dim())))


def template(cfg) -> dict:
    """``{parameter name: Leaf}`` of the model :func:`init` builds for
    ``cfg``, the counterpart of the reference's ``template`` (built on the
    meta device: no memory, at any size)."""
    with torch.device("meta"):
        model = (SSMDecoder if cfg.ssm else DenseDecoder)(cfg)
    return {name: _leaf(name, p) for name, p in model.named_parameters()}


def axes(cfg) -> dict:
    """``{parameter name: logical axes}`` in the port's layout: the
    reference's per-dim axes without the stacked ``"layers"`` axis, an
    ``nn.Linear`` weight's two reversed."""
    return {name: leaf.port_axes for name, leaf in template(cfg).items()}


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

def _embed_input(model, cfg, batch, tp=SOLO):
    """The input sequence in the compute type: an encoder's ``embeddings``,
    else the embedded ``tokens``, after the ``patches`` for a
    ``vision_stub`` config that has them. Over a model axis ``tp`` that
    cuts the vocabulary, each rank looks up the ids of its block (zeros for
    the others) and the lookups are summed; the patches and an encoder's
    embeddings are whole on every rank and are not summed."""
    cdt = DTYPES[cfg.compute_dtype]
    if cfg.is_encoder:
        return batch["embeddings"].to(cdt)
    if tp_cut(cfg.vocab_size, tp):
        n = model.embed.shape[0]
        ids = batch["tokens"] - tp.index * n
        mine = (ids >= 0) & (ids < n)
        rows = model.embed[ids.clamp(0, n - 1)]
        x = reduce_from(torch.where(mine[..., None], rows, torch.zeros_like(rows)), tp).to(cdt)
    else:
        x = model.embed[batch["tokens"]].to(cdt)
    if cfg.frontend == "vision_stub" and "patches" in batch:
        x = torch.cat([batch["patches"].to(cdt), x], dim=1)
    return x


def _unembed(model, cfg, x, tp=SOLO):
    """The logits in the compute type: this rank's vocabulary block of them
    over a model axis ``tp`` that cuts the vocabulary."""
    w = model.embed if model.lm_head is None else model.lm_head.weight
    if tp_cut(cfg.vocab_size, tp):
        x = copy_to(x, tp)
    return F.linear(x, w).to(DTYPES[cfg.compute_dtype])


def _remat(fn, remat: str):
    """``fn`` run under the ``remat`` policy of :data:`REMAT_POLICIES`."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat must be one of {sorted(REMAT_POLICIES)}, got {remat!r}")
    keep = REMAT_POLICIES[remat]
    if keep is None:
        return fn
    if not keep:
        return partial(checkpoint, fn, use_reentrant=False)

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in keep else CheckpointPolicy.PREFER_RECOMPUTE

    return partial(checkpoint, fn, use_reentrant=False,
                   context_fn=partial(create_selective_checkpoint_contexts, policy))


def _start_state(cfg, router_state, device):
    """The router state a stack starts from: the given one, else zeros (E,)
    for an MoE config and (1,) otherwise, as the reference's."""
    if router_state is not None:
        return router_state
    if cfg.moe:
        return init_router_state(cfg, device)
    return torch.zeros((1,), dtype=torch.float32, device=device)


def forward(model, cfg, batch, router_state=None, *, ops=None, remat: str = "none",
            axis=SOLO, tp=SOLO):
    """Full-sequence forward. Returns (logits (B, S, V), aux dict):
    ``moe_aux_loss``, the sum of the MoE layers' load-balance losses (0
    without them), ``moe_aux_term``, the sum of this rank's terms of them
    (``moe_aux_loss`` itself on :data:`SOLO`), ``moe_layers``, each MoE
    layer's aux (``moe.moe_ffn``'s) in order, and ``router_state``, the
    state after the last layer. Differentiable when grad is enabled;
    ``remat`` names a policy of :data:`REMAT_POLICIES` applied to each
    block (not to a hybrid's shared attention blocks, as in the reference).
    ``axis``: the axis ``batch``'s rows are cut over (the train step's
    ``"data"`` axis; :data:`SOLO`, the whole batch); ``tp``: the model axis
    the dense decoder's weights are cut over (the logits are then this
    rank's vocabulary block where the vocabulary divides)."""
    x = _embed_input(model, cfg, batch, tp)
    positions = torch.arange(x.shape[1], device=x.device)
    rs = _start_state(cfg, router_state, x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    term_total, layers = aux_total, []
    if cfg.ssm:
        for gi, (s, e, attn_after) in enumerate(_hybrid_groups(cfg)):
            for block in model.blocks[s:e]:
                x = _remat(partial(mamba_block, cfg=cfg, ops=ops), remat)(block, x) + x
            if attn_after:
                x, *_ = model.shared_attn[gi % cfg.n_shared_attn](x, positions, ops)
    else:
        for block in model.blocks:
            x, _, rs, aux = _remat(block, remat)(x, positions, ops, cfg, rs, axis, tp)
            if aux is not None:
                layers.append(aux)
                aux_total = aux_total + aux["aux_loss"]
                term_total = term_total + aux["aux_term"]
    logits = _unembed(model, cfg, model.final_norm(x), tp)
    return logits, dict(moe_aux_loss=aux_total, moe_aux_term=term_total, moe_layers=layers,
                        router_state=rs)


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
    last position (B, 1, V), cache). An MoE stack's router state starts from
    zeros and is discarded, as the reference's."""
    x = _embed_input(model, cfg, batch)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    cache = init_cache(cfg, x.shape[0], max_len, x.device)
    if cfg.ssm:
        x = _ssm_prefill(model, cfg, x, cache, positions, ops)
    else:
        rs = _start_state(cfg, None, x.device)
        for i, block in enumerate(model.blocks):
            x, (k, v), rs, _ = block(x, positions, ops, cfg, rs)
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
    # the norm is per position, so normalising the last one alone is the same
    return _unembed(model, cfg, model.final_norm(x[:, -1:])), cache


@torch.no_grad()
def decode_step(model, cfg, token, pos, cache, *, ops=None):
    """One serving step: token (B, 1) ids, pos (B,) write positions. Returns
    (logits (B, 1, V), cache), the cache updated in place. An MoE stack's
    router state starts from zeros and is discarded, as the reference's; the
    B tokens share each expert's capacity. An encoder has no decode step
    (``ValueError``)."""
    if cfg.is_encoder:
        raise ValueError("encoder-only architectures have no decode step")
    x = _embed_input(model, cfg, {"tokens": token})
    if cfg.ssm:
        x = _ssm_decode(model, cfg, x, pos, cache, ops)
    else:
        rs = _start_state(cfg, None, x.device)
        for i, block in enumerate(model.blocks):
            x, rs = block.decode(x, cache["k"][i], cache["v"][i], pos, ops, cfg, rs)
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
            x, (k, v), *_ = model.shared_attn[gi % cfg.n_shared_attn](x, positions, ops)
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
            x, _ = block.decode(x, cache["k"][attn_idx], cache["v"][attn_idx], pos, ops)
            attn_idx += 1
    return x
