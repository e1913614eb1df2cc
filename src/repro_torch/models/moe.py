"""Mixture-of-experts FFN with capacity-based dispatch (GShard/Switch-style)
and the POTUS router — the port's counterpart of ``repro.models.moe``.

Dispatch is scatter/gather based, in the reference's order of steps:

  1. float32 router logits, their softmax, and the top-k experts per token
     with the combine weights gathered from the softmax and renormalised;
  2. each (token, choice) entry's position in its expert by a cumulative
     count over the flattened (N*k) entries, token-major; entries at or past
     the capacity ``cap`` are dropped;
  3. the kept entries scattered into an (E*cap, D) buffer in ``x``'s type,
     the expert FFNs run as batched products over the expert axis;
  4. the results gathered back (a dropped entry gives 0), weighted and summed
     over the k choices; the optional shared expert is added.

Over-capacity entries are dropped (Switch semantics); the residual stream
carries them unchanged.

POTUS router (DESIGN.md §3): expert load balancing as tuple scheduling. Each
expert e keeps a virtual queue ``Q_e`` updated with the drift rule
``Q_e <- [Q_e + load_e - N*k/E]+`` (eq. (8)); selection uses the prices
``logits - beta * scale * Q / max(mean Q + 1, 1)`` (eq. (16) with U=0),
where ``scale = max(mean |logits|, 1e-6)``.

Two choices keep the port's selections the reference's:

* the top k come from a stable descending sort, so equal prices give the
  lower expert index first, as ``jax.lax.top_k`` does (``torch.topk`` does
  not promise an order on ties);
* the dropped entries are scattered into one extra row of the buffer, which
  is cut off, and the combine is a gather and a sum over k, never an
  ``index_add_``: no two kept entries share a row, so two runs on the card
  give the same bits.

The expert products are plain large products (the reference computes them
outside any Pallas kernel), so they run as ``torch.bmm``. ``moe_ffn`` makes
no host synchronisation: every aux value stays a tensor, and ``cap`` comes
from the shapes.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import MLP

__all__ = ["MoE", "moe_ffn", "init_router_state", "moe_capacity"]


class MoE(nn.Module):
    """The reference's ``moe_template`` leaves as parameters, in its layouts:
    ``router`` (D, E), ``w_gate`` and ``w_up`` (E, D, F), ``w_down``
    (E, F, D), and, when ``cfg.n_shared_experts``, a ``shared``
    :class:`MLP` of width ``F * n_shared_experts``."""

    def __init__(self, cfg, dtype=None, device=None):
        super().__init__()
        D, Ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        kw = dict(dtype=dtype, device=device)
        self.router = nn.Parameter(torch.empty(D, E, **kw))
        self.w_gate = nn.Parameter(torch.empty(E, D, Ff, **kw))
        self.w_up = nn.Parameter(torch.empty(E, D, Ff, **kw))
        self.w_down = nn.Parameter(torch.empty(E, Ff, D, **kw))
        self.shared = (MLP(D, Ff * cfg.n_shared_experts, cfg.mlp_type, **kw)
                       if cfg.n_shared_experts else None)


def init_router_state(cfg, device=None) -> torch.Tensor:
    """Virtual queue backlog per expert (POTUS router); zeros = balanced."""
    return torch.zeros((cfg.n_experts,), dtype=torch.float32, device=device)


def moe_capacity(cfg, n_tokens: int) -> int:
    return int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor))


def _mean(t, dim=None):
    """``t.mean(dim)`` as the reference's computes it under XLA: the sum
    times the float32 reciprocal of the count (XLA turns a division by a
    constant into that product), so that ``dropped_frac`` and the POTUS
    prices round as the reference's do."""
    n = t.numel() if dim is None else t.shape[dim]
    s = t.sum() if dim is None else t.sum(dim=dim)
    return s * float(np.float32(1.0) / np.float32(n))


def _bmm(a, b):
    """``einsum("ecd,edf->ecf")`` over operands promoted to one type, as
    ``jnp.einsum`` promotes them."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return torch.bmm(a.to(dtype), b.to(dtype))


def moe_ffn(moe, x, cfg, router_state=None):
    """x: (B, S, D). Returns ``(y (B, S, D), aux)``; ``aux`` holds the
    tensors ``aux_loss``, ``dropped_frac``, ``load`` (E,) (entries routed to
    each expert, before drops), ``keep`` (N*k,) and ``top_i`` (N, k), and
    ``router_state``, the updated virtual queues (None without a state)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    N = B * S
    xf = x.reshape(N, D)

    logits = xf.float() @ moe.router.float()  # (N, E)
    probs = torch.softmax(logits, dim=-1)
    sel_scores = logits
    if cfg.router == "potus" and router_state is not None:
        # price = affinity - beta * virtual backlog  (eq. 16, U=0)
        scale = _mean(logits.abs()).clamp_min(1e-6)
        backlog = router_state / (_mean(router_state) + 1.0).clamp_min(1.0)
        sel_scores = logits - cfg.potus_router_beta * scale * backlog[None, :]
    # the lower index first on equal prices, as jax.lax.top_k
    top_i = torch.sort(sel_scores, dim=-1, descending=True, stable=True).indices[:, :k]
    # combine weights always come from the raw affinities (unbiased output)
    gather_p = probs.gather(-1, top_i)
    top_w = gather_p / gather_p.sum(-1, keepdim=True).clamp_min(1e-9)

    cap = moe_capacity(cfg, N)
    flat_e = top_i.reshape(-1)  # (N*k,)
    # counts[e, j]: entries 0..j routed to expert e; entry j's position in its
    # expert is counts[e_j, j] - 1 (the reference's ((cumsum - 1) * onehot).sum)
    onehot = flat_e[None, :] == torch.arange(E, device=x.device)[:, None]  # (E, N*k)
    counts = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    pos = counts.gather(0, flat_e[None, :])[0] - 1  # (N*k,)
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos, E * cap).view(N, k)  # E*cap: the cut-off row

    buf = x.new_zeros((E * cap + 1, D))
    buf[slot] = xf[:, None, :]  # each token into its k rows; no two kept entries share one
    expert_in = buf[:E * cap].view(E, cap, D)

    h = F.silu(_bmm(expert_in, moe.w_gate)) * _bmm(expert_in, moe.w_up)
    # the products as rows 0..E*cap-1 above one zero row, so that a dropped
    # entry gathers 0 (a new tensor, not an out= write: autograd flows)
    out = F.pad(_bmm(h, moe.w_down).view(E * cap, D), (0, 0, 0, 1))
    y_tok = out[slot]  # (N, k, D)
    y = (y_tok * top_w[..., None].to(x.dtype)).sum(dim=1)

    if moe.shared is not None:
        y = y + moe.shared(xf)

    # --- balance metrics + POTUS virtual-queue update -----------------------
    load = counts[:, -1].float()  # (E,) entries routed (pre-drop)
    frac = load / float(max(N * k, 1))  # load.sum() is N*k, exactly in f32
    imp = _mean(probs, dim=0)
    aux_loss = E * torch.sum(frac * imp)  # Switch load-balance loss (metric)
    new_state = None
    if router_state is not None:
        service = N * k / E
        new_state = (router_state + load - service).clamp_min(0.0)  # eq. (8)
    dropped = 1.0 - _mean(keep.float())
    aux = dict(aux_loss=aux_loss, dropped_frac=dropped, load=load, router_state=new_state,
               keep=keep, top_i=top_i)
    return y.reshape(B, S, D), aux
