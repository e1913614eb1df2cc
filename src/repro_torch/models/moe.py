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

The global batch (``axis``). Under the data-parallel train step each rank
holds only its rows of the batch; ``axis``, the ``"data"`` axis those rows
are cut over (``training.train_loop``), makes the layer compute what the
reference's ``moe_ffn`` computes under GSPMD over the global batch of N
tokens, N the rank's count times the axis's size (the rows split evenly):
the capacity from N, the price's ``scale`` over every token (a ``psum``),
each entry's position in global token order (rank-major, as
``distributed.sharding.batch_shardings`` cuts the rows: each rank's
(E,) counts go out in one ``all_gather`` with its importance sums, and
rank r's entries start after the lower ranks'), the loads, ``frac``, the
importance, the router state's update and ``dropped_frac``, the same on
every rank. A rank runs the expert products for its own kept entries with
the whole expert weights: an expert row's output depends on its own token
alone, so no token moves. Of these values only the importance carries a
gradient; ``aux["aux_term"]`` is this rank's term of the load-balance
loss, ``E * sum(frac * probs.sum(0) / N)`` over its rows, whose sum over
the ranks is the global ``aux_loss`` and whose gradient is this rank's
share of the global one. On :data:`~repro_torch.distributed.SOLO` (every
caller but training across ranks) ``aux_term`` is ``aux_loss`` and the
function is the one-rank layer, bitwise. The collectives count under
``"moe"``.

The experts over a model axis (``tp``). Under tensor-parallel training each
rank of the mesh's ``"model"`` axis holds E/m of the experts, by the
reference's rule (``"experts"`` over "model", where E divides; the
reference also cuts F over "data", FSDP, which the port leaves whole). The
routing (the selections, capacity, positions, loads, the router state, the
aux loss and ``dropped_frac``) is computed whole, the same on every model
rank. A rank runs the expert products only for the kept entries routed to
its own experts, every other entry going to the cut-off row, and its
combine is a partial sum that leaves the layer through
``distributed.reduce_from``. Two ``distributed.copy_to`` carry the
gradients the ranks split: one on the token rows entering the buffer, one
on the combine weights (a rank's products cover only its experts, so its
router gradient through them would be partial). The router's input gets
none: its path runs whole on every rank. The shared expert runs its own cut
of ``d_ff`` (``common.MLP``). Where E does not divide, the experts stay
whole on every rank and the layer runs as without ``tp``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.context import SOLO, all_gather, copy_to, psum, reduce_from
from .common import MLP, tp_cut

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


def _recip(n: int) -> float:
    """The float32 reciprocal of ``n``: XLA turns a division by a constant
    into a product with it."""
    return float(np.float32(1.0) / np.float32(n))


def _mean(t, dim=None):
    """``t.mean(dim)`` as the reference's computes it under XLA: the sum
    times the float32 reciprocal of the count, so that ``dropped_frac`` and
    the POTUS prices round as the reference's do."""
    n = t.numel() if dim is None else t.shape[dim]
    s = t.sum() if dim is None else t.sum(dim=dim)
    return s * _recip(n)


def _aux_term(frac, probs, n_tokens: int):
    """``E * sum(frac * probs.sum(0) / n_tokens)``: the Switch load-balance
    loss of ``probs``'s rows, whose ``n_tokens`` is the global count. The
    gradient flows through ``probs`` alone (``frac`` counts selections)."""
    return probs.shape[-1] * torch.sum(frac * (probs.sum(dim=0) * _recip(n_tokens)))


def _bmm(a, b):
    """``einsum("ecd,edf->ecf")`` over operands promoted to one type, as
    ``jnp.einsum`` promotes them."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return torch.bmm(a.to(dtype), b.to(dtype))


def moe_ffn(moe, x, cfg, router_state=None, axis=SOLO, tp=SOLO):
    """x: (B, S, D), this rank's rows of the batch whose other rows the
    ranks of ``axis`` hold (:data:`SOLO`: the whole batch). Returns ``(y
    (B, S, D), aux)``; ``aux`` holds the tensors ``aux_loss``,
    ``dropped_frac``, ``load`` (E,) (entries routed to each expert, before
    drops) and ``router_state``, the updated virtual queues (None without a
    state), all global, ``aux_term``, this rank's term of ``aux_loss``
    (with the gradient), and this rank's ``keep`` (N*k,) and ``top_i``
    (N, k). ``tp``: the model axis whose ranks each hold E/m of the experts
    where E divides over it (``moe``'s ``w_gate``, ``w_up`` and ``w_down``
    are then this rank's block) and the shared expert's block of ``d_ff``."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    N = B * S
    Ng = N * axis.size  # the global token count: the rows split evenly
    xf = x.reshape(N, D)

    logits = xf.float() @ moe.router.float()  # (N, E)
    probs = torch.softmax(logits, dim=-1)
    sel_scores = logits
    if cfg.router == "potus" and router_state is not None:
        # price = affinity - beta * virtual backlog  (eq. 16, U=0)
        # the mean over every rank's tokens (no gradient reaches the selections)
        scale = (psum(logits.detach().abs().sum(), axis, "moe") * _recip(Ng * E)).clamp_min(1e-6)
        backlog = router_state / (_mean(router_state) + 1.0).clamp_min(1.0)
        sel_scores = logits - cfg.potus_router_beta * scale * backlog[None, :]
    # the lower index first on equal prices, as jax.lax.top_k
    top_i = torch.sort(sel_scores, dim=-1, descending=True, stable=True).indices[:, :k]
    # combine weights always come from the raw affinities (unbiased output)
    gather_p = probs.gather(-1, top_i)
    top_w = gather_p / gather_p.sum(-1, keepdim=True).clamp_min(1e-9)

    cap = moe_capacity(cfg, Ng)
    flat_e = top_i.reshape(-1)  # (N*k,)
    # counts[e, j]: entries 0..j routed to expert e; entry j's position in its
    # expert is counts[e_j, j] - 1 (the reference's ((cumsum - 1) * onehot).sum)
    onehot = flat_e[None, :] == torch.arange(E, device=x.device)[:, None]  # (E, N*k)
    counts = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    local = counts.gather(0, flat_e[None, :])[0] - 1  # (N*k,) among this rank's entries
    load = counts[:, -1].float()  # (E,) entries routed (pre-drop)
    pos, imp_sums = local, None
    if axis.size > 1:
        # every rank's counts and importance sums: the global loads, and this rank's
        # entries placed after the lower ranks' in each expert
        ranks = all_gather(torch.cat([load, probs.detach().sum(dim=0)])[None], axis, "moe")
        pos = local + ranks[:axis.index, :E].sum(dim=0).to(torch.int32)[flat_e]
        load, imp_sums = ranks[:, :E].sum(dim=0), ranks[:, E:].sum(dim=0)
    keep = pos < cap  # a kept entry's local position is below cap too: its rank's row
    cut = tp_cut(E, tp)
    xin, w = xf, top_w
    if cut:  # this model rank's experts: the others' entries go to the cut-off row
        E_loc = E // tp.size
        mine = keep & (flat_e // E_loc == tp.index)
        slot = torch.where(mine, (flat_e - tp.index * E_loc) * cap + local, E_loc * cap)
        xin, w = copy_to(xf, tp), copy_to(top_w, tp)
    else:
        E_loc = E
        slot = torch.where(keep, flat_e * cap + local, E * cap)  # E*cap: the cut-off row
    slot = slot.view(N, k)

    buf = x.new_zeros((E_loc * cap + 1, D))
    buf[slot] = xin[:, None, :]  # each token into its k rows; no two kept entries share one
    expert_in = buf[:E_loc * cap].view(E_loc, cap, D)

    h = F.silu(_bmm(expert_in, moe.w_gate)) * _bmm(expert_in, moe.w_up)
    # the products as rows 0..E*cap-1 above one zero row, so that a dropped
    # entry gathers 0 (a new tensor, not an out= write: autograd flows)
    out = F.pad(_bmm(h, moe.w_down).view(E_loc * cap, D), (0, 0, 0, 1))
    y_tok = out[slot]  # (N, k, D)
    y = (y_tok * w[..., None].to(x.dtype)).sum(dim=1)
    if cut:  # this rank's experts' share of the combine
        y = reduce_from(y, tp)

    if moe.shared is not None:
        y = y + moe.shared(xf, tp)

    # --- balance metrics + POTUS virtual-queue update -----------------------
    frac = load / float(max(Ng * k, 1))  # load.sum() is Ng*k, exactly in f32
    aux_term = _aux_term(frac, probs, Ng)  # Switch load-balance loss (metric)
    aux_loss = aux_term if imp_sums is None else E * torch.sum(frac * (imp_sums * _recip(Ng)))
    new_state = None
    if router_state is not None:
        service = Ng * k / E
        new_state = (router_state + load - service).clamp_min(0.0)  # eq. (8)
    # expert e keeps the first cap of its load_e entries (an exact count, as keep.sum())
    dropped = 1.0 - load.clamp_max(cap).sum() * _recip(Ng * k)
    aux = dict(aux_loss=aux_loss, aux_term=aux_term, dropped_frac=dropped, load=load,
               router_state=new_state, keep=keep, top_i=top_i)
    return y.reshape(B, S, D), aux
