"""Expert-parallel MoE across ranks — the port's counterpart of
``repro.models.moe_ep``.

The reference's layout on its ``("data", "model")`` mesh:

  tokens               : split over "data" (replicated over "model")
  experts              : split over "data" (EP groups = data ranks)
  expert FFN inner dim : split over "model" (TP inside each expert)

  per layer wire = 2 x all_to_all (token buffers over "data")
                 + 1 x psum (the FFN contraction over "model")

The reference writes the per-device body inside ``shard_map``; the port is
SPMD, one process per rank (``distributed.context``): every rank calls
:func:`moe_ffn_ep` with the global ``x`` (B, S, D), takes its block of the
N = B*S token rows by its data index, runs :func:`_local_moe` and returns
the global ``y``, all-gathered over "data" (the reference's ``token_spec``
out-spec). Routing (top-k, capacity, the POTUS prices) is local to each
data rank, as in the reference, which keeps these of its choices where they
part from ``moe.moe_ffn``:

* the POTUS price's ``scale`` is the mean of |logits| over the rank's own
  N_loc tokens;
* capacity comes in two stages: ``cap_send = max(ceil(N_loc*k*cf / ep), 1)``
  entries per destination rank, in token-major order, then
  ``cap_loc = moe_capacity(cfg, N_loc*ep)`` per local expert over the
  received buffer, in rank-major order;
* ``dropped_frac`` counts the send side's drops only;
* the router state moves by the global ``load`` (a psum over "data"), its
  service ``load.sum() / E``.

Each rank holds only its block of the weights: ``w_gate``/``w_up``
(E/ep, D, F/mp), ``w_down`` (E/ep, F/mp, D), the shared expert's F/mp
columns (its ``w_out``'s F/mp rows) and the whole router, the reference's
``in_specs``. :func:`place_` cuts them once, when a model is put on a mesh.
The expert products stay ``torch.bmm``, as in ``moe.moe_ffn``.

The reference's ``psum`` and ``pmean`` over "data" (the load, the
importance and the kept share) travel as one all-reduce here; the sums of
each element are the same.

Under the train step (``training.train_loop`` on an ``(n, 1)``, ``(1, m)``
or ``(d, m)`` mesh) each rank passes its own rows of the batch and gets
its rows' ``y`` (``moe_ffn_ep(..., rows=data)``): no cut and no gather.
The layer is differentiable: the ``all_to_all`` exchanges carry their
gradients back (``distributed.context``), and the sum over "model" is the
conjugate pair of tensor-parallel training, every model rank computing the
same loss: ``distributed.copy_to`` on the expert buffer entering the F-cut
products (the sum of the model ranks' cotangents), ``reduce_from`` on
their partial output (the ``psum`` forward, the identity backward), and
the shared expert's own pair (``common.MLP``'s cut of its ``d_ff``). The
router and the send buffers are whole on every model rank. So an expert
block's gradient is complete on its rank, summed over every rank's
tokens, and is not summed over "data". The folded all-reduce carries none:
``aux["aux_term"]``, this rank's term of the load-balance loss (as
``moe.moe_ffn`` builds it), carries the importance's gradient, and its sum
over the ranks is the global ``aux_loss``, which gives each rank the
gradient the reference's ``pmean`` gives: the one-device one where nothing
drops.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.context import SOLO, all_gather, all_to_all, copy_to, psum, reduce_from
from .moe import MoE, _aux_term, _bmm, _mean, init_router_state, moe_capacity

__all__ = ["moe_ffn_ep", "place_", "check_mesh"]


def _positions(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Each entry's position among the earlier entries of its class in
    ``idx`` (values in [0, n); any other value is in no class and gets a
    meaningless position): the reference's ``(cumsum(one_hot) - 1)`` read at
    the entry's own class."""
    onehot = idx[None, :] == torch.arange(n, device=idx.device)[:, None]  # (n, M)
    counts = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    return counts.gather(0, idx.clamp(0, n - 1)[None, :])[0] - 1


def _local_moe(moe, xf, cfg, router_state, data, model):
    """The per-rank body, the reference's ``_local_moe``. ``xf`` (N_loc, D)
    is this rank's token block; ``moe`` holds this rank's weight blocks.
    Returns (y (N_loc, D), aux) with ``aux_loss``, ``aux_term`` (this
    rank's term of it, with the gradient), ``dropped_frac``, ``load``,
    ``router_state`` (None without a state), ``top_i`` (N_loc, k),
    ``keep`` (N_loc*k,), the send side's mask, and ``keep_recv``
    (ep*cap_send,), the receive side's over the received rows."""
    N_loc, D = xf.shape
    E, k, ep = cfg.n_experts, cfg.top_k, data.size
    E_loc = E // ep
    dev = xf.device

    logits = xf.float() @ moe.router.float()  # (N_loc, E)
    probs = torch.softmax(logits, dim=-1)
    sel = logits
    if cfg.router == "potus" and router_state is not None:
        scale = _mean(logits.abs()).clamp_min(1e-6)  # this rank's tokens only
        backlog = router_state / (_mean(router_state) + 1.0).clamp_min(1.0)
        sel = logits - cfg.potus_router_beta * scale * backlog[None, :]
    # the lower index first on equal prices, as jax.lax.top_k
    top_i = torch.sort(sel, dim=-1, descending=True, stable=True).indices[:, :k]
    gp = probs.gather(-1, top_i)
    top_w = gp / gp.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_e = top_i.reshape(-1)  # (N_loc*k,) global expert ids, token-major
    dest = flat_e // E_loc  # the data rank that owns the expert
    e_loc = flat_e % E_loc

    # ---- send side: fixed buffers per destination, one trash row past them ----
    cap_send = max(int(np.ceil(N_loc * k * cfg.capacity_factor / ep)), 1)
    pos = _positions(dest, ep)
    keep = pos < cap_send
    slot = torch.where(keep, dest * cap_send + pos, ep * cap_send)
    send_tok = xf.new_zeros((ep * cap_send + 1, D))
    send_tok[slot.view(N_loc, k)] = xf[:, None, :]
    send_e = torch.full((ep * cap_send + 1,), -1, dtype=torch.int32, device=dev)
    send_e[slot] = e_loc.to(torch.int32)

    rec_tok = all_to_all(send_tok[:-1], data)  # (R, D), rank-major
    rec_e = all_to_all(send_e[:-1], data).long()  # (R,), -1 on an empty row

    # ---- receive side: this rank's experts' buffers -------------------------------
    cap_loc = moe_capacity(cfg, N_loc * ep)
    valid = rec_e >= 0
    pos2 = _positions(torch.where(valid, rec_e, E_loc), E_loc)
    keep2 = valid & (pos2 < cap_loc)
    slot2 = torch.where(keep2, rec_e * cap_loc + pos2, E_loc * cap_loc)
    buf = xf.new_zeros((E_loc * cap_loc + 1, D))
    buf[slot2] = rec_tok
    # the F-cut products' entry: each model rank's cotangent is its part of the whole one
    expert_in = copy_to(buf[:-1].view(E_loc, cap_loc, D), model, "ep")

    h = F.silu(_bmm(expert_in, moe.w_gate)) * _bmm(expert_in, moe.w_up)
    y_exp = reduce_from(_bmm(h, moe.w_down), model, "ep")  # partial over F_loc: summed
    back = F.pad(y_exp.view(E_loc * cap_loc, D), (0, 0, 0, 1))[slot2]  # (R, D); dropped -> 0
    ret = F.pad(all_to_all(back, data), (0, 0, 0, 1))  # our entries' results, one zero row
    y_tok = ret[slot.view(N_loc, k)]  # (N_loc, k, D); dropped -> 0
    y = (y_tok * top_w[..., None].to(xf.dtype)).sum(dim=1)

    if moe.shared is not None:
        # the shared expert runs tensor-parallel: its F/mp columns give a partial sum
        y = y + moe.shared(xf, model, "ep")

    # ---- aux metrics: one all-reduce over "data" of load, importance, kept share ----
    load_loc = (flat_e[None, :] == torch.arange(E, device=dev)[:, None]).sum(1).float()
    folded = psum(torch.cat([load_loc, _mean(probs.detach(), dim=0),
                             _mean(keep.float())[None]]), data, "ep")
    load = folded[:E]
    imp = folded[E:2 * E] / ep
    frac = load / load.sum().clamp_min(1.0)
    aux_loss = E * torch.sum(frac * imp)
    new_state = None
    if router_state is not None:
        service = load.sum() / E
        new_state = (router_state + load - service).clamp_min(0.0)
    dropped = 1.0 - folded[2 * E] / ep
    return y, dict(aux_loss=aux_loss, aux_term=_aux_term(frac, probs, N_loc * ep),
                   dropped_frac=dropped, load=load, router_state=new_state, top_i=top_i,
                   keep=keep, keep_recv=keep2)


def check_mesh(cfg, mesh, n_tokens: int | None = None) -> None:
    """Raise as the reference's ``shard_map`` refuses: ``ValueError`` when
    ``mesh``'s "data" size does not divide the experts (or ``n_tokens``
    rows) or its "model" size ``d_ff``, or this rank is not on the mesh;
    ``NotImplementedError`` for a mesh with a "pod" axis."""
    if "pod" in mesh.shape:
        raise NotImplementedError(
            "moe_ffn_ep on a mesh with a 'pod' axis is not ported yet (ROADMAP.md, section 1, "
            "module item 5b: launch/dryrun.py)")
    ep, mp = mesh.shape["data"], mesh.shape["model"]
    for what, n, size, axis in (("n_experts", cfg.n_experts, ep, "data"),
                                ("d_ff", cfg.d_ff, mp, "model"),
                                ("the B*S token rows", n_tokens, ep, "data")):
        if n is not None and n % size:
            raise ValueError(f"moe_ffn_ep: {what} = {n} does not split over the {size} ranks "
                             f"of mesh axis {axis!r}")
    if not mesh.member:
        raise ValueError("moe_ffn_ep: this rank is not on the mesh")


def moe_ffn_ep(moe, x, cfg, mesh, router_state=None, rows=SOLO):
    """``moe.moe_ffn`` under a model mesh with "data" and "model" axes.
    ``x``: (B, S, D), the same on every rank; ``moe`` holds this rank's
    weight blocks (:func:`place_`). Returns ``(y (B, S, D), aux)``, the same
    on every rank but for ``aux``'s ``aux_term``, ``top_i``, ``keep`` and
    ``keep_recv``, which are this rank's (see :func:`_local_moe`).
    ``rows``: the mesh's "data" axis when ``x`` is this rank's rows of the
    batch (the train step's), and then ``y`` is this rank's rows."""
    B, S, D = x.shape
    N = B * S
    data, model = mesh.axis("data"), mesh.axis("model")
    if rows.size > 1 and rows != data:
        raise ValueError("moe_ffn_ep: the rows must be cut over the mesh's 'data' axis")
    check_mesh(cfg, mesh, N if rows.size == 1 else None)
    want = (cfg.n_experts // data.size, D, cfg.d_ff // model.size)
    if tuple(moe.w_gate.shape) != want:
        raise ValueError(f"moe_ffn_ep: w_gate is {tuple(moe.w_gate.shape)}, this rank's block "
                         f"is {want}: place the model on the mesh first (moe_ep.place_)")
    xf = x.reshape(N, D)
    if rows.size == 1:
        n_loc = N // data.size
        xf = xf[data.index * n_loc:(data.index + 1) * n_loc]
    rs = router_state if router_state is not None else init_router_state(cfg, x.device)
    y, aux = _local_moe(moe, xf, cfg, rs, data, model)
    if router_state is None:
        aux["router_state"] = None
    if rows.size == 1:
        y = all_gather(y, data, "ep")
    return y.view(B, S, D), aux


def _block(p: torch.Tensor, dim: int, axis) -> torch.Tensor:
    n = p.shape[dim] // axis.size
    return p.narrow(dim, axis.index * n, n)


@torch.no_grad()
def place_(module: nn.Module, mesh) -> nn.Module:
    """Cut every :class:`~.moe.MoE` layer in ``module`` to this rank's
    blocks on ``mesh``, once, in place: the experts by the "data" index, the
    inner dimension F by the "model" index, the router whole. Returns
    ``module``."""
    data, model = mesh.axis("data"), mesh.axis("model")
    for moe in (m for m in module.modules() if isinstance(m, MoE)):
        E, Ff = moe.w_gate.shape[0], moe.w_gate.shape[2]
        if E % data.size or Ff % model.size:
            raise ValueError(f"place_: {E} experts of F={Ff} do not split over a mesh "
                             f"{mesh.shape}")
        cuts = [(moe, "w_gate", ((0, data), (2, model))), (moe, "w_up", ((0, data), (2, model))),
                (moe, "w_down", ((0, data), (1, model)))]
        if moe.shared is not None:
            cuts += [(lin, "weight", ((1 if name == "w_out" else 0, model),))
                     for name, lin in moe.shared.named_children()]
        for owner, name, dims in cuts:
            whole = p = getattr(owner, name)
            for dim, axis in dims:
                p = _block(p, dim, axis)
            setattr(owner, name, nn.Parameter(p.clone(), requires_grad=whole.requires_grad))
    return module
