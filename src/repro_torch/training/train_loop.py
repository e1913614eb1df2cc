"""Loss and train step — the port's counterpart of
``repro.training.train_loop``.

``make_train_step(cfg, tcfg)`` returns ``train_step(state, batch) ->
(state, metrics)`` with ``state = {params, opt: {m, v, step},
router_state, err?}``: ``params`` the model (an ``nn.Module`` from
``model_zoo.init(..., requires_grad=True)``), ``opt`` AdamW's state keyed
by parameter name, ``router_state`` the MoE router's (E,) virtual queues
((1,) zeros without MoE), ``err`` the compression's error feedback. One
step runs the forward, the loss, the backward (on the card the flash
attention kernels both ways), the optional compression and AdamW; the
parameters and moments are updated in place and the state is returned.

The reference's ``grad_specs`` (a GSPMD layout that turns the
data-parallel all-reduce into a reduce-scatter) has no counterpart on one
card and is left out; in a ``torch.distributed`` world of more than one
rank :func:`make_train_step` raises (data-parallel training is not ported
yet).
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from ..distributed.context import require_one_rank
from ..models import model_zoo
from ..models.moe import init_router_state
from .compression import compress_grads, init_error_state
from .optimizer import OptConfig, adamw_update, init_opt_state

__all__ = ["TrainConfig", "make_loss_fn", "make_train_step", "init_train_state"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    remat: str = "none"  # none | full | dots | dots_no_batch
    microbatches: int = 1  # gradient accumulation
    grad_compression: bool = False
    moe_aux_weight: float = 0.01
    z_loss: float = 0.0


def make_loss_fn(cfg, tcfg: TrainConfig, *, ops=None):
    """``loss_fn(model, batch, router_state) -> (loss, (metrics,
    router_state))``: mean cross-entropy over the labels >= 0 (a
    ``vision_stub`` batch's labels cover patches and tokens), plus
    ``z_loss * mean(logsumexp^2)`` and ``moe_aux_weight`` times the mean
    MoE load-balance loss over the layers. ``ops`` picks the attention route
    as ``model_zoo.forward`` does (``kernels.ops.plain`` to compare)."""

    def loss_fn(model, batch, router_state):
        logits, aux = model_zoo.forward(model, cfg, batch, router_state, ops=ops,
                                        remat=tcfg.remat)
        labels = batch["labels"]
        logits32 = logits.float()
        valid = labels >= 0
        safe = labels.clamp_min(0)
        logz = torch.logsumexp(logits32, dim=-1)
        # the gold logit by a gather: the reference's one-hot contraction sums
        # exact zeros beside it, so the two are equal for finite logits
        gold = logits32.gather(-1, safe[..., None].long())[..., 0]
        ce = (logz - gold) * valid
        ntok = valid.sum().clamp_min(1)
        loss = ce.sum() / ntok
        if tcfg.z_loss:
            loss = loss + tcfg.z_loss * torch.mean(torch.square(logz) * valid)
        if cfg.moe:
            loss = loss + tcfg.moe_aux_weight * aux["moe_aux_loss"] / max(cfg.n_layers, 1)
        metrics = dict(loss=loss.detach(), ce=(ce.sum() / ntok).detach(), ntok=ntok,
                       moe_aux=aux["moe_aux_loss"].detach())
        return loss, (metrics, aux["router_state"])

    return loss_fn


def init_train_state(cfg, tcfg: TrainConfig, generator: torch.Generator, device="cuda") -> dict:
    """A model drawn from ``generator`` with gradients on, AdamW's zero state
    and the router state, on the card unless ``device="cpu"``."""
    device = resolve_device(device)
    model = model_zoo.init(cfg, generator, device, requires_grad=True)
    params = dict(model.named_parameters())
    state = dict(params=model, opt=init_opt_state(params, tcfg.opt),
                 router_state=(init_router_state(cfg, device) if cfg.moe
                               else torch.zeros((1,), dtype=torch.float32, device=device)))
    if tcfg.grad_compression:
        state["err"] = init_error_state(params)
    return state


def _split_microbatches(batch, n):
    return [{k: a[i::n] for k, a in batch.items()} for i in range(n)]


def make_train_step(cfg, tcfg: TrainConfig, *, ops=None):
    """``train_step(state, batch) -> (state, metrics)``; ``metrics``: loss,
    ce, ntok, moe_aux (of the last microbatch), grad_norm, lr. With
    ``microbatches`` n > 1 the batch is split as ``a[i::n]``, the gradients
    accumulated in float32 and averaged, the router state threaded through
    the microbatches, and the loss the mean of theirs."""
    require_one_rank("make_train_step (data-parallel gradients, grad_specs, ZeRO-1)")
    loss_fn = make_loss_fn(cfg, tcfg, ops=ops)

    def grads_of(model, names, batch, rs):
        loss, (metrics, rs_new) = loss_fn(model, batch, rs)
        grads = torch.autograd.grad(loss, [p for _, p in names], allow_unused=True,
                                    materialize_grads=True)
        rs = rs if rs_new is None else rs_new.detach()
        return loss.detach(), metrics, dict(zip((n for n, _ in names), grads)), rs

    def train_step(state, batch):
        model = state["params"]
        names = list(model.named_parameters())
        rs = state["router_state"]
        if tcfg.microbatches > 1:
            grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for n, p in names}
            loss_sum = torch.zeros((), dtype=torch.float32, device=rs.device)
            for mb in _split_microbatches(batch, tcfg.microbatches):
                loss, metrics, g, rs = grads_of(model, names, mb, rs)
                for n in grads:
                    grads[n] = grads[n] + g[n]
                loss_sum = loss_sum + loss
            grads = {n: g / tcfg.microbatches for n, g in grads.items()}
            metrics["loss"] = loss_sum / tcfg.microbatches
        else:
            _, metrics, grads, rs = grads_of(model, names, batch, rs)

        if tcfg.grad_compression:
            grads, state["err"] = compress_grads(grads, state["err"])
        _, state["opt"], opt_metrics = adamw_update(dict(names), grads, state["opt"], tcfg.opt)
        metrics.update(opt_metrics)
        state["router_state"] = rs
        return state, metrics

    return train_step
