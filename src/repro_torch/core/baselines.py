"""Baseline tuple schedulers (paper §5.1) in PyTorch.

The port's counterpart of ``repro.core.baselines``. ``shuffle_schedule`` is
Heron's default: each component's shipment splits evenly over its
instances (in the fluid model also what round-robin converges to).
``jsq_schedule`` (join-shortest-queue) sends it to the instance with the
smallest input queue, ties to the lowest index. Both share the signature of
``potus.potus_schedule``, including ``caps`` (DESIGN.md §9): under a trace
they spread over *alive* instances only, and a dead source ships nothing
(the engines hold its mandatory arrivals).
"""
from __future__ import annotations

import torch

from .potus import SchedProblem, SlotCaps, apply_caps

__all__ = ["shuffle_schedule", "jsq_schedule"]


def _ship_amounts(prob: SchedProblem, q_out: torch.Tensor, must_send: torch.Tensor):
    """(I, C) amount shipped per source toward each successor component:
    everything available, throttled by gamma proportionally (never below the
    mandatory same-slot arrivals)."""
    total = q_out.sum(dim=1, keepdim=True)
    scale = torch.where(total > 0,
                        torch.clamp_max(prob.gamma[:, None] / torch.clamp_min(total, 1e-9), 1.0),
                        0.0)
    return torch.maximum(q_out * scale, must_send)


def _per_target(prob: SchedProblem, ship: torch.Tensor) -> torch.Tensor:
    """(I, I) ``ship[i, comp(j)]``."""
    return ship[:, prob.inst_comp.long()]


def shuffle_schedule(prob: SchedProblem, U, q_in, q_out, must_send, V=0.0, beta=0.0,
                     caps: SlotCaps | None = None) -> torch.Tensor:
    prob, must_send = apply_caps(prob, must_send, caps)
    ship = _ship_amounts(prob, q_out, must_send)
    per_target = _per_target(prob, ship) / prob.comp_count[prob.inst_comp.long()][None, :]
    return torch.where(prob.edge_mask, per_target, 0.0)


def jsq_schedule(prob: SchedProblem, U, q_in, q_out, must_send, V=0.0, beta=0.0,
                 caps: SlotCaps | None = None) -> torch.Tensor:
    """Join-shortest-queue: each component's shipment goes to its instance
    with the smallest input queue (ties -> lowest index; ``torch.argmin``
    returns the first minimum, as ``jnp.argmin`` does)."""
    prob, must_send = apply_caps(prob, must_send, caps)
    ship = _ship_amounts(prob, q_out, must_send)
    I = q_in.shape[0]
    comp = prob.inst_comp.long()
    cand = torch.nn.functional.one_hot(comp, prob.n_components) > 0  # (I, C)
    if caps is not None:
        cand = cand & (caps.alive > 0.0)[:, None]
    masked_q = torch.where(cand, q_in[:, None], float("inf"))
    winner = torch.argmin(masked_q, dim=0)  # (C,)
    target_is_winner = winner[comp] == torch.arange(I, device=q_in.device)
    return torch.where(prob.edge_mask & target_is_winner[None, :], _per_target(prob, ship), 0.0)
