"""Public wrappers around the port's kernels.

``potus_slot_step`` is the port's counterpart of ``repro.kernels.ops.potus_slot_step``.
The device of the tensors decides the route: CUDA tensors launch the
hand-written kernel (or raise), CPU tensors take the plain PyTorch version.
"""
from __future__ import annotations

from .potus_slot import potus_slot_call, potus_slot_step_plain

__all__ = ["potus_slot_step"]


def potus_slot_step(consts, state, act, pred, nxt, t0, *, scheduler="potus", age_cap=64,
                    n_slots=1):
    """Fused slot step (DESIGN.md §12): ``n_slots`` consecutive slots of
    schedule, drain, land, serve and queue/age update. Returns ``(state,
    metrics)`` with per-slot ``metrics = (backlog, cost, capped, served)``."""
    step = potus_slot_step_plain if act.device.type == "cpu" else potus_slot_call
    return step(consts, state, act, pred, nxt, t0, scheduler=scheduler, age_cap=age_cap,
                n_slots=n_slots)
