"""Public wrappers around the port's kernels.

Each is the port's counterpart of the same name in ``repro.kernels.ops``.
The device of the tensors decides the route: CUDA tensors launch the
hand-written kernel (or raise), CPU tensors take the plain PyTorch version.
:data:`plain` binds the same names to the plain versions on any device, so
that a run on the card can take the plain route to compare against.
"""
from __future__ import annotations

from types import SimpleNamespace

from .cohort_drain import cohort_drain_call, cohort_drain_split_plain
from .potus_price import potus_price_call, potus_price_plain
from .potus_schedule import potus_schedule_alloc_plain, potus_schedule_call
from .potus_slot import potus_slot_call, potus_slot_step_plain

__all__ = ["potus_slot_step", "potus_price", "potus_schedule_alloc", "cohort_drain_split",
           "plain"]


def potus_slot_step(consts, state, act, pred, nxt, t0, *, scheduler="potus", age_cap=64,
                    n_slots=1):
    """Fused slot step (DESIGN.md §12): ``n_slots`` consecutive slots of
    schedule, drain, land, serve and queue/age update. Returns ``(state,
    metrics)`` with per-slot ``metrics = (backlog, cost, capped, served)``."""
    step = potus_slot_step_plain if act.device.type == "cpu" else potus_slot_call
    return step(consts, state, act, pred, nxt, t0, scheduler=scheduler, age_cap=age_cap,
                n_slots=n_slots)


def potus_price(U, q_in, q_out, inst_container, inst_comp, edge_mask, V, beta):
    """(I, I) price matrix of eq. 16, +inf off the DAG edges."""
    fn = potus_price_plain if q_in.device.type == "cpu" else potus_price_call
    return fn(U, q_in, q_out, inst_container, inst_comp, edge_mask, V, beta)


def potus_schedule_alloc(U, q_in, q_out, inst_container, inst_comp, edge_mask, gamma, V, beta):
    """Fused price + water-fill allocation (DESIGN.md §7); returns X (I, I)
    before the mandatory dispatch of actual arrivals."""
    fn = potus_schedule_alloc_plain if q_in.device.type == "cpu" else potus_schedule_call
    return fn(U, q_in, q_out, inst_container, inst_comp, edge_mask, gamma, V, beta)


def cohort_drain_split(src_ext, shipped, ratio, inst_comp, age_bucket):
    """Fused segmented drain + proportional target split of the cohort engine
    (DESIGN.md §8); returns the landing buckets ``land`` (I, Atot)."""
    fn = cohort_drain_split_plain if src_ext.device.type == "cpu" else cohort_drain_call
    return fn(src_ext, shipped, ratio, inst_comp, age_bucket)


#: the plain versions under the wrappers' names, on any device
plain = SimpleNamespace(potus_slot_step=potus_slot_step_plain,
                        potus_price=potus_price_plain,
                        potus_schedule_alloc=potus_schedule_alloc_plain,
                        cohort_drain_split=cohort_drain_split_plain)
