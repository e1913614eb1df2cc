"""Plain scan engine (``engine="jax"``) in PyTorch — paper §3 dynamics end to end.

The port's counterpart of ``repro.core.simulator``. It folds
``queues.slot_update`` over T slots with a scheduler (POTUS, its loop
reference, Shuffle or JSQ) and reports the Fig. 5 metrics: weighted backlog
h(t) (eq. 12), communication cost Θ(t) (eq. 11) and the queue totals. The
reference's ``lax.scan`` is a Python loop over slots (:func:`sim_step`);
POTUS's schedule runs as the hand-written kernels on CUDA tensors and as
their plain versions on CPU tensors (``core.potus``).

Streaming (DESIGN.md §11): the arrival stream and the disruption trace stay
on the host and go to the device one chunk of slots at a time (``chunk=``;
the monolithic run is one chunk). The per-slot metrics of a chunk stay on
the device in one (slots, 5) tensor and come to the host once per chunk.

Also here: :class:`SimConfig`, :func:`pad_arrivals` and
:func:`materialize_arrivals`, which the fused cohort engine shares.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import numpy as np
import torch

from .events import EventTrace
from .network import NetworkCosts
from .potus import (SchedProblem, SlotCaps, _schedule_with, _u_pair, caps_for_slot,
                    hold_mask_for, make_problem, potus_schedule)
from .queues import SimState, effective_qout, init_state, slot_update
from .topology import Topology

__all__ = ["SimConfig", "SimResult", "sim_step", "pad_arrivals", "materialize_arrivals",
           "host_trace", "stacked_host_traces"]


def host_trace(events: EventTrace | None, T: int):
    """Events as host arrays: a (mu_t, gamma_t, alive_t) triple of (T, I)
    float32 numpy arrays sized to ``T``, or None. The engine moves one chunk
    of rows at a time to the device."""
    if events is None:
        return None
    ev = events.prepared(T)
    return (
        np.asarray(ev.mu_t, np.float32),
        np.asarray(ev.gamma_t, np.float32),
        np.asarray(ev.alive_t, np.float32),
    )


def stacked_host_traces(names, traces, T: int):
    """``(events, shared)`` as host arrays: a single (T, I) triple when every
    scenario names the same trace, else the three arrays stacked to
    (N, T, I). Shared by the sweep partitions of both engines."""
    if len(set(names)) == 1:
        return host_trace(traces[0], T), True
    host = [host_trace(tr, T) for tr in traces]
    return tuple(np.stack([h[k] for h in host]) for k in range(3)), False


def _check_mu_override(mu, events) -> None:
    """A custom ``mu`` and an events trace both claim the service-rate axis:
    ``EventTrace.mu_t`` is compiled from ``topo.inst_mu`` and would shadow
    the override, so the combination is refused."""
    if mu is not None and events is not None:
        raise ValueError(
            "mu override and events trace are mutually exclusive: the trace's "
            "mu_t is compiled from topo.inst_mu and would shadow the override "
            "(compile the EventTrace against a Topology with the custom mu)"
        )


def pad_arrivals(arrivals: np.ndarray, n: int) -> np.ndarray:
    """Zero-pad the arrival tensor to at least ``n`` slots; longer inputs are
    returned unchanged (callers slice the range they need)."""
    if arrivals.shape[0] >= n:
        return arrivals
    pad = np.zeros((n - arrivals.shape[0],) + arrivals.shape[1:], arrivals.dtype)
    return np.concatenate([arrivals, pad], axis=0)


def materialize_arrivals(arrivals, topo: Topology, n_slots: int) -> np.ndarray:
    """Resolve an ``ArrivalSpec`` into a concrete ``(n_slots, I, C)`` tensor;
    arrays pass through unchanged (DESIGN.md §11)."""
    from .workload import ArrivalSpec

    if isinstance(arrivals, ArrivalSpec):
        return arrivals.generate(topo, n_slots)
    return np.asarray(arrivals)


@dataclasses.dataclass
class SimConfig:
    V: float = 3.0
    beta: float = 1.0
    window: int = 0
    scheduler: str = "potus"  # potus | potus-loop | shuffle | jsq
    use_pallas: bool = False
    sharded: bool = False


@dataclasses.dataclass
class SimResult:
    backlog: np.ndarray  # (T,) weighted total backlog h(t)  (eq. 12)
    comm_cost: np.ndarray  # (T,) Theta(t)                      (eq. 11)
    q_in_total: np.ndarray  # (T,)
    q_out_total: np.ndarray  # (T,)
    served_total: np.ndarray  # (T,)
    final_state: SimState  # numpy leaves, copied to the host

    @property
    def avg_backlog(self) -> float:
        return float(self.backlog.mean())

    @property
    def avg_cost(self) -> float:
        return float(self.comm_cost.mean())


#: POTUS's greedy per scheduler name; "potus-loop" is the reference argmin loop (DESIGN.md §7)
_POTUS_METHODS = {"potus": "sort", "potus-loop": "loop"}


def _get_scheduler(name: str) -> Callable:
    """The per-slot scheduler."""
    if name in _POTUS_METHODS:
        return partial(potus_schedule, method=_POTUS_METHODS[name])
    if name == "shuffle":
        from .baselines import shuffle_schedule

        return shuffle_schedule
    if name == "jsq":
        from .baselines import jsq_schedule

        return jsq_schedule
    raise ValueError(f"unknown scheduler {name!r}")


def sim_step(
    prob: SchedProblem,
    sched: Callable,
    U: torch.Tensor,  # (K, K)
    u_pair: torch.Tensor,  # (I, I) = U[k(i), k(j)]
    mu: torch.Tensor,  # (I,)
    selectivity_rows: torch.Tensor,  # (I, C)
    V: float,
    beta: float,
    state: SimState,
    new_arr: torch.Tensor,  # (I, C) — λ(t + W + 1) entering the window
    caps: SlotCaps | None = None,  # one slot of a disruption trace (DESIGN.md §9)
) -> tuple[SimState, tuple[torch.Tensor, ...]]:
    """One slot of the paper-§3 dynamics: observe, schedule, update. Returns
    the new state and the slot's ``(h, cost, q_in total, q_out total,
    served total)`` as 0-d tensors on the state's device. With ``caps`` the
    scheduler prices dead instances out, service runs at the slot's
    effective ``mu``, and unshippable mandatory arrivals are held."""
    q_out = effective_qout(prob, state)
    must_send = state.q_rem[:, :, 0]
    X = sched(prob, U, state.q_in, q_out, must_send, V, beta, caps=caps)
    h = state.q_in.sum() + beta * q_out.sum()  # h(t), eq. (12)
    cost = (X * u_pair).sum()  # Theta(t), eq. (11)
    mu_eff = mu if caps is None else caps.mu
    hold = None if caps is None else hold_mask_for(prob, caps)
    new_state, info = slot_update(prob, state, X, new_arr, mu_eff, selectivity_rows,
                                  hold_mask=hold)
    return new_state, (h, cost, state.q_in.sum(), q_out.sum(), info["served"].sum())


def _run_sim_impl(
    topo: Topology,
    net: NetworkCosts,
    inst_container: np.ndarray,
    arrivals,  # (T + window + 1, I, C) actual+predicted arrivals, or ArrivalSpec
    T: int,
    cfg: SimConfig,
    mu: np.ndarray | None = None,
    events: EventTrace | None = None,  # disruption trace (core.events, DESIGN.md §9)
    chunk: int | None = None,  # streaming: device slots per chunk (DESIGN.md §11)
    metrics=None,
    *,
    device="cuda",
    ops=None,  # POTUS's kernel route; kernels.ops.plain compares routes on the card
) -> SimResult:
    from ..device import resolve_device
    from .engine import UnsupportedEngineOption

    if cfg.sharded:
        raise UnsupportedEngineOption("sharded", "engine", reason="not ported yet")
    if metrics is not None:
        raise UnsupportedEngineOption("jax", "metrics", reason="not ported yet")
    _check_mu_override(mu, events)
    if chunk is not None and chunk <= 0:
        raise ValueError(f"chunk must be a positive slot count, got {chunk}")
    device = resolve_device(device)
    sched = (_get_scheduler(cfg.scheduler) if ops is None or cfg.scheduler not in _POTUS_METHODS
             else partial(_schedule_with, ops, method=_POTUS_METHODS[cfg.scheduler]))
    W = cfg.window
    arrivals = pad_arrivals(materialize_arrivals(arrivals, topo, T + W + 1), T + W + 1)
    f32 = dict(dtype=torch.float32, device=device)
    prob = make_problem(topo, net, inst_container, device)
    state = init_state(topo, W, arrivals[: W + 1], device)
    # Keep the full-horizon streams on the host; only one chunk of slots is
    # ever resident on the device.
    window_stream = np.asarray(arrivals[W + 1: T + W + 1], np.float32)
    ev_host = host_trace(events, T)
    mu_t = torch.as_tensor(mu if mu is not None else topo.inst_mu, **f32)
    sel_rows = torch.as_tensor(topo.selectivity[topo.inst_comp], **f32)
    U = torch.as_tensor(net.U, **f32)
    u_pair = _u_pair(U, prob.inst_container)
    V, beta = float(cfg.V), float(cfg.beta)

    tc = max(T if chunk is None else int(chunk), 1)
    pieces = []
    for t0 in range(0, T, tc):
        t1 = min(t0 + tc, T)
        new_arr = torch.as_tensor(window_stream[t0:t1], **f32)
        ev = None if ev_host is None else tuple(torch.as_tensor(e[t0:t1], **f32)
                                                for e in ev_host)
        per_slot = torch.empty((t1 - t0, 5), **f32)
        for k in range(t1 - t0):
            caps = None if ev is None else caps_for_slot(ev[0][k], ev[1][k], ev[2][k])
            state, met = sim_step(prob, sched, U, u_pair, mu_t, sel_rows, V, beta, state,
                                  new_arr[k], caps=caps)
            per_slot[k] = torch.stack(met)
        pieces.append(per_slot.cpu().numpy())
    per_slot = np.concatenate(pieces) if pieces else np.zeros((0, 5), np.float32)
    return SimResult(
        backlog=per_slot[:, 0].copy(),
        comm_cost=per_slot[:, 1].copy(),
        q_in_total=per_slot[:, 2].copy(),
        q_out_total=per_slot[:, 3].copy(),
        served_total=per_slot[:, 4].copy(),
        final_state=SimState(*(getattr(state, f.name).cpu().numpy()
                               for f in dataclasses.fields(SimState))),
    )
