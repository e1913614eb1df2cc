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

Observability (DESIGN.md §14): ``metrics=`` (a ``MetricsSpec``) appends the
selected streams' rows to each slot's outputs (:func:`sim_step`); they stay
on the device with the chunk's metrics and become ``SimResult.metrics``, a
``MetricsFrame``. The spans ``potus/jax/problem-build`` and
``potus/jax/chunk`` (``repro_torch.obs.trace``, off by default) mark the
set-up and each chunk.

Also here: :class:`SimConfig`, :func:`pad_arrivals` and
:func:`materialize_arrivals`, which the fused cohort engine shares.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import numpy as np
import torch

from ..obs.metrics import MetricsFrame, MetricsSpec, build_frame, compute_scan_streams, scan_stream_names
from ..obs.trace import span as obs_span
from .compact import _rows_add
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
    metrics: MetricsFrame | None = None  # selected obs streams (DESIGN.md §14)

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
    metrics_spec: MetricsSpec | None = None,  # extra per-slot streams (DESIGN.md §14)
) -> tuple[SimState, tuple[torch.Tensor, ...]]:
    """One slot of the paper-§3 dynamics: observe, schedule, update. Returns
    the new state and the slot's ``(h, cost, q_in total, q_out total,
    served total)`` as 0-d tensors on the state's device. With ``caps`` the
    scheduler prices dead instances out, service runs at the slot's
    effective ``mu``, and unshippable mandatory arrivals are held.

    ``metrics_spec`` appends one ``(width,)`` row per selected obs stream to
    the outputs; with ``None`` the step is exactly the one without streams."""
    q_out = effective_qout(prob, state)
    must_send = state.q_rem[:, :, 0]
    X = sched(prob, U, state.q_in, q_out, must_send, V, beta, caps=caps)
    h = state.q_in.sum() + beta * q_out.sum()  # h(t), eq. (12)
    cost = (X * u_pair).sum()  # Theta(t), eq. (11)
    mu_eff = mu if caps is None else caps.mu
    hold = None if caps is None else hold_mask_for(prob, caps)
    new_state, info = slot_update(prob, state, X, new_arr, mu_eff, selectivity_rows,
                                  hold_mask=hold)
    metrics = (h, cost, state.q_in.sum(), q_out.sum(), info["served"].sum())
    if metrics_spec is not None:
        comp = torch.zeros(prob.n_components, dtype=torch.float32, device=h.device)
        ctx = {
            "h": h,
            "q_in": state.q_in,
            "price": V * U.mean(dim=0)[prob.inst_container.long()] + state.q_in,
            "landed": X.sum(dim=0),
            "transit_total": new_state.transit.sum(),
            "comp_backlog": _rows_add(comp, prob.inst_comp.long(), state.q_in),
        }
        metrics = metrics + compute_scan_streams(scan_stream_names(metrics_spec), ctx)
    return new_state, metrics


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
    metrics: MetricsSpec | None = None,  # selected obs streams (DESIGN.md §14)
    *,
    device="cuda",
    ops=None,  # POTUS's kernel route; kernels.ops.plain compares routes on the card
) -> SimResult:
    from ..device import resolve_device
    from .engine import UnsupportedEngineOption

    if cfg.sharded:
        raise UnsupportedEngineOption("sharded", "engine", reason="not ported yet")
    _check_mu_override(mu, events)
    if chunk is not None and chunk <= 0:
        raise ValueError(f"chunk must be a positive slot count, got {chunk}")
    device = resolve_device(device)
    sched = (_get_scheduler(cfg.scheduler) if ops is None or cfg.scheduler not in _POTUS_METHODS
             else partial(_schedule_with, ops, method=_POTUS_METHODS[cfg.scheduler]))
    W = cfg.window
    f32 = dict(dtype=torch.float32, device=device)
    with obs_span("potus/jax/problem-build", T=T, engine="jax"):
        arrivals = pad_arrivals(materialize_arrivals(arrivals, topo, T + W + 1), T + W + 1)
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
    pieces, stream_pieces = [], []
    for t0 in range(0, T, tc):
        t1 = min(t0 + tc, T)
        with obs_span("potus/jax/chunk", t0=t0, t1=t1):
            new_arr = torch.as_tensor(window_stream[t0:t1], **f32)
            ev = None if ev_host is None else tuple(torch.as_tensor(e[t0:t1], **f32)
                                                    for e in ev_host)
            per_slot = torch.empty((t1 - t0, 5), **f32)
            rows = _StreamRows(t1 - t0)
            for k in range(t1 - t0):
                caps = None if ev is None else caps_for_slot(ev[0][k], ev[1][k], ev[2][k])
                state, met = sim_step(prob, sched, U, u_pair, mu_t, sel_rows, V, beta, state,
                                      new_arr[k], caps=caps, metrics_spec=metrics)
                per_slot[k] = torch.stack(met[:5])
                rows.put(k, met[5:])
            pieces.append(per_slot.cpu().numpy())
            stream_pieces.append([r.cpu().numpy() for r in rows.split()])
    per_slot = np.concatenate(pieces) if pieces else np.zeros((0, 5), np.float32)
    frame = None
    if metrics is not None:
        frame = build_frame(metrics, [np.concatenate(a) for a in zip(*stream_pieces)],
                            n_slots=T, payload_floats=0.0)
    return SimResult(
        backlog=per_slot[:, 0].copy(),
        comm_cost=per_slot[:, 1].copy(),
        q_in_total=per_slot[:, 2].copy(),
        q_out_total=per_slot[:, 3].copy(),
        served_total=per_slot[:, 4].copy(),
        final_state=SimState(*(getattr(state, f.name).cpu().numpy()
                               for f in dataclasses.fields(SimState))),
        metrics=frame,
    )


class _StreamRows:
    """A chunk's per-slot stream rows, kept on the device in one (slots,
    total width) tensor (one copy a slot) and split per stream at the
    chunk's end. Holds nothing when the slots carry no streams."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.widths: list[int] = []
        self.buf: torch.Tensor | None = None

    def put(self, k: int, rows) -> None:
        if not rows:
            return
        if self.buf is None:
            self.widths = [int(r.shape[0]) for r in rows]
            self.buf = torch.empty((self.n_slots, sum(self.widths)), dtype=rows[0].dtype,
                                   device=rows[0].device)
        self.buf[k] = torch.cat(rows)

    def split(self) -> tuple[torch.Tensor, ...]:
        """One (slots, width) device tensor per stream, in spec order."""
        return () if self.buf is None else self.buf.split(self.widths, dim=1)
