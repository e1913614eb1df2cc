"""Discrete-event reference simulator — the event-granularity oracle
(DESIGN.md §11.3).

The port's counterpart of ``repro.core.eventsim``. Every other engine
advances in lock-step slots: decisions, transit, landings and service all
quantize to slot boundaries (paper §3). This module executes the same
topology and the same scheduler decisions (POTUS, its loop reference,
Shuffle, JSQ) on a heap-ordered event timeline, so the slot abstraction
itself becomes testable.

Two orthogonal fidelity knobs:

* ``integral`` — ``False`` (fluid): bolts drain continuously at rate ``mu``
  between events, the slot model's fluid service. ``True``: queues hold
  whole tuples, each with deterministic service time ``1/mu``, one
  in-service tuple per instance, and dispatch amounts round to integer
  parcels by largest remainder.
* ``jitter`` — transit parcels land ``1 + jitter * U(0,1)`` slots after
  dispatch instead of exactly 1.

With ``integral=False, jitter=0.0`` the event timeline collapses onto slot
boundaries and the simulator reproduces the scan engine's backlog, cost and
served series exactly (bitwise on dyadic-arithmetic systems).

Event ordering at equal timestamps (DESIGN.md §11.3): at a slot boundary
``t``, service completions due at exactly ``t`` are processed before the
scheduling decision and transit landings due at exactly ``t`` after it;
completions before landings within any equal-time pair.

The heap, the ordering, the ``np.random.default_rng(seed)`` jitter draws and
the float64 arithmetic are the reference's, verbatim, so the same seed gives
the same events. Only the scheduler call is torch: once a slot on the run's
device (``cohort._SlotScheduler``) — on CUDA the fused schedule kernel
(``potus``) or the price kernel (``potus-loop``), on the CPU their plain
versions — with X (I, I) copied back whole.

Deliberate scope: perfect prediction only, and no disruption traces — pass
``events`` to the slot engines instead.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math

import numpy as np

from ..device import resolve_device
from .cohort import _SlotScheduler
from .network import NetworkCosts
from .simulator import SimConfig, materialize_arrivals, pad_arrivals
from .topology import Topology

__all__ = ["EventSimResult", "run_event_sim"]

_EPS = 1e-9
_COMPLETION, _LANDING = 0, 1  # equal-time priority: completions first


@dataclasses.dataclass
class EventSimResult:
    backlog: np.ndarray  # (T,) h(t) observed at each decision boundary
    comm_cost: np.ndarray  # (T,) Theta(t) from the scheduler's X
    q_in_total: np.ndarray  # (T,)
    q_out_total: np.ndarray  # (T,)
    served_total: np.ndarray  # (T,) service completed during (t, t+1]
    completed_mass: float  # terminal completions over the whole run
    n_events: int  # heap events processed (landings + completions)

    @property
    def avg_backlog(self) -> float:
        return float(self.backlog.mean())

    @property
    def avg_cost(self) -> float:
        return float(self.comm_cost.mean())


def _largest_remainder(amounts: np.ndarray, k: int) -> np.ndarray:
    """Split integer ``k`` proportionally to ``amounts`` (sum > 0), integer
    parts by floor, leftovers to the largest fractional shares (ties break
    toward lower index — deterministic)."""
    fair = amounts * (k / amounts.sum())
    base = np.floor(fair).astype(np.int64)
    short = k - int(base.sum())
    if short > 0:
        order = np.argsort(-(fair - base), kind="stable")
        base[order[:short]] += 1
    return base


def run_event_sim(
    topo: Topology,
    net: NetworkCosts,
    inst_container: np.ndarray,
    arrivals,  # (>= T + window + 1, I, C) actual arrivals, or ArrivalSpec
    T: int,
    cfg: SimConfig,
    integral: bool = False,
    jitter: float = 0.0,
    seed: int = 0,
    events=None,  # unsupported here — disruption is slot-engine scope
    *,
    device="cuda",  # the card unless the caller asks for the CPU
) -> EventSimResult:
    """Run ``T`` slots of scheduler decisions at event granularity.

    See the module docstring for the fidelity knobs and the equal-time
    event ordering. Backlog, cost and served series are sampled at the
    decision boundaries, directly comparable to
    :class:`~repro_torch.core.simulator.SimResult`. The run takes
    ``device="cuda"`` unless the caller asks for the CPU, and raises where
    CUDA is asked for and absent.
    """
    if events is not None:
        raise ValueError(
            "run_event_sim does not model disruption traces; run events "
            "scenarios on the slot engines (simulate with engine=jax/cohort-fused)"
        )
    if not 0.0 <= jitter < 1.0:
        raise ValueError(f"jitter must be in [0, 1), got {jitter}")
    if cfg.sharded:
        raise ValueError("run_event_sim is a host-side oracle; sharded does not apply")
    device = resolve_device(device)
    W = cfg.window
    arrivals = materialize_arrivals(arrivals, topo, T + W + 1)
    arrivals = pad_arrivals(np.asarray(arrivals, np.float64), T + W + 1)
    if integral and not np.array_equal(arrivals, np.round(arrivals)):
        raise ValueError("integral=True needs integer arrival counts "
                         "(tuple-at-a-time service has no fractional tuples)")

    sched = _SlotScheduler(topo, net, inst_container, cfg, device)
    rng = np.random.default_rng(seed)

    I, C = topo.n_instances, topo.n_components
    inst_comp = topo.inst_comp
    is_spout = topo.comp_is_spout[inst_comp]
    succ_of = {c: [int(c2) for c2 in topo.successors_of_comp(c)] for c in range(C)}
    targets_of = {c: topo.instances_of(c) for c in range(C)}
    sel = topo.selectivity
    mu = np.asarray(topo.inst_mu, np.float64)
    U = net.U
    u_pair = U[np.ix_(inst_container, inst_container)]
    spout_streams = [
        (i, c2) for i in range(I) if is_spout[i] for c2 in succ_of[int(inst_comp[i])]
    ]
    bolts = [i for i in range(I) if not is_spout[i]]
    terminal = {i for i in bolts if not succ_of[int(inst_comp[i])]}

    # --- state ---------------------------------------------------------------
    window_unt = {s: np.zeros(W + 1) for s in spout_streams}
    admit = dict.fromkeys(spout_streams, 0.0)
    q_in = dict.fromkeys(bolts, 0.0)  # tuples (count if integral, mass if fluid)
    q_out = {
        (i, c2): 0.0 for i in bolts for c2 in succ_of[int(inst_comp[i])]
    }
    busy = dict.fromkeys(bolts, False)  # integral: one in-service tuple
    last_int = dict.fromkeys(bolts, 0.0)  # fluid: last integration time
    for (i, c2) in spout_streams:
        window_unt[(i, c2)][:] = arrivals[: W + 1, i, c2]

    heap: list = []  # (time, priority, seq, instance, mass)
    seq = itertools.count()
    backlog_ts = np.zeros(T)
    cost_ts = np.zeros(T)
    qin_ts = np.zeros(T)
    qout_ts = np.zeros(T)
    served_ts = np.zeros(T)
    completed_mass = 0.0
    n_events = 0
    cur_slot = 0  # slot that service happening "now" is attributed to

    def record_service(i: int, amount: float) -> None:
        nonlocal completed_mass
        served_ts[cur_slot] += amount
        ci = int(inst_comp[i])
        if i in terminal:
            completed_mass += amount
        else:
            for c2 in succ_of[ci]:
                q_out[(i, c2)] += amount * sel[ci, c2]

    def integrate(i: int, tau: float) -> None:  # fluid service over (last, tau]
        dt = tau - last_int[i]
        last_int[i] = tau
        if dt <= 0 or q_in[i] <= _EPS:
            return
        take = min(q_in[i], mu[i] * dt)
        q_in[i] -= take
        record_service(i, take)

    def start_service(i: int, tau: float) -> None:  # integral: next tuple
        if not busy[i] and q_in[i] >= 1:
            busy[i] = True
            heapq.heappush(heap, (tau + 1.0 / mu[i], _COMPLETION, next(seq), i, 1.0))

    def process(ev) -> None:
        nonlocal n_events
        tau, prio, _, i, mass = ev
        n_events += 1
        if prio == _COMPLETION:
            busy[i] = False
            q_in[i] -= 1
            record_service(i, 1.0)
            start_service(i, tau)
        else:  # landing
            if integral:
                q_in[i] += mass
                start_service(i, tau)
            else:
                integrate(i, tau)
                q_in[i] += mass

    for t in range(T):
        # -- 1. events due by the boundary: completions at exactly t are the
        #       slot model's slot-(t-1) service, landings at exactly t are
        #       this slot's transit — only the former precede the decision
        while heap and (heap[0][0] < t or (heap[0][0] == t and heap[0][1] == _COMPLETION)):
            process(heapq.heappop(heap))
        if not integral:
            for i in bolts:
                integrate(i, float(t))
        cur_slot = t

        # -- 2. observe queues, schedule (the same scheduler, the same inputs) -
        q_in_arr = np.zeros(I, np.float32)
        for i in bolts:
            q_in_arr[i] = q_in[i]
        q_out_arr = np.zeros((I, C), np.float32)
        must_send = np.zeros((I, C), np.float32)
        for (i, c2), w_arr in window_unt.items():
            q_out_arr[i, c2] = w_arr.sum()
            must_send[i, c2] = w_arr[0] + admit[(i, c2)]
        for (i, c2), m in q_out.items():
            q_out_arr[i, c2] = m
        X = np.asarray(sched(t, q_in_arr, q_out_arr, must_send), np.float64)
        backlog_ts[t] = q_in_arr.sum() + cfg.beta * q_out_arr.sum()
        cost_ts[t] = float((X * u_pair).sum())
        qin_ts[t] = q_in_arr.sum()
        qout_ts[t] = q_out_arr.sum()

        # -- 3. dispatch: drain sources, emit transit parcels ------------------
        for i in range(I):
            ci = int(inst_comp[i])
            for c2 in succ_of[ci]:
                targets = targets_of[c2]
                amounts = X[i, targets]
                D = float(amounts.sum())
                if D <= _EPS:
                    continue
                if is_spout[i]:
                    avail = window_unt[(i, c2)].sum() + admit[(i, c2)]
                else:
                    avail = q_out[(i, c2)]
                if integral:
                    want = int(math.floor(D + 0.5))
                    k = min(want, int(math.floor(avail + _EPS)))
                    if k <= 0:
                        continue
                    per_target = _largest_remainder(amounts, k).astype(np.float64)
                    shipped = float(k)
                else:
                    shipped = min(D, avail)
                    per_target = amounts * (shipped / D)
                # drain the source: window ascending-lookahead then admission
                # backlog (spouts), or the output queue scalar (bolts)
                if is_spout[i]:
                    remaining = shipped
                    w_arr = window_unt[(i, c2)]
                    for w in range(W + 1):
                        take = min(remaining, w_arr[w])
                        w_arr[w] -= take
                        remaining -= take
                        if remaining <= _EPS:
                            break
                    ab = min(remaining, admit[(i, c2)])
                    admit[(i, c2)] -= ab
                    remaining -= ab
                else:
                    q_out[(i, c2)] = max(q_out[(i, c2)] - shipped, 0.0)
                for j, m in zip(targets, per_target):
                    if m <= _EPS:
                        continue
                    tau = t + 1.0 + (jitter * float(rng.random()) if jitter > 0 else 0.0)
                    heapq.heappush(heap, (tau, _LANDING, next(seq), int(j), float(m)))

        # -- 4. unshipped mandatory actuals -> admission backlog; shift window -
        for (i, c2) in spout_streams:
            w_arr = window_unt[(i, c2)]
            leftover = w_arr[0]
            if leftover > _EPS:
                admit[(i, c2)] += leftover
            w_arr[:-1] = w_arr[1:]
            w_arr[-1] = arrivals[t + W + 1, i, c2]

    # -- final interval (T-1, T]: the slot model serves slot T-1 too ----------
    while heap and (heap[0][0] < T or (heap[0][0] == T and heap[0][1] == _COMPLETION)):
        process(heapq.heappop(heap))
    if not integral:
        for i in bolts:
            integrate(i, float(T))

    return EventSimResult(
        backlog=backlog_ts,
        comm_cost=cost_ts,
        q_in_total=qin_ts,
        q_out_total=qout_ts,
        served_total=served_ts,
        completed_mass=completed_mass,
        n_events=n_events,
    )
