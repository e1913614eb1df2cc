"""Cohort (discrete-event) engine — exact response-time semantics, and the
result record of both cohort engines (paper §5.1 response-time metric).

The port's counterpart of ``repro.core.cohort``. The scan engines merge
fluid cohorts, so they cannot attribute completions to arrival slots. This
engine (``engine="cohort"``) tracks *cohorts* keyed by ``(entry_component,
source_slot)`` through every FIFO queue of the system and reproduces the
paper's response-time metric (§5.1): time from a tuple's actual arrival to
the completion of its last descendant at a terminal bolt, with tuples
pre-served before arrival counting as ~0. Mis-prediction (§5.2.2),
disruption traces (DESIGN.md §9) and the response aggregation (DESIGN.md §2)
follow the reference module line for line.

This event loop is the *semantic oracle* that ``core.cohort_fused``
re-expresses as age-tagged tensors (DESIGN.md §8). So the loop itself stays
numpy and Python, with the reference's dicts, ``deque``s, 1e-12 thresholds
and float64 arithmetic. Only the scheduler call is torch: once a slot the
port's scheduler (``simulator._get_scheduler``) runs on the run's device —
on CUDA the fused schedule kernel (``potus``) or the price kernel
(``potus-loop``), on the CPU their plain versions — and its decision X
(I, I) comes back to the host whole (:class:`_SlotScheduler`).

``metrics=`` (DESIGN.md §14) computes the selected streams' rows on the
host with ``obs.metrics.compute_host_streams``. The scheduler call runs
under the span ``potus/cohort/scheduler-call``.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict, deque

import numpy as np
import torch

from ..device import resolve_device
from ..obs.metrics import MetricsFrame, build_frame, compute_host_streams, scan_stream_names
from ..obs.trace import span as obs_span
from .network import NetworkCosts
from .potus import caps_for_slot, make_problem
from .simulator import _get_scheduler, materialize_arrivals
from .topology import Topology

__all__ = ["CohortResult"]


@dataclasses.dataclass
class CohortResult:
    avg_response: float  # slots, weighted by actual arrivals
    p95_response: float
    avg_backlog: float
    avg_cost: float
    backlog: np.ndarray  # (T,)
    comm_cost: np.ndarray  # (T,)
    n_cohorts: int
    completed_frac: float
    # fraction of terminal completions reporting the age-capped response
    # (DESIGN.md §8): nonzero means age_cap is too shallow; always 0.0 on
    # the event loop, which tracks ages exactly
    saturated_frac: float = 0.0
    # total tuple mass served at terminal bolts over the whole run (warmup
    # and phantoms included) — the conservation ledger
    completed_mass: float = 0.0
    # selected per-slot metric streams (DESIGN.md §14); None without metrics=
    metrics: MetricsFrame | None = None


class _SlotScheduler:
    """The per-slot scheduler call of the host loops (this engine and
    ``core.eventsim``) on ``device``.

    Set-up moves U (as float32, the precision the schedulers compute in),
    the problem and a disruption trace (``events``, an ``EventTrace`` sized
    to the run) to the device once. Each call packs the slot's ``q_in``
    (I,), ``q_out`` (I, C) and ``must_send`` (I, C) into one staging buffer
    (pinned on CUDA), copies it to the device in one asynchronous copy, runs
    the scheduler and returns X (I, I) as a float32 numpy array. The copy of
    X back is the call's one synchronisation; it also orders the next
    slot's reuse of both buffers after this slot's reads.
    """

    def __init__(self, topo: Topology, net: NetworkCosts, inst_container: np.ndarray, cfg,
                 device: torch.device, events=None):
        f32 = dict(dtype=torch.float32, device=device)
        self.prob = make_problem(topo, net, inst_container, device)
        self.sched = _get_scheduler(cfg.scheduler)
        self.U = torch.as_tensor(np.asarray(net.U), **f32)
        self.V, self.beta = float(cfg.V), float(cfg.beta)
        I, C = topo.n_instances, topo.n_components
        shapes, sizes = ((I,), (I, C), (I, C)), [I, I * C, I * C]
        cuda = device.type == "cuda"
        self._host = torch.empty(sum(sizes), dtype=torch.float32, pin_memory=cuda)
        self._dev = torch.empty_like(self._host, device=device) if cuda else self._host
        self._staged = [x.numpy().reshape(s) for x, s in zip(self._host.split(sizes), shapes)]
        self._args = [x.view(s) for x, s in zip(self._dev.split(sizes), shapes)]
        self._ev = None
        if events is not None:  # (3, T, I): the alive, mu and gamma rows, one copy a run
            self._ev = torch.as_tensor(
                np.stack([events.alive_t, events.mu_t, events.gamma_t]), **f32)

    def __call__(self, t: int, q_in: np.ndarray, q_out: np.ndarray,
                 must_send: np.ndarray) -> np.ndarray:
        for dst, src in zip(self._staged, (q_in, q_out, must_send)):
            dst[...] = src
        if self._dev is not self._host:
            self._dev.copy_(self._host, non_blocking=True)
        caps = None
        if self._ev is not None:
            alive, mu, gamma = self._ev[:, t]
            caps = caps_for_slot(mu, gamma, alive)  # dead instances priced out
        X = self.sched(self.prob, self.U, *self._args, self.V, self.beta, caps=caps)
        return X.cpu().numpy()


class _Fifo:
    """FIFO of cohort groups; proportional service within a group."""

    __slots__ = ("groups", "total")

    def __init__(self):
        self.groups: deque = deque()  # each: dict key -> mass
        self.total: float = 0.0

    def push(self, items: dict):
        mass = sum(items.values())
        if mass <= 0:
            return
        self.groups.append(dict(items))
        self.total += mass

    def drain(self, amount: float) -> dict:
        """Remove up to ``amount`` oldest-first; returns key -> mass removed."""
        out: dict = defaultdict(float)
        amount = min(amount, self.total)
        while amount > 1e-12 and self.groups:
            head = self.groups[0]
            head_total = sum(head.values())
            if head_total <= 1e-12:
                self.groups.popleft()
                continue
            take = min(amount, head_total)
            frac = take / head_total
            for k in list(head.keys()):
                moved = head[k] * frac
                out[k] += moved
                head[k] -= moved
            self.total -= take
            amount -= take
            if head_total - take <= 1e-12:
                self.groups.popleft()
        return dict(out)


def _run_cohort_sim_impl(
    topo: Topology,
    net: NetworkCosts,
    inst_container: np.ndarray,
    actual,  # (T, I, C) actual arrivals, or ArrivalSpec
    predicted: np.ndarray | None,  # (T, I, C) predicted arrivals (None => perfect)
    T: int,
    cfg,  # SimConfig
    warmup: int = 50,
    drain_margin: int | None = None,
    events=None,  # EventTrace | None — disruption trace (core.events, DESIGN.md §9)
    metrics=None,  # MetricsSpec | None — selected obs streams (DESIGN.md §14)
    *,
    device="cuda",  # the card unless the caller asks for the CPU
) -> CohortResult:
    """The event loop behind ``simulate(EngineSpec(engine="cohort"))``. The
    run takes ``device="cuda"`` unless the caller asks for the CPU, and raises
    where CUDA is asked for and absent."""
    device = resolve_device(device)
    W = cfg.window
    actual = materialize_arrivals(actual, topo, T + W + 1)
    if predicted is None:
        predicted = actual
    trace = None if events is None else events.prepared(T)
    sched = _SlotScheduler(topo, net, inst_container, cfg, device, trace)

    I, C = topo.n_instances, topo.n_components
    inst_comp = topo.inst_comp
    is_spout = topo.comp_is_spout[inst_comp]
    succ_of = {c: topo.successors_of_comp(c) for c in range(C)}
    sel = topo.selectivity
    mu = topo.inst_mu
    U = net.U
    u_pair = U[np.ix_(inst_container, inst_container)]
    spout_streams = [
        (i, int(c2)) for i in range(I) if is_spout[i] for c2 in succ_of[int(inst_comp[i])]
    ]

    # --- state ---------------------------------------------------------------
    window_unt = {s: np.zeros(W + 1) for s in spout_streams}  # untreated per lookahead pos
    admit_backlog = {s: 0.0 for s in spout_streams}
    q_in = {i: _Fifo() for i in range(I) if not is_spout[i]}
    q_out = {
        (i, int(c2)): _Fifo()
        for i in range(I)
        if not is_spout[i]
        for c2 in succ_of[int(inst_comp[i])]
    }
    transit: list[tuple[int, tuple, float]] = []  # (target, key, mass) landing next slot
    # response accumulators: key -> {terminal_comp: [mass, mass*clip(resp)]}
    resp_acc: dict = defaultdict(lambda: defaultdict(lambda: [0.0, 0.0]))
    weights: dict = defaultdict(float)  # key -> actual arrivals

    # pre-load window with predictions for slots 0..W
    for (i, c2) in spout_streams:
        for w in range(W + 1):
            if w < predicted.shape[0]:
                window_unt[(i, c2)][w] = predicted[w, i, c2]

    backlog_ts = np.zeros(T)
    cost_ts = np.zeros(T)
    completed_mass = 0.0
    met_names = () if metrics is None else scan_stream_names(metrics)
    met_rows: list[tuple] = []
    u_colmean = U.mean(axis=0)[inst_container]  # (I,) mean transfer cost per column

    target_split_cache: dict[int, np.ndarray] = {
        c: topo.instances_of(c) for c in range(C)
    }

    for t in range(T):
        # -- 1. reconcile window pos-0 with actual arrivals of slot t ---------
        tp_t = fp_t = tn_t = drop_t = 0.0
        for (i, c2) in spout_streams:
            pred_total = predicted[t, i, c2] if t < predicted.shape[0] else 0.0
            act = actual[t, i, c2] if t < actual.shape[0] else 0.0
            unt = window_unt[(i, c2)][0]
            tp = min(pred_total, act)
            fp = pred_total - tp
            tn = act - tp
            r = unt / pred_total if pred_total > 0 else 0.0
            window_unt[(i, c2)][0] = r * tp + tn  # drop unserved phantoms
            weights[(c2, t)] += act
            tp_t += tp
            fp_t += fp
            tn_t += tn
            drop_t += r * fp  # phantom remainder retired by reconciliation

        # -- 2. gather queue state, schedule ----------------------------------
        q_in_arr = np.zeros(I, np.float32)
        for i, f in q_in.items():
            q_in_arr[i] = f.total
        q_out_arr = np.zeros((I, C), np.float32)
        must_send = np.zeros((I, C), np.float32)
        for (i, c2), w_arr in window_unt.items():
            q_out_arr[i, c2] = w_arr.sum()
            must_send[i, c2] = w_arr[0] + admit_backlog[(i, c2)]
        for (i, c2), f in q_out.items():
            q_out_arr[i, c2] = f.total

        with obs_span("potus/cohort/scheduler-call", t=t):
            X = sched(t, q_in_arr, q_out_arr, must_send)
        backlog_ts[t] = q_in_arr.sum() + cfg.beta * q_out_arr.sum()
        cost_ts[t] = float((X * u_pair).sum())

        # -- 3. drain sources, enqueue transit ---------------------------------
        new_transit: list[tuple[int, tuple, float]] = []
        for i in range(I):
            ci = int(inst_comp[i])
            for c2 in succ_of[ci]:
                c2 = int(c2)
                targets = target_split_cache[c2]
                amounts = X[i, targets]
                total_amt = float(amounts.sum())
                if total_amt <= 1e-12:
                    continue
                if is_spout[i]:
                    # drain window ascending w; cohort src_slot = t + w
                    w_arr = window_unt[(i, c2)]
                    remaining = total_amt
                    drained: dict = {}
                    for w in range(W + 1):
                        take = min(remaining, w_arr[w])
                        if take > 1e-12:
                            drained[(c2, t + w)] = drained.get((c2, t + w), 0.0) + take
                            w_arr[w] -= take
                            remaining -= take
                        if remaining <= 1e-12:
                            break
                    # shortfall of mandatory dispatch is tracked as admit backlog
                    ab_take = min(remaining, admit_backlog[(i, c2)])
                    if ab_take > 0:
                        drained[(c2, t)] = drained.get((c2, t), 0.0) + ab_take
                        admit_backlog[(i, c2)] -= ab_take
                else:
                    drained = q_out[(i, c2)].drain(total_amt)
                drained_total = sum(drained.values())
                if drained_total <= 1e-12:
                    continue
                for j, amt in zip(targets, amounts):
                    if amt <= 1e-12:
                        continue
                    frac = float(amt) / total_amt
                    for key, mass in drained.items():
                        new_transit.append((int(j), key, mass * frac))
        # any unshipped pos-0 actuals become admission backlog for next slot
        for (i, c2) in spout_streams:
            leftover = window_unt[(i, c2)][0]
            if leftover > 1e-12:
                admit_backlog[(i, c2)] += leftover
                window_unt[(i, c2)][0] = 0.0

        # -- 4. land last slot's transit, serve bolts --------------------------
        land: dict[int, dict] = defaultdict(dict)
        for j, key, mass in transit:
            land[j][key] = land[j].get(key, 0.0) + mass
        for j, items in land.items():
            q_in[j].push(items)
        transit = new_transit

        mu_slot = mu if trace is None else trace.mu_t[t]
        for i, fifo in q_in.items():
            served = fifo.drain(float(mu_slot[i]))
            if not served:
                continue
            ci = int(inst_comp[i])
            succs = succ_of[ci]
            if len(succs) == 0:  # terminal bolt: completions
                for key, mass in served.items():
                    completed_mass += mass
                    acc = resp_acc[key][ci]
                    acc[0] += mass
                    acc[1] += mass * max(t - key[1], 0.0)
            else:
                for c2 in succs:
                    c2 = int(c2)
                    f = sel[ci, c2]
                    q_out[(i, c2)].push({k: m * f for k, m in served.items()})

        # -- 5. shift spout windows, load prediction for slot t + W + 1 --------
        # every lookahead position moves one slot closer to current; the
        # vacated tail admits the prediction for slot t + W + 1 (eqs. 5-7)
        for (i, c2) in spout_streams:
            w_arr = window_unt[(i, c2)]
            w_arr[:-1] = w_arr[1:]
            nxt = t + W + 1
            w_arr[-1] = predicted[nxt, i, c2] if nxt < predicted.shape[0] else 0.0

        # -- 6. per-slot metric rows (DESIGN.md §14) ---------------------------
        if metrics is not None:
            landed = np.zeros(I, np.float32)
            for j, _key, mass in transit:
                landed[j] += mass
            comp_backlog = np.zeros(C)
            np.add.at(comp_backlog, inst_comp, q_in_arr)
            ctx = {
                "h": backlog_ts[t],
                "q_in": q_in_arr,
                "price": cfg.V * u_colmean + q_in_arr,
                "landed": landed,
                "transit_total": landed.sum(),
                "comp_backlog": comp_backlog,
                "held": sum(admit_backlog.values()),
                "dropped": drop_t,
                "tp": tp_t,
                "fp": fp_t,
                "tn": tn_t,
            }
            met_rows.append(compute_host_streams(met_names, ctx))

    # --- aggregate response times ---------------------------------------------
    horizon = T - (drain_margin if drain_margin is not None else max(2 * W + 20, 40))
    resp_list, wts = [], []
    n_keys, n_done = 0, 0
    for key, per_term in resp_acc.items():
        c2, s = key
        if s < warmup or s >= horizon or weights.get(key, 0.0) <= 0:
            continue
        n_keys += 1
        resp = max(acc[1] / acc[0] for acc in per_term.values() if acc[0] > 1e-9)
        resp_list.append(resp)
        wts.append(weights[key])
        n_done += 1
    if resp_list:
        resp_arr, wt_arr = np.array(resp_list), np.array(wts)
        avg = float(np.average(resp_arr, weights=wt_arr))
        order = np.argsort(resp_arr)
        cum = np.cumsum(wt_arr[order]) / wt_arr.sum()
        p95 = float(resp_arr[order][np.searchsorted(cum, 0.95)])
    else:
        avg, p95 = float("nan"), float("nan")
    measured = [k for k in weights if warmup <= k[1] < horizon and weights[k] > 0]
    frame = None
    if metrics is not None:
        cols = [np.stack([row[k] for row in met_rows]) for k in range(len(met_names))]
        frame = build_frame(metrics, cols, n_slots=T, payload_floats=0.0)
    return CohortResult(
        avg_response=avg,
        p95_response=p95,
        avg_backlog=float(backlog_ts[warmup:].mean()) if T > warmup else float(backlog_ts.mean()),
        avg_cost=float(cost_ts[warmup:].mean()) if T > warmup else float(cost_ts.mean()),
        backlog=backlog_ts,
        comm_cost=cost_ts,
        n_cohorts=len(measured),
        completed_frac=(n_done / max(len(measured), 1)),
        completed_mass=completed_mass,
        metrics=frame,
    )
