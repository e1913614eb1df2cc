"""Fused cohort engine in PyTorch — response-time semantics, one step per
slot (DESIGN.md §8).

The port's counterpart of ``repro.core.cohort_fused`` for one scenario, no
instance mesh and no metric streams. Every FIFO is an age-by-source-slot
mass matrix (see the reference module and DESIGN.md §8). State:

* ``q_rem``   (I, S, W+1)  — spout lookahead windows (untreated mass);
* ``admit``   (I, S)       — admission backlog of unshipped actuals;
* ``q_in``    (I, Atot)    — bolt input queues, mass per age bucket;
* ``q_out``   (I, S, Atot) — bolt output queues, mass per age bucket;
* ``transit`` (I, Atot)    — mass landing in input queues next slot.

The reference's ``lax.scan`` over slots is a Python loop, on one of three
routes (DESIGN.md §12), as in the reference:

* a compact scheduler (``potus``, ``shuffle``, ``jsq``) with no disruption
  trace: slot-kernel launches (:func:`_kernel_launches`,
  ``kernels.ops.potus_slot_step``);
* a compact scheduler with a disruption trace (``events=``, DESIGN.md §9):
  ``compact.compact_slot_step`` slot by slot, with the caps fold. The slot
  kernel has no caps fold (nor has the reference's), so on CUDA this route
  is the plain tensor code on the card and launches no slot kernel;
* ``potus-loop``, the dense reference scheduler: :func:`_fused_step` slot by
  slot, on the full (I, I) problem, with the drain and split in
  ``kernels.ops.cohort_drain_split``.

The device decides each kernel's route: on CUDA the hand-written kernel, on
the CPU its plain version. Arrival streams and event traces stay on the
host and go to the device one chunk at a time (``chunk=``, DESIGN.md §11),
the response accumulators of each chunk are folded into host arrays, and
the weighted response aggregation runs on the host (:func:`_aggregate`).
"""
from __future__ import annotations

import dataclasses
import warnings
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import ops as kops
from .cohort import CohortResult
from .compact import (COMPACT_SCHEDULERS, _EPS, StepConsts, _check_columns, _drain_sources, _observe,
                      _serve_and_shift, _to_dense, compact_slot_step, drain_ages, kernel_layout)
from .engine import resolve_device
from .network import NetworkCosts
from .potus import _schedule_with, _u_pair, caps_for_slot, make_problem
from .simulator import (_POTUS_METHODS, SimConfig, host_trace, materialize_arrivals,
                        pad_arrivals)
from .topology import Topology

__all__ = ["drain_ages", "AgeCapSaturationWarning"]

#: ``saturated_frac`` above this emits :class:`AgeCapSaturationWarning` —
#: past ~1% capped completions the response mean is visibly biased low.
SATURATION_WARN_FRAC = 0.01


class AgeCapSaturationWarning(UserWarning):
    """A cohort-fused run truncated a non-negligible completed-mass fraction
    at the ``age_cap`` saturation bucket, so reported response times are
    biased low (DESIGN.md §8). Re-run with the suggested deeper cap."""


def _maybe_warn_saturation(saturated_frac: float, age_cap: int,
                           label: str | None = None) -> None:
    """``label`` names the run in the warning."""
    if saturated_frac > SATURATION_WARN_FRAC:
        where = f" [{label}]" if label else ""
        warnings.warn(
            f"{saturated_frac:.1%} of terminal completions{where} hit the "
            f"age_cap={age_cap} saturation bucket: response times are "
            f"silently truncated (biased low). Re-run with a deeper cap, "
            f"e.g. age_cap={2 * age_cap}.",
            AgeCapSaturationWarning,
            stacklevel=3,
        )


class _CompactProb(NamedTuple):
    """The O(I) problem the compact path consumes (no (I, I) edge mask)."""

    inst_comp: torch.Tensor  # (I,) int32
    inst_container: torch.Tensor  # (I,) int32
    gamma: torch.Tensor  # (I,) f32
    comp_count: torch.Tensor  # (C,) f32
    is_spout: torch.Tensor  # (I,) bool


def _compact_prob(topo: Topology, inst_container, device) -> _CompactProb:
    return _CompactProb(
        inst_comp=torch.as_tensor(topo.inst_comp, dtype=torch.int32, device=device),
        inst_container=torch.as_tensor(np.asarray(inst_container), dtype=torch.int32,
                                       device=device),
        gamma=torch.as_tensor(topo.inst_gamma, dtype=torch.float32, device=device),
        comp_count=torch.as_tensor(topo.comp_parallelism, dtype=torch.float32, device=device),
        is_spout=torch.as_tensor(topo.comp_is_spout[topo.inst_comp], device=device),
    )


# ---------------------------------------------------------------------------
# successor-compact topology view (numpy, as in the reference)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Compact:
    """Static successor-compact structure of one topology (see the reference
    module); instance ranges are contiguous by construction. ``edges`` has
    one entry per DAG edge: the source instance range, the successor's slot
    in the source's successor list, and the target instance range."""

    S: int  # max successors of any component (>= 1)
    edges: tuple  # ((row_start, row_end, slot, col_start, col_end), ...)
    succ_map: np.ndarray  # (I, S) int32 successor comp per slot; C = no edge
    valid: np.ndarray  # (I, S) f32 — 1 where the slot is a real successor
    sel_cmp: np.ndarray  # (I, S) f32 — selectivity toward each successor
    stream_cmp: np.ndarray  # (I, S) f32 — valid & spout row (window streams)
    adj_rows: np.ndarray  # (I, C) f32 — 1 where comp(i) -> c is a DAG edge


def _compact(topo: Topology) -> _Compact:
    I, C = topo.n_instances, topo.n_components
    is_spout = topo.comp_is_spout[topo.inst_comp]
    S = max(1, max((len(topo.successors_of_comp(c)) for c in range(C)), default=1))
    succ_map = np.full((I, S), C, np.int32)
    valid = np.zeros((I, S), np.float32)
    sel_cmp = np.zeros((I, S), np.float32)
    adj_rows = np.zeros((I, C), np.float32)
    edges = []
    for c in range(C):
        rows = topo.instances_of(c)
        if len(rows) == 0:
            continue
        if rows[-1] - rows[0] + 1 != len(rows):
            raise ValueError(
                f"instances of component {c} are not contiguous; the fused "
                "cohort engine requires build_topology-style instance order"
            )
        rs, re = int(rows[0]), int(rows[-1]) + 1
        for s, c2 in enumerate(topo.successors_of_comp(c)):
            cols = topo.instances_of(int(c2))
            edges.append((rs, re, s, int(cols[0]), int(cols[-1]) + 1))
            succ_map[rs:re, s] = c2
            valid[rs:re, s] = 1.0
            sel_cmp[rs:re, s] = topo.selectivity[c, c2]
            adj_rows[rs:re, c2] = 1.0
    stream_cmp = valid * is_spout[:, None].astype(np.float32)
    return _Compact(S, tuple(edges), succ_map, valid, sel_cmp, stream_cmp, adj_rows)


# ---------------------------------------------------------------------------
# the three routes of a chunk
# ---------------------------------------------------------------------------

def _kernel_launches(consts, state, actual, pred, nxt, scheduler, age_cap,
                     slots_per_launch, step=kops.potus_slot_step):
    """Drive one chunk through the slot kernel: launches of ``K =
    slots_per_launch`` slots plus one ragged tail (DESIGN.md §12). ``step``
    is the launch function: the device-routed wrapper, or the plain version
    to compare against."""
    T = actual.shape[0]
    K = max(1, slots_per_launch)
    mets = []
    for s0 in range(0, T, K):
        n = min(K, T - s0)
        state, m = step(consts, state, actual[s0:s0 + n], pred[s0:s0 + n], nxt[s0:s0 + n],
                        s0, scheduler=scheduler, age_cap=age_cap, n_slots=n)
        mets.append(m)
    backlog, cost, capped, served = (torch.cat([m[q] for m in mets]) for q in range(4))
    return state, (backlog, cost, capped.sum(), served.sum())


def _slot_loop(step, state, actual, pred, nxt, ev):
    """Drive one chunk one ``step(state, xs)`` per slot; ``ev`` is the chunk's
    ``(mu_t, gamma_t, alive_t)`` rows or None. The per-slot metrics stay on
    the device until the chunk ends."""
    T = actual.shape[0]
    mets = torch.empty((4, T), dtype=actual.dtype, device=actual.device)
    for k in range(T):
        xs = (actual[k], pred[k], nxt[k], k)
        if ev is not None:
            xs = xs + (tuple(e[k] for e in ev),)
        state, m = step(state, xs)
        mets[:, k] = torch.stack(m)
    return state, (mets[0], mets[1], mets[2].sum(), mets[3].sum())


def _drain_split_inputs(c: StepConsts, X, src_ext, shipped):
    """The drain kernel's inputs, component-dense: ``src_dense`` (I, C,
    Atot+1) and ``ship_dense`` (I, C), scattered through ``succ_map`` with
    the sentinel column dropped, the split fractions ``ratio = X /
    ship_dense[i, comp(j)]`` (0 where nothing ships) and ``inst_comp``."""
    src_dense = _to_dense(c, src_ext)
    ship_dense = _to_dense(c, shipped)
    ship_cols = ship_dense[:, c.inst_comp.long()]  # (I, I)
    ratio = torch.where(ship_cols > _EPS, X / torch.where(ship_cols > 0, ship_cols, 1.0), 0.0)
    return src_dense, ship_dense, ratio, c.inst_comp


def _fused_step(c: StepConsts, prob, sched, edges: tuple, u_pair, V: float, beta: float,
                age_cap: int, state, xs, *, drain_split=kops.cohort_drain_split):
    """One slot of the cohort dynamics on the dense (I, I) problem — the
    route of ``potus-loop``, the reference scheduler (mirrors the reference's
    ``_fused_step`` stage for stage; ``compact_slot_step`` shares stages 1,
    2, 4 and 5).

    ``prob`` is the full :class:`~repro_torch.core.potus.SchedProblem` and
    ``sched(prob, U, q_in, q_out, must_send, V, beta, caps=...)`` returns X
    (I, I). ``xs`` is ``(act_t, pred_t, new_pred, t)``, optionally with one
    slot of a disruption trace ``(mu_row, gamma_row, alive_row)``: the
    scheduler then prices dead instances out and bolts serve at the slot's
    ``mu`` (DESIGN.md §9). ``drain_split`` is ``kernels.ops``'s drain and
    split, the device-routed wrapper or its plain version. Returns
    ``(state, (backlog, cost, capped_served, term_served))``.
    """
    act_t, pred_t, new_pred, t, *ev = xs
    caps = caps_for_slot(*ev[0]) if ev else None
    mu_eff = (c.mu if caps is None else caps.mu) * c.inv_service
    q_rem, admit, q_in_tag, q_out_tag = state[:4]
    I, S, _ = q_rem.shape
    t = _check_columns(t, q_in_tag.shape[-1], state[5])

    # -- 1. reconcile window pos-0 with actual arrivals, 2. observe, schedule --
    q_rem, q_in_arr, q_out_arr, must_send = _observe(c, state, act_t, pred_t)
    X = sched(prob, c.U, q_in_arr, q_out_arr, must_send, V, beta, caps=caps)
    backlog = q_in_arr.sum() + c.beta * q_out_arr.sum()
    cost = (X * u_pair).sum()

    # -- 3. drain sources oldest-first, split over targets -------------------
    # requested mass per successor slot: blocked column sums over DAG edges
    shipped = torch.zeros((I, S), dtype=q_rem.dtype, device=q_rem.device)
    for rs, re, s, cs, ce in edges:
        shipped[rs:re, s] = X[rs:re, cs:ce].sum(dim=1)
    q_rem, admit, q_out_tag, src_ext, _ = _drain_sources(c, q_rem, admit, q_out_tag, shipped,
                                                         age_cap)
    land = drain_split(*_drain_split_inputs(c, X, src_ext, shipped), age_cap)

    # -- 4. serve, 5. admit and shift ------------------------------------------
    state, capped_served, term_served = _serve_and_shift(
        c, (q_rem, admit, q_in_tag, q_out_tag, *state[4:]), land, mu_eff, new_pred, t, age_cap)
    return state, (backlog, cost, capped_served, term_served)


def _step_consts(prob: _CompactProb, comp_onehot, U, mu, inv_service, sel_cmp, stream_cmp,
                 valid_cmp, succ_map, term_f, adj_rows, V, beta, layout) -> StepConsts:
    return StepConsts(
        U=U, mu=mu, inv_service=inv_service, sel_cmp=sel_cmp,
        stream_cmp=stream_cmp, valid_cmp=valid_cmp, succ_map=succ_map,
        term_f=term_f, comp_onehot=comp_onehot,
        inst_comp=prob.inst_comp, inst_cont=prob.inst_container,
        gamma=prob.gamma,
        comp_count=prob.comp_count.to(mu.dtype),
        spout_f=prob.is_spout.to(mu.dtype),
        adj_rows=adj_rows, V=V, beta=beta,
        comp_start=layout[0], cont_rows=layout[1], cont_start=layout[2],
    )


# ---------------------------------------------------------------------------
# host-side preparation and aggregation
# ---------------------------------------------------------------------------

def _stream_mask(topo: Topology) -> np.ndarray:
    """(I, C) — 1.0 on the (spout instance, successor component) streams."""
    is_spout = topo.comp_is_spout[topo.inst_comp]
    return (topo.adj[topo.inst_comp] & is_spout[:, None]).astype(np.float32)


def _terminal_mask(topo: Topology) -> np.ndarray:
    term = np.zeros(topo.n_components, bool)
    term[topo.terminal_components] = True
    is_spout = topo.comp_is_spout[topo.inst_comp]
    return (term[topo.inst_comp] & ~is_spout).astype(np.float32)


def _reachability(topo: Topology) -> np.ndarray:
    """(C, C) bool — transitive closure of the component DAG (incl. self)."""
    C = topo.n_components
    reach = topo.adj | np.eye(C, dtype=bool)
    for _ in range(C):  # C squarings overshoot any DAG diameter
        nxt = reach | (reach @ reach)
        if (nxt == reach).all():
            break
        reach = nxt
    return reach


def _prep_streams(actual, predicted, T: int, W: int, cpt: _Compact, mask: np.ndarray):
    """Pad/slice one scenario's arrival tensors into scan inputs."""
    act = pad_arrivals(np.asarray(actual, np.float32), T)[:T]
    pred = pad_arrivals(np.asarray(predicted if predicted is not None else actual,
                                   np.float32), T + W + 1)
    q_rem0 = np.moveaxis(pred[: W + 1], 0, -1) * mask[:, :, None]  # (I, C, W+1)
    C = mask.shape[1]
    idx = np.minimum(cpt.succ_map, C - 1)[:, :, None]
    q_rem0_cmp = np.take_along_axis(q_rem0, idx, axis=1) * cpt.valid[:, :, None]
    return act, pred[:T], pred[W + 1: T + W + 1], q_rem0_cmp.astype(np.float32)


def _aggregate(
    resp_mass: np.ndarray,  # (C, S_acc)
    resp_time: np.ndarray,  # (C, S_acc)
    weights: np.ndarray,  # (C, T) actual arrivals per (entry component, slot)
    reach: np.ndarray,  # (C, C) bool component reachability
    backlog: np.ndarray,  # (T,)
    cost: np.ndarray,  # (T,)
    saturated_frac: float,  # capped / total terminal completions (whole run)
    completed_mass: float,  # total terminal-served mass (conservation ledger)
    T: int,
    W: int,
    warmup: int,
    drain_margin: int | None,
) -> CohortResult:
    """Weighted response aggregation (§2): per key (entry component, source
    slot), the max over reachable terminal components of the mass-weighted
    mean response, weighted by actual arrivals."""
    horizon = T - (drain_margin if drain_margin is not None else max(2 * W + 20, 40))
    lo, hi = max(warmup, 0), min(horizon, T)
    avg_backlog = float(backlog[warmup:].mean()) if T > warmup else float(backlog.mean())
    avg_cost = float(cost[warmup:].mean()) if T > warmup else float(cost.mean())
    if hi <= lo:
        nan = float("nan")
        return CohortResult(
            avg_response=nan, p95_response=nan, avg_backlog=avg_backlog,
            avg_cost=avg_cost, backlog=backlog, comm_cost=cost,
            n_cohorts=0, completed_frac=0.0, saturated_frac=saturated_frac,
            completed_mass=completed_mass,
        )
    entry_ids = np.nonzero(weights[:, lo:hi].sum(axis=1) > 0)[0]  # (E,)
    live = resp_mass[:, lo:hi] > 1e-9  # (C, H)
    mean_ds = np.where(live, resp_time[:, lo:hi] / np.maximum(resp_mass[:, lo:hi], 1e-30),
                       -np.inf)
    resp_es = np.full((len(entry_ids), hi - lo), -np.inf)
    for k, e in enumerate(entry_ids):
        resp_es[k] = mean_ds[reach[e]].max(axis=0, initial=-np.inf)
    w_es = weights[entry_ids, lo:hi]
    valid = (w_es > 0) & np.isfinite(resp_es)
    if valid.any():
        resp_arr, wt_arr = resp_es[valid], w_es[valid]
        avg = float(np.average(resp_arr, weights=wt_arr))
        order = np.argsort(resp_arr)
        cum = np.cumsum(wt_arr[order]) / wt_arr.sum()
        p95 = float(resp_arr[order][np.searchsorted(cum, 0.95)])
    else:
        avg, p95 = float("nan"), float("nan")
    measured = int((weights[:, lo:hi] > 0).sum())
    return CohortResult(
        avg_response=avg,
        p95_response=p95,
        avg_backlog=avg_backlog,
        avg_cost=avg_cost,
        backlog=backlog,
        comm_cost=cost,
        n_cohorts=measured,
        completed_frac=(int(valid.sum()) / max(measured, 1)),
        saturated_frac=saturated_frac,
        completed_mass=completed_mass,
    )


def _device_inputs(topo: Topology, net: NetworkCosts, cpt: _Compact, device, service=None):
    f32 = dict(dtype=torch.float32, device=device)
    if service is None:
        inv_service = torch.ones(topo.n_instances, **f32)
    else:
        svc = np.broadcast_to(np.asarray(service, np.float32), (topo.n_instances,))
        if (svc <= 0).any():
            raise ValueError("service times must be positive")
        inv_service = torch.as_tensor(1.0 / svc, **f32)
    return dict(
        U=torch.as_tensor(net.U, **f32),
        mu=torch.as_tensor(topo.inst_mu, **f32),
        inv_service=inv_service,
        sel_cmp=torch.as_tensor(cpt.sel_cmp, **f32),
        stream_cmp=torch.as_tensor(cpt.stream_cmp, **f32),
        valid_cmp=torch.as_tensor(cpt.valid, **f32),
        succ_map=torch.as_tensor(cpt.succ_map, dtype=torch.int32, device=device),
        term_f=torch.as_tensor(_terminal_mask(topo), **f32),
        adj_rows=torch.as_tensor(cpt.adj_rows, **f32),
    )


def _run_chunked_cohort(run_chunk, age_cap: int, n_components: int, act: np.ndarray,
                        pred: np.ndarray, nxt: np.ndarray, q0: np.ndarray, ev_host,
                        T: int, chunk: int | None, device):
    """Run the slots ``chunk`` at a time (DESIGN.md §11).

    Arrival streams and the event trace ``ev_host`` (a host triple of (T, I)
    rows, or None) stay on the host; each chunk goes to the device with the
    carried queue state, so device memory is bounded by the chunk, not T.
    ``run_chunk(states, act, pred, nxt, ev)`` runs one chunk on its route.
    Each chunk's response-accumulator slab — indexed by chunk-local source
    slot — is added into full-horizon host arrays at offset ``t0 -
    age_cap``; columns before source slot 0 are provably zero and are
    sliced off. Returns numpy ``(resp_mass, resp_time, backlog, cost,
    capped, served)`` with resp_* of shape (C, T + W + 1).
    """
    I, Sc, W1 = q0.shape
    Atot = age_cap + W1
    f32 = dict(dtype=torch.float32, device=device)
    carry = (
        torch.as_tensor(q0, **f32),
        torch.zeros((I, Sc), **f32),
        torch.zeros((I, Atot), **f32),
        torch.zeros((I, Sc, Atot), **f32),
        torch.zeros((I, Atot), **f32),
    )
    resp_mass = np.zeros((n_components, T + W1), np.float32)
    resp_time = np.zeros((n_components, T + W1), np.float32)
    backlogs: list[np.ndarray] = []
    costs: list[np.ndarray] = []
    capped_tot = 0.0
    served_tot = 0.0

    def to_dev(x):
        return torch.as_tensor(np.ascontiguousarray(x), **f32)

    tc = T if chunk is None else int(chunk)
    for t0 in range(0, T, tc) or [0]:
        t1 = min(t0 + tc, T)
        acc = torch.zeros((n_components, t1 - t0 + Atot), **f32)
        states = carry + (acc, torch.zeros_like(acc))
        ev = None if ev_host is None else tuple(to_dev(e[t0:t1]) for e in ev_host)
        states, (h, cost, capped, served) = run_chunk(
            states, to_dev(act[t0:t1]), to_dev(pred[t0:t1]), to_dev(nxt[t0:t1]), ev)
        carry = tuple(states[:5])
        rm, rt = states[5].cpu().numpy(), states[6].cpu().numpy()
        g0 = t0 - age_cap  # global source slot of the slab's first column
        lo = max(0, -g0)
        resp_mass[:, g0 + lo: t1 + W1] += rm[:, lo:]
        resp_time[:, g0 + lo: t1 + W1] += rt[:, lo:]
        backlogs.append(h.cpu().numpy())
        costs.append(cost.cpu().numpy())
        capped_tot += float(capped)
        served_tot += float(served)
    return (resp_mass, resp_time, np.concatenate(backlogs), np.concatenate(costs),
            capped_tot, served_tot)


def _run_cohort_fused_impl(
    topo: Topology,
    net: NetworkCosts,
    inst_container: np.ndarray,
    actual,  # (T, I, C) actual arrivals, or ArrivalSpec
    predicted: np.ndarray | None,  # (T, I, C) predicted arrivals (None => perfect)
    T: int,
    cfg: SimConfig,
    warmup: int = 50,
    drain_margin: int | None = None,
    age_cap: int = 64,
    events=None,  # EventTrace | None — disruption trace (core.events, DESIGN.md §9)
    service=None,  # (I,) | scalar — per-tuple service time in mu units (DESIGN.md §10)
    chunk: int | None = None,  # streaming: device slots per chunk (DESIGN.md §11)
    slots_per_launch: int = 1,  # slots per kernel launch (DESIGN.md §12)
    device="cuda",  # the card unless the caller asks for the CPU
    ops=kops,  # the kernels' route; kernels.ops.plain compares routes on the card
) -> CohortResult:
    """Fused cohort engine implementation behind ``simulate(EngineSpec)``.

    ``age_cap`` bounds the tracked response of any tuple: mass older than
    ``age_cap`` slots accumulates in the oldest bucket and reports response
    ``age_cap`` (DESIGN.md §8). A too-shallow cap shows up as
    ``CohortResult.saturated_frac > 0`` and an :class:`AgeCapSaturationWarning`.
    Disruption runs need the cap to also cover the outage length (stranded
    mass keeps aging while its instance is down). ``slots_per_launch``
    concerns only the slot-kernel route (a compact scheduler without
    ``events``). The run takes ``device="cuda"`` unless the caller asks for
    the CPU, and raises where CUDA is asked for and absent.
    """
    if age_cap < 2:
        raise ValueError(f"age_cap must be >= 2, got {age_cap}")
    if chunk is not None and chunk <= 0:
        raise ValueError(f"chunk must be a positive slot count, got {chunk}")
    if slots_per_launch < 1:
        raise ValueError(f"slots_per_launch must be >= 1, got {slots_per_launch}")
    device = resolve_device(device)
    W = cfg.window
    actual = materialize_arrivals(actual, topo, T + W + 1)
    prob = _compact_prob(topo, inst_container, device)
    cpt = _compact(topo)
    mask = _stream_mask(topo)
    act, pred, nxt, q_rem0 = _prep_streams(actual, predicted, T, W, cpt, mask)
    dev = _device_inputs(topo, net, cpt, device, service)
    C = topo.n_components
    layout = tuple(torch.as_tensor(x, dtype=torch.int32, device=device) for x in kernel_layout(
        topo.inst_comp, inst_container, C, net.U.shape[0]))
    comp_onehot = torch.nn.functional.one_hot(prob.inst_comp.long(), C).to(torch.float32)
    consts = _step_consts(
        prob, comp_onehot, dev["U"], dev["mu"], dev["inv_service"], dev["sel_cmp"],
        dev["stream_cmp"], dev["valid_cmp"], dev["succ_map"], dev["term_f"], dev["adj_rows"],
        torch.tensor(cfg.V, dtype=torch.float32, device=device),
        torch.tensor(cfg.beta, dtype=torch.float32, device=device), layout)
    ev_host = host_trace(events, T)
    if cfg.scheduler not in COMPACT_SCHEDULERS:
        # the dense reference route: the full problem, (I, I) edge_mask included
        dense = make_problem(topo, net, inst_container, device)
        step = partial(_fused_step, consts, dense,
                       partial(_schedule_with, ops, method=_POTUS_METHODS[cfg.scheduler]),
                       cpt.edges, _u_pair(consts.U, dense.inst_container), float(cfg.V),
                       float(cfg.beta), age_cap, drain_split=ops.cohort_drain_split)
        run_chunk = partial(_slot_loop, step)
    elif ev_host is not None:
        # the caps fold is not in the slot kernel: the compact step, slot by slot
        run_chunk = partial(_slot_loop, partial(compact_slot_step, consts,
                                                scheduler=cfg.scheduler, age_cap=age_cap))
    else:
        def run_chunk(states, act_c, pred_c, nxt_c, ev):
            return _kernel_launches(consts, states, act_c, pred_c, nxt_c, cfg.scheduler,
                                    age_cap, slots_per_launch, step=ops.potus_slot_step)
    resp_mass, resp_time, backlog, cost, capped, served = _run_chunked_cohort(
        run_chunk, age_cap, C, act, pred, nxt, q_rem0, ev_host, T, chunk, device)
    weights = np.einsum("sic,ic->cs", act, mask)
    sat = capped / max(served, 1e-9)
    _maybe_warn_saturation(sat, age_cap, label=f"scheduler={cfg.scheduler} V={cfg.V} W={W}")
    return _aggregate(
        resp_mass, resp_time, weights, _reachability(topo), backlog, cost, sat, served,
        T, W, warmup, drain_margin,
    )
