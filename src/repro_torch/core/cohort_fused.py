"""Fused cohort engine in PyTorch — response-time semantics, one step per
slot (DESIGN.md §8).

The port's counterpart of ``repro.core.cohort_fused``: one scenario
(``simulate``) or a sweep's grid (:func:`run_fused_sweep`), whose partitions
run N scenarios each, on one device or over an instance mesh of ranks
(``sharded=True``, below). Every FIFO
is an age-by-source-slot mass matrix (see the reference module and
DESIGN.md §8). State, each with a leading scenario axis N:

* ``q_rem``   (I, S, W+1)  — spout lookahead windows (untreated mass);
* ``admit``   (I, S)       — admission backlog of unshipped actuals;
* ``q_in``    (I, Atot)    — bolt input queues, mass per age bucket;
* ``q_out``   (I, S, Atot) — bolt output queues, mass per age bucket;
* ``transit`` (I, Atot)    — mass landing in input queues next slot.

The reference's vmapped ``lax.scan`` over slots is a Python loop, on one of
three routes (DESIGN.md §12), as in the reference. :meth:`_Fleet.chunk_runner`
picks the route from the run's spec before anything runs:

* a compact scheduler (``potus``, ``shuffle``, ``jsq``) with no disruption
  trace and no metric streams: slot-kernel launches
  (:func:`_kernel_launches`, ``kernels.ops.potus_slot_step``), one call for
  all N scenarios;
* a compact scheduler with a disruption trace (``events=``, DESIGN.md §9)
  or with metric streams (``metrics=``, DESIGN.md §14):
  ``compact.compact_slot_step`` slot by slot, each scenario in turn. The
  slot kernel has no caps fold and computes no streams (nor has the
  reference's: "metrics never ride the kernel path"), so on CUDA this route
  is the plain tensor code on the card and launches no slot kernel;
* ``potus-loop``, the dense reference scheduler: :func:`_fused_step` slot by
  slot, each scenario in turn, on the full (I, I) problem, with the drain
  and split in ``kernels.ops.cohort_drain_split`` (streams or not).

``sharded=True`` (DESIGN.md §13) runs the scan over ``core.sharded``'s
instance mesh, SPMD on ``torch.distributed`` (:meth:`_Fleet.sharded_runner`):
each rank holds its rows of every stream, state tensor and event row for the
whole run, while ``U``, ``comp_count`` and the response accumulators stay
whole on every rank. The route rule is the reference's: on a one-rank mesh
with ``use_pallas``, ``potus``, no events and no streams the slot kernel runs
exactly as on the dense route; otherwise each scenario in turn runs
``compact_slot_step`` with the collectives (identities on one rank).

With ``metrics=`` every slot also yields the selected streams' rows; they
stay on the device with the chunk's metrics and become each result's
``metrics`` frame. Each chunk runs under the span
``potus/cohort-fused/chunk`` (``repro_torch.obs.trace``, off by default).

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

from ..device import resolve_device
from ..distributed.context import PAYLOAD, rank_device
from ..kernels import ops as kops
from ..obs.metrics import build_frame
from ..obs.trace import span as obs_span
from .cohort import CohortResult
from .compact import (COMPACT_SCHEDULERS, _EPS, StepConsts, _check_columns, _drain_sources,
                      _observe, _serve_and_shift, _to_dense, compact_slot_step, drain_ages,
                      kernel_layout, slot_streams)
from .network import NetworkCosts
from .potus import _schedule_with, _u_pair, caps_for_slot, make_problem
from .sharded import ROUTES, Mesh, instance_mesh
from .simulator import (_POTUS_METHODS, SimConfig, _StreamRows, host_trace,
                        materialize_arrivals, pad_arrivals, stacked_host_traces)
from .topology import Topology

__all__ = ["drain_ages", "AgeCapSaturationWarning", "run_fused_sweep"]

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
            stacklevel=4,
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
    """Drive one chunk of every scenario of a partition through the slot
    kernel: launches of ``K = slots_per_launch`` slots plus one ragged tail
    (DESIGN.md §12), each one call for all N scenarios. ``state`` carries the
    scenario axis, ``consts.V`` and ``consts.beta`` are (N,), and the
    arrivals are (T, I, C) when the scenarios share them, else (N, T, I, C).
    ``step`` is the launch function: the device-routed wrapper, or the plain
    version to compare against."""
    T = actual.shape[-3]
    K = max(1, slots_per_launch)
    mets = []
    for s0 in range(0, T, K):
        n = min(K, T - s0)
        sl = (...,) + (slice(s0, s0 + n), slice(None), slice(None))
        state, m = step(consts, state, actual[sl], pred[sl], nxt[sl], s0,
                        scheduler=scheduler, age_cap=age_cap, n_slots=n)
        mets.append(m)
    backlog, cost, capped, served = (torch.cat([m[q] for m in mets], dim=-1) for q in range(4))
    return state, (backlog, cost, capped.sum(-1), served.sum(-1))


def _each_scenario(runs, shared: bool, ev_shared: bool):
    """A partition's chunk runner from one runner per scenario (``runs``, in
    grid order): each scenario's chunk in turn, on its slice of the batched
    state, arrivals and events; the results (metrics and streams) stacked."""
    def run_chunk(states, actual, pred, nxt, ev):
        outs = []
        for n, run in enumerate(runs):
            xs = (actual, pred, nxt) if shared else (actual[n], pred[n], nxt[n])
            ev_n = ev if ev is None or ev_shared else tuple(e[n] for e in ev)
            outs.append(run(tuple(x[n] for x in states), *xs, ev_n))
        return (tuple(torch.stack([o[0][q] for o in outs]) for q in range(7)),
                tuple(torch.stack([o[1][q] for o in outs]) for q in range(len(outs[0][1]))))
    return run_chunk


def _slot_loop(step, state, actual, pred, nxt, ev):
    """Drive one chunk one ``step(state, xs)`` per slot; ``ev`` is the chunk's
    ``(mu_t, gamma_t, alive_t)`` rows or None. The per-slot metrics, and the
    metric streams' rows a step appends after them, stay on the device until
    the chunk ends; each stream comes back as one (T, width) tensor after the
    four metrics."""
    T = actual.shape[0]
    mets = torch.empty((4, T), dtype=actual.dtype, device=actual.device)
    rows = _StreamRows(T)
    for k in range(T):
        xs = (actual[k], pred[k], nxt[k], k)
        if ev is not None:
            xs = xs + (tuple(e[k] for e in ev),)
        state, m = step(state, xs)
        mets[:, k] = torch.stack(m[:4])
        rows.put(k, m[4:])
    return state, (mets[0], mets[1], mets[2].sum(), mets[3].sum(), *rows.split())


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
                age_cap: int, state, xs, *, drain_split=kops.cohort_drain_split,
                metrics_spec=None):
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
    ``(state, (backlog, cost, capped_served, term_served))``, followed by one
    row per selected stream of ``metrics_spec`` (DESIGN.md §14).
    """
    act_t, pred_t, new_pred, t, *ev = xs
    caps = caps_for_slot(*ev[0]) if ev else None
    mu_eff = (c.mu if caps is None else caps.mu) * c.inv_service
    q_rem, admit, q_in_tag, q_out_tag = state[:4]
    I, S, _ = q_rem.shape
    t = _check_columns(t, q_in_tag.shape[-1], state[5])

    # -- 1. reconcile window pos-0 with actual arrivals, 2. observe, schedule --
    q_rem, q_in_arr, q_out_arr, must_send, recon = _observe(c, state, act_t, pred_t)
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
    out = (backlog, cost, capped_served, term_served)
    if metrics_spec is not None:
        out = out + slot_streams(c, metrics_spec, backlog, q_in_arr, recon, state[1], land,
                                 capped_served, term_served)
    return state, out


#: the fields of :class:`StepConsts` with a leading instance axis
_ROW_FIELDS = ("mu", "inv_service", "sel_cmp", "stream_cmp", "valid_cmp", "succ_map", "term_f",
               "comp_onehot", "inst_comp", "inst_cont", "gamma", "spout_f", "adj_rows")


def _row_consts(c: StepConsts, rows: slice) -> StepConsts:
    """One rank's rows of the constants: the per-instance fields sliced,
    ``U``, ``comp_count``, ``V`` and ``beta`` whole, no kernel layout."""
    return c._replace(**{f: getattr(c, f)[rows] for f in _ROW_FIELDS}, comp_start=None,
                      cont_rows=None, cont_start=None)


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


class _Fleet:
    """What every partition of a run shares, on ``device``: the compact
    problem, the successor-compact view, the device constants, the kernel's
    instance layout and the dense problem of ``potus-loop`` (made on first
    use)."""

    def __init__(self, topo: Topology, net: NetworkCosts, inst_container, device, service):
        self.topo, self.net, self.placement, self.device = topo, net, inst_container, device
        self.prob = _compact_prob(topo, inst_container, device)
        self.cpt = _compact(topo)
        self.mask = _stream_mask(topo)
        self.dev = _device_inputs(topo, net, self.cpt, device, service)
        C = topo.n_components
        self.layout = tuple(torch.as_tensor(x, dtype=torch.int32, device=device)
                            for x in kernel_layout(topo.inst_comp, inst_container, C,
                                                   net.U.shape[0]))
        self.onehot = torch.nn.functional.one_hot(self.prob.inst_comp.long(), C).to(
            torch.float32)
        self._dense = None

    def consts(self, V, beta) -> StepConsts:
        f32 = dict(dtype=torch.float32, device=self.device)
        d = self.dev
        return _step_consts(self.prob, self.onehot, d["U"], d["mu"], d["inv_service"],
                            d["sel_cmp"], d["stream_cmp"], d["valid_cmp"], d["succ_map"],
                            d["term_f"], d["adj_rows"], torch.tensor(V, **f32),
                            torch.tensor(beta, **f32), self.layout)

    def dense(self):
        """The full problem of the dense route, (I, I) edge_mask included, and
        its (I, I) pair costs."""
        if self._dense is None:
            prob = make_problem(self.topo, self.net, self.placement, self.device)
            self._dense = prob, _u_pair(self.dev["U"], prob.inst_container)
        return self._dense

    def chunk_runner(self, scheduler: str, Vs: list, betas: list, has_events: bool,
                     shared: bool, ev_shared: bool, age_cap: int, slots_per_launch: int, ops,
                     metrics=None):
        """The partition's ``run_chunk(states, act, pred, nxt, ev)`` on its
        route, decided here from the spec: a compact scheduler with no events
        and no metric streams (``metrics is None``) takes one slot-kernel
        call a launch for all scenarios; otherwise each scenario runs in
        turn, slot by slot, on ``compact_slot_step`` (a compact scheduler)
        or the dense step (``potus-loop``). This is the reference's rule
        (DESIGN.md §14): the slot kernel computes no streams."""
        if scheduler in COMPACT_SCHEDULERS and not has_events and metrics is None:
            consts = self.consts(Vs, betas)  # V and beta (N,)

            def run_chunk(states, act, pred, nxt, ev):
                return _kernel_launches(consts, states, act, pred, nxt, scheduler, age_cap,
                                        slots_per_launch, step=ops.potus_slot_step)
            return run_chunk
        runs = []
        for V, beta in zip(Vs, betas):
            consts = self.consts(V, beta)
            if scheduler in COMPACT_SCHEDULERS:
                # neither the caps fold nor the streams are in the slot kernel: the
                # compact step, slot by slot
                step = partial(compact_slot_step, consts, scheduler=scheduler, age_cap=age_cap,
                               metrics_spec=metrics)
            else:
                dense, u_pair = self.dense()
                step = partial(_fused_step, consts, dense,
                               partial(_schedule_with, ops, method=_POTUS_METHODS[scheduler]),
                               self.cpt.edges, u_pair, float(V), float(beta), age_cap,
                               drain_split=ops.cohort_drain_split, metrics_spec=metrics)
            runs.append(partial(_slot_loop, step))
        return _each_scenario(runs, shared, ev_shared)

    def sharded_runner(self, mesh: Mesh, scheduler: str, Vs: list, betas: list,
                       use_pallas: bool, has_events: bool, shared: bool, ev_shared: bool,
                       age_cap: int, slots_per_launch: int, ops, metrics=None):
        """The partition's ``run_chunk`` on this rank's rows of ``mesh``
        (DESIGN.md §13), with the reference's route rule: on a one-rank mesh
        with ``use_pallas``, ``potus``, no events and no metric streams the
        slot kernel runs exactly as on the dense route; otherwise each
        scenario in turn runs ``compact_slot_step`` with the collectives.
        Each chunk adds one to :data:`~repro_torch.core.sharded.ROUTES`
        under the route it took."""
        if (mesh.i.size == 1 and use_pallas and scheduler == "potus" and not has_events
                and metrics is None):
            route = "kernel"
            run = self.chunk_runner(scheduler, Vs, betas, False, shared, ev_shared, age_cap,
                                    slots_per_launch, ops)
        else:
            route = "compact"
            rows = mesh.rows(self.topo.n_instances)
            run = _each_scenario([partial(_slot_loop, partial(
                compact_slot_step, _row_consts(self.consts(V, beta), rows), scheduler=scheduler,
                age_cap=age_cap, metrics_spec=metrics, axis=mesh.i))
                for V, beta in zip(Vs, betas)], shared, ev_shared)

        def run_chunk(*args):
            ROUTES[route] += 1
            return run(*args)
        return run_chunk


def _run_chunked_cohort(run_chunk, age_cap: int, n_components: int, act: np.ndarray,
                        pred: np.ndarray, nxt: np.ndarray, q0: np.ndarray, ev_host,
                        ev_shared: bool, T: int, chunk: int | None, device,
                        sharded: bool = False):
    """Run the N scenarios of a partition ``chunk`` slots at a time
    (DESIGN.md §11).

    Arrival streams and the event trace ``ev_host`` (a host triple of rows,
    or None) stay on the host; each chunk goes to the device with the carried
    queue state, so device memory is bounded by the chunk, not T. The
    streams are (T, I, C) when the scenarios share them — copied to the
    device once a chunk, not N times — else (N, T, I, C); the trace is (T, I)
    rows when ``ev_shared``, else (N, T, I). ``q0`` is (N, I, Sc, W+1).
    ``run_chunk(states, act, pred, nxt, ev)`` runs one chunk of every
    scenario on its route. Each chunk's response-accumulator slab — indexed
    by chunk-local source slot — is added into full-horizon host arrays at
    offset ``t0 - age_cap``; columns before source slot 0 are provably zero
    and are sliced off. Returns numpy ``(resp_mass, resp_time, backlog, cost,
    capped, served, streams)``, each with a leading scenario axis; resp_* are
    (N, C, T + W + 1) and ``streams`` is a list of (N, T, width) metric-stream
    slabs, one per stream a chunk's run yields after its four metrics (empty
    without metric streams), concatenated over the chunks. Under sharding
    the queues, streams and trace are this rank's rows and the response
    accumulators whole.
    """
    N, I, Sc, W1 = q0.shape
    Atot = age_cap + W1
    f32 = dict(dtype=torch.float32, device=device)
    carry = (
        torch.tensor(q0, **f32),  # a copy: q0 may be a read-only broadcast
        torch.zeros((N, I, Sc), **f32),
        torch.zeros((N, I, Atot), **f32),
        torch.zeros((N, I, Sc, Atot), **f32),
        torch.zeros((N, I, Atot), **f32),
    )
    resp_mass = np.zeros((N, n_components, T + W1), np.float32)
    resp_time = np.zeros((N, n_components, T + W1), np.float32)
    backlogs: list[np.ndarray] = []
    costs: list[np.ndarray] = []
    capped_tot = np.zeros(N, np.float64)
    served_tot = np.zeros(N, np.float64)
    stream_chunks: list[list[np.ndarray]] = []

    def to_dev(x):
        return torch.as_tensor(np.ascontiguousarray(x), **f32)

    def cut(x, shared, t0, t1):  # slots [t0, t1) of a shared or stacked host array
        return x[t0:t1] if shared else x[:, t0:t1]

    shared = act.ndim == 3
    tc = T if chunk is None else int(chunk)
    for t0 in range(0, T, tc) or [0]:
        t1 = min(t0 + tc, T)
        with obs_span("potus/cohort-fused/chunk", t0=t0, t1=t1, sharded=sharded):
            acc = torch.zeros((N, n_components, t1 - t0 + Atot), **f32)
            states = carry + (acc, torch.zeros_like(acc))
            ev = None if ev_host is None else tuple(to_dev(cut(e, ev_shared, t0, t1))
                                                    for e in ev_host)
            states, (h, cost, capped, served, *streams) = run_chunk(
                states, *(to_dev(cut(x, shared, t0, t1)) for x in (act, pred, nxt)), ev)
        if not stream_chunks:
            stream_chunks = [[] for _ in streams]
        for acc_k, slab in zip(stream_chunks, streams):
            acc_k.append(slab.cpu().numpy())
        carry = tuple(states[:5])
        rm, rt = states[5].cpu().numpy(), states[6].cpu().numpy()
        g0 = t0 - age_cap  # global source slot of the slab's first column
        lo = max(0, -g0)
        resp_mass[:, :, g0 + lo: t1 + W1] += rm[:, :, lo:]
        resp_time[:, :, g0 + lo: t1 + W1] += rt[:, :, lo:]
        backlogs.append(h.cpu().numpy())
        costs.append(cost.cpu().numpy())
        capped_tot += capped.cpu().numpy().astype(np.float64)
        served_tot += served.cpu().numpy().astype(np.float64)
    return (resp_mass, resp_time, np.concatenate(backlogs, axis=1),
            np.concatenate(costs, axis=1), capped_tot, served_tot,
            [np.concatenate(chunks, axis=1) for chunks in stream_chunks])


def _check_opts(age_cap: int, chunk, slots_per_launch: int) -> None:
    if age_cap < 2:
        raise ValueError(f"age_cap must be >= 2, got {age_cap}")
    if chunk is not None and chunk <= 0:
        raise ValueError(f"chunk must be a positive slot count, got {chunk}")
    if slots_per_launch < 1:
        raise ValueError(f"slots_per_launch must be >= 1, got {slots_per_launch}")


def _run_partition(fleet: _Fleet, mesh: Mesh | None, scheduler: str, Vs: list, betas: list,
                   use_pallas: bool, shared: bool, streams, q0, ev_host, ev_shared: bool,
                   T: int, chunk, age_cap: int, slots_per_launch: int, ops, metrics):
    """Run one partition of N scenarios (``streams`` = (act, pred, nxt),
    shared or stacked; ``q0`` (N, I, Sc, W+1)) on its route; under ``mesh``
    on this rank's rows. Returns :func:`_run_chunked_cohort`'s output and
    the elements the collectives moved per scenario and slot (the
    ``payload`` stream; 0 off a mesh and on one rank)."""
    has_events = ev_host is not None
    if mesh is None:
        run_chunk = fleet.chunk_runner(scheduler, Vs, betas, has_events, shared, ev_shared,
                                       age_cap, slots_per_launch, ops, metrics)
        return _run_chunked_cohort(run_chunk, age_cap, fleet.topo.n_components, *streams, q0,
                                   ev_host, ev_shared, T, chunk, fleet.device), 0.0
    run_chunk = fleet.sharded_runner(mesh, scheduler, Vs, betas, use_pallas, has_events, shared,
                                     ev_shared, age_cap, slots_per_launch, ops, metrics)
    rows = mesh.rows(fleet.topo.n_instances)
    ev_rows = None if ev_host is None else tuple(e[..., rows] for e in ev_host)
    moved = PAYLOAD.n()
    out = _run_chunked_cohort(run_chunk, age_cap, fleet.topo.n_components,
                              *(x[..., rows, :] for x in streams), q0[:, rows], ev_rows,
                              ev_shared, T, chunk, fleet.device, sharded=True)
    return out, (PAYLOAD.n() - moved) / max(len(Vs) * T, 1)


def _results(out, weights_s, reach, labels, age_cap, T, W, warmup, drain_margin,
             metrics=None, payload_floats=0.0):
    """One :class:`CohortResult` per scenario of a partition's run ``out``
    (``weights_s``: one arrival-weights matrix, or one per scenario), with
    its ``metrics`` frame when ``metrics`` (a ``MetricsSpec``) is set;
    ``payload_floats`` is its ``payload`` stream."""
    resp_mass, resp_time, backlog, cost, capped, served, streams = out
    results = []
    for s, label in enumerate(labels):
        sat = float(capped[s]) / max(float(served[s]), 1e-9)
        _maybe_warn_saturation(sat, age_cap, label=label)
        result = _aggregate(
            resp_mass[s], resp_time[s], weights_s[s if len(weights_s) > 1 else 0], reach,
            backlog[s], cost[s], sat, float(served[s]), T, W, warmup, drain_margin)
        if metrics is not None:
            result = dataclasses.replace(result, metrics=build_frame(
                metrics, [slab[s] for slab in streams], n_slots=T,
                payload_floats=payload_floats))
        results.append(result)
    return results


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
    metrics=None,  # MetricsSpec | None — metric streams (DESIGN.md §14)
    device="cuda",  # the card unless the caller asks for the CPU
    ops=kops,  # the kernels' route; kernels.ops.plain compares routes on the card
    sharded: bool = False,  # shard the scan over an instance mesh (DESIGN.md §13)
    mesh: Mesh | None = None,  # explicit mesh (implies sharded)
) -> CohortResult:
    """Fused cohort engine implementation behind ``simulate(EngineSpec)``:
    the one-scenario partition of :func:`run_fused_sweep`.

    ``age_cap`` bounds the tracked response of any tuple: mass older than
    ``age_cap`` slots accumulates in the oldest bucket and reports response
    ``age_cap`` (DESIGN.md §8). A too-shallow cap shows up as
    ``CohortResult.saturated_frac > 0`` and an :class:`AgeCapSaturationWarning`.
    Disruption runs need the cap to also cover the outage length (stranded
    mass keeps aging while its instance is down). ``slots_per_launch``
    concerns only the slot-kernel route (a compact scheduler without
    ``events`` or ``metrics``). The run takes ``device="cuda"`` unless the caller asks for
    the CPU, and raises where CUDA is asked for and absent.

    ``sharded`` (or an explicit ``mesh``) runs the scan over an instance
    mesh of ranks (DESIGN.md §13; :meth:`_Fleet.sharded_runner`): every
    rank of the process group calls this with the same arguments, runs its
    rows on its own device and returns the same result.
    """
    _check_opts(age_cap, chunk, slots_per_launch)
    device = resolve_device(device)
    mesh = _sharded_mesh(topo, [cfg.scheduler], sharded, mesh)
    if mesh is not None:
        if not mesh.member:
            return mesh.share(None)
        device = rank_device(device)
    W = cfg.window
    actual = materialize_arrivals(actual, topo, T + W + 1)
    fleet = _Fleet(topo, net, inst_container, device, service)
    act, pred, nxt, q_rem0 = _prep_streams(actual, predicted, T, W, fleet.cpt, fleet.mask)
    out, payload = _run_partition(fleet, mesh, cfg.scheduler, [cfg.V], [cfg.beta],
                                  cfg.use_pallas, True, (act, pred, nxt), q_rem0[None],
                                  host_trace(events, T), True, T, chunk, age_cap,
                                  slots_per_launch, ops, metrics)
    weights = np.einsum("sic,ic->cs", act, fleet.mask)
    result = _results(out, [weights], _reachability(topo),
                      [f"scheduler={cfg.scheduler} V={cfg.V} W={W}"], age_cap, T, W, warmup,
                      drain_margin, metrics, payload)[0]
    return result if mesh is None else mesh.share(result)


def _sharded_mesh(topo: Topology, schedulers, sharded: bool, mesh: Mesh | None):
    """The instance mesh of a sharded run (None when it is not sharded),
    after the reference's checks: compact schedulers only, I divisible."""
    if mesh is None and not sharded:
        return None
    for scheduler in schedulers:  # fail before anything runs: no silent dense fallback
        if scheduler not in COMPACT_SCHEDULERS:
            from .engine import UnsupportedEngineOption  # lazy: engine imports us

            raise UnsupportedEngineOption(
                "cohort-fused", "sharded",
                reason=f"scheduler {scheduler!r} keeps the dense (I, I) reference path; "
                       f"sharded runs support {COMPACT_SCHEDULERS}")
    mesh = mesh if mesh is not None else instance_mesh(topo.n_instances)
    if topo.n_instances % mesh.i.size != 0:
        raise ValueError(f"mesh size {mesh.i.size} does not divide I={topo.n_instances}")
    return mesh


def run_fused_sweep(
    topo: Topology,
    net: NetworkCosts,
    inst_container: np.ndarray,
    arr_map: dict,  # name -> (actual, predicted|None), from the sweep's normalization
    T: int,
    spec,
    warmup: int = 50,
    drain_margin: int | None = None,
    age_cap: int = 64,
    events_map: dict | None = None,  # name -> EventTrace|None, from the sweep's normalization
    service=None,  # (I,) | scalar — per-tuple service time in mu units (DESIGN.md §10)
    chunk: int | None = None,  # streaming: device slots per chunk (DESIGN.md §11)
    slots_per_launch: int = 1,  # slots per kernel launch (DESIGN.md §12)
    metrics=None,  # MetricsSpec | None — per-scenario metric streams (DESIGN.md §14)
    device="cuda",  # the card unless the caller asks for the CPU
    ops=kops,  # the kernels' route; kernels.ops.plain compares routes on the card
) -> tuple[list[CohortResult], int]:
    """Run a whole :class:`~repro_torch.core.sweep.SweepSpec` grid on the
    fused engine: scenarios partition by (scheduler, window, use_pallas,
    whether they carry a disruption trace) as in the reference, and each
    partition runs as one batch of N scenarios — on the slot-kernel route
    one kernel call a launch for all of them, on the events, metrics and
    dense routes each scenario in turn. With ``metrics`` every result carries
    its frame. Returns (results in grid order, n_batches).

    With ``spec.sharded`` every partition runs over the instance mesh, its
    scenarios in turn inside each rank (:meth:`_Fleet.sharded_runner`); a
    scheduler with no shard layout (``potus-loop``) raises before any
    partition runs."""
    _check_opts(age_cap, chunk, slots_per_launch)
    scenarios = spec.scenarios()
    # raising lookup, like arr_map: a named trace missing from the map is a
    # caller error, not an undisturbed run silently labeled as disturbed
    events_map = {"none": None, **(events_map or {})}
    missing = [e for e in spec.events if e not in events_map]
    if missing:
        raise KeyError(f"spec names event scenarios {missing} not present in events_map")
    device = resolve_device(device)
    mesh = _sharded_mesh(topo, [scn.scheduler for scn in scenarios], spec.sharded, None)
    if mesh is not None:
        if not mesh.member:
            return mesh.share(None)
        device = rank_device(device)
    fleet = _Fleet(topo, net, inst_container, device, service)
    reach = _reachability(topo)

    groups: dict[tuple, list] = {}
    for scn in scenarios:
        key = (scn.scheduler, scn.window, scn.use_pallas, events_map[scn.events] is not None)
        groups.setdefault(key, []).append(scn)

    results: list[CohortResult | None] = [None] * len(scenarios)
    for (scheduler, W, use_pallas, has_events), group in groups.items():
        N = len(group)
        shared = len({scn.arrival for scn in group}) == 1
        if shared:  # one prep, one copy a chunk and one weights matrix for the partition
            prepped = [_prep_streams(*arr_map[group[0].arrival], T, W, fleet.cpt, fleet.mask)]
            act, pred, nxt, q0 = prepped[0]
            q0 = np.broadcast_to(q0, (N, *q0.shape))
        else:
            prepped = [_prep_streams(*arr_map[scn.arrival], T, W, fleet.cpt, fleet.mask)
                       for scn in group]
            act, pred, nxt, q0 = (np.stack([p[k] for p in prepped]) for k in range(4))
        weights_s = [np.einsum("sic,ic->cs", p[0], fleet.mask) for p in prepped]
        ev_host, ev_shared = None, True
        if has_events:
            ev_host, ev_shared = stacked_host_traces(
                [scn.events for scn in group], [events_map[scn.events] for scn in group], T)
        out, payload = _run_partition(fleet, mesh, scheduler, [scn.V for scn in group],
                                      [scn.beta for scn in group], use_pallas, shared,
                                      (act, pred, nxt), q0, ev_host, ev_shared, T, chunk,
                                      age_cap, slots_per_launch, ops, metrics)
        labels = [f"scheduler={scheduler} V={scn.V} W={W} arrival={scn.arrival} "
                  f"events={scn.events}" for scn in group]
        for scn, res in zip(group, _results(out, weights_s, reach, labels, age_cap, T, W,
                                            warmup, drain_margin, metrics, payload)):
            results[scn.index] = res
    out = (results, len(groups))
    return out if mesh is None else mesh.share(out)
