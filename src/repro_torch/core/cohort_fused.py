"""Fused cohort engine in PyTorch — response-time semantics, one slot kernel
per slot (DESIGN.md §8).

The port's counterpart of ``repro.core.cohort_fused`` for one scenario, the
compact schedulers (``potus``, ``shuffle``, ``jsq``), no disruption trace,
no instance mesh and no metric streams. Every FIFO is an age-by-source-slot
mass matrix (see the reference module and DESIGN.md §8). State:

* ``q_rem``   (I, S, W+1)  — spout lookahead windows (untreated mass);
* ``admit``   (I, S)       — admission backlog of unshipped actuals;
* ``q_in``    (I, Atot)    — bolt input queues, mass per age bucket;
* ``q_out``   (I, S, Atot) — bolt output queues, mass per age bucket;
* ``transit`` (I, Atot)    — mass landing in input queues next slot.

The reference's ``lax.scan`` over slots is a Python loop over slot-kernel
launches (:func:`_kernel_launches`). The device decides the route of each
launch (``kernels.ops.potus_slot_step``): on CUDA the hand-written kernel,
on the CPU its plain version. Arrival streams stay on the host and go to
the device one chunk at a time (``chunk=``, DESIGN.md §11), the response
accumulators of each chunk are folded into host arrays, and the weighted
response aggregation runs on the host (:func:`_aggregate`).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import ops as kops
from .cohort import CohortResult
from .compact import COMPACT_SCHEDULERS, StepConsts, drain_ages, kernel_layout
from .network import NetworkCosts
from .simulator import SimConfig, materialize_arrivals, pad_arrivals
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
    module); instance ranges are contiguous by construction."""

    S: int  # max successors of any component (>= 1)
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
            succ_map[rs:re, s] = c2
            valid[rs:re, s] = 1.0
            sel_cmp[rs:re, s] = topo.selectivity[c, c2]
            adj_rows[rs:re, c2] = 1.0
    stream_cmp = valid * is_spout[:, None].astype(np.float32)
    return _Compact(S, succ_map, valid, sel_cmp, stream_cmp, adj_rows)


# ---------------------------------------------------------------------------
# slot-kernel launches
# ---------------------------------------------------------------------------

def _kernel_launches(consts, state, actual, pred, nxt, scheduler, age_cap,
                     slots_per_launch, step=kops.potus_slot_step):
    """Drive one chunk through the slot kernel: launches of ``K =
    slots_per_launch`` slots plus one ragged tail (DESIGN.md §12). ``step``
    is the launch function; the engine always passes the device-routed
    wrapper, a comparison may pass the plain version."""
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


def _run_chunked_cohort(consts: StepConsts, scheduler: str, age_cap: int, n_components: int,
                        act: np.ndarray, pred: np.ndarray, nxt: np.ndarray, q0: np.ndarray,
                        T: int, chunk: int | None, slots_per_launch: int, device,
                        step=kops.potus_slot_step):
    """Run the slots ``chunk`` at a time (DESIGN.md §11).

    Arrival streams stay on the host; each chunk goes to the device with the
    carried queue state, so device memory is bounded by the chunk, not T.
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
        states, (h, cost, capped, served) = _kernel_launches(
            consts, states, to_dev(act[t0:t1]), to_dev(pred[t0:t1]), to_dev(nxt[t0:t1]),
            scheduler, age_cap, slots_per_launch, step=step)
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
    service=None,  # (I,) | scalar — per-tuple service time in mu units (DESIGN.md §10)
    chunk: int | None = None,  # streaming: device slots per chunk (DESIGN.md §11)
    slots_per_launch: int = 1,  # slots per kernel launch (DESIGN.md §12)
    device=None,  # torch.device the run uses; the facade resolves it
    step=kops.potus_slot_step,  # launch function; see _kernel_launches
) -> CohortResult:
    """Fused cohort engine implementation behind ``simulate(EngineSpec)``.

    ``age_cap`` bounds the tracked response of any tuple: mass older than
    ``age_cap`` slots accumulates in the oldest bucket and reports response
    ``age_cap`` (DESIGN.md §8). A too-shallow cap shows up as
    ``CohortResult.saturated_frac > 0`` and an :class:`AgeCapSaturationWarning`.
    """
    if age_cap < 2:
        raise ValueError(f"age_cap must be >= 2, got {age_cap}")
    if chunk is not None and chunk <= 0:
        raise ValueError(f"chunk must be a positive slot count, got {chunk}")
    if slots_per_launch < 1:
        raise ValueError(f"slots_per_launch must be >= 1, got {slots_per_launch}")
    if cfg.scheduler not in COMPACT_SCHEDULERS:
        raise ValueError(f"scheduler must be one of {COMPACT_SCHEDULERS}, got {cfg.scheduler!r}")
    device = torch.device(device if device is not None else "cpu")
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
    resp_mass, resp_time, backlog, cost, capped, served = _run_chunked_cohort(
        consts, cfg.scheduler, age_cap, C, act, pred, nxt, q_rem0, T, chunk,
        slots_per_launch, device, step=step)
    weights = np.einsum("sic,ic->cs", act, mask)
    sat = capped / max(served, 1e-9)
    _maybe_warn_saturation(sat, age_cap, label=f"scheduler={cfg.scheduler} V={cfg.V} W={W}")
    return _aggregate(
        resp_mass, resp_time, weights, _reachability(topo), backlog, cost, sat, served,
        T, W, warmup, drain_margin,
    )
