"""Scenario sweeps in PyTorch (DESIGN.md §6).

The port's counterpart of ``repro.core.sweep``. The paper's results are
parameter sweeps — response time against the lookahead window W (Fig. 4),
backlog and cost against V (Fig. 5), response under imperfect predictors
(Fig. 6) and the disruption grid (DESIGN.md §9). A sweep is a first-class
object here as in the reference:

* :class:`SweepSpec` declares the axes — V, beta, window W, scheduler, a
  named arrival scenario and a named disruption trace — in the reference's
  grid order;
* :func:`run_sweep` partitions the grid by (scheduler, window, use_pallas,
  whether a scenario carries a disruption trace), exactly as the reference
  keys its batches, and runs each partition;
* :class:`SweepResult` returns one result per scenario, in grid order.

The engines behind it: ``engine="cohort-fused"`` runs each partition as one
batch of N scenarios (:func:`~repro_torch.core.cohort_fused.run_fused_sweep`),
whose undisturbed compact partitions take one slot-kernel call a launch for
all N; ``engine="jax"`` runs each partition's scenarios in grid order
through the scan engine (the port's scan step has no scenario axis yet).
``engine_opts["metrics"]`` gives every scenario its metric streams' frame
on both engines (DESIGN.md §14); a compact ``cohort-fused`` partition with
metrics runs its scenarios in turn on the compact step, as its events
partitions do. ``engine="cohort"`` and ``sharded`` are not ported yet and
raise :class:`~repro_torch.core.engine.UnsupportedEngineOption`.
A sweep takes ``device="cuda"`` unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any

import numpy as np

from .engine import (OPTION_SUPPORT, UnsupportedEngineOption, check_engine_option,
                     check_metrics_spec)
from .events import EventTrace, FleetScenario
from .network import NetworkCosts
from .simulator import SimConfig, _check_mu_override, _run_sim_impl, materialize_arrivals
from .topology import Topology

__all__ = ["Scenario", "SweepSpec", "SweepResult", "run_sweep"]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One point of a sweep grid."""

    index: int
    V: float
    beta: float
    window: int
    scheduler: str
    arrival: str
    use_pallas: bool = False
    sharded: bool = False
    events: str = "none"  # named disruption trace (core.events, DESIGN.md §9)

    def config(self) -> SimConfig:
        return SimConfig(V=self.V, beta=self.beta, window=self.window,
                         scheduler=self.scheduler, use_pallas=self.use_pallas,
                         sharded=self.sharded)

    def matches(self, **axes: Any) -> bool:
        return all(getattr(self, k) == v for k, v in axes.items())


def _as_tuple(v) -> tuple:
    if isinstance(v, tuple):
        return v
    if isinstance(v, (list, np.ndarray)):
        return tuple(v)
    return (v,)


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """Declarative grid of simulator configurations (full cross product).

    ``window``, ``scheduler`` and ``use_pallas`` partition the grid, as do
    disrupted and undisturbed scenarios; V, beta, the arrival scenario and
    the named disruption trace vary inside a partition. ``use_pallas`` and
    ``sharded`` are single flags, not axes.
    """

    V: tuple = (3.0,)
    beta: tuple = (1.0,)
    window: tuple = (0,)
    scheduler: tuple = ("potus",)
    arrival: tuple = ("default",)
    events: tuple = ("none",)
    use_pallas: bool = False
    sharded: bool = False

    def __post_init__(self):
        for axis in ("V", "beta", "window", "scheduler", "arrival", "events"):
            object.__setattr__(self, axis, _as_tuple(getattr(self, axis)))
        for flag in ("use_pallas", "sharded"):
            if not isinstance(getattr(self, flag), bool):
                # not an axis: a truthy tuple would silently re-route everything
                raise TypeError(
                    f"{flag} is a single flag, not a sweep axis; run separate "
                    f"sweeps per backend (got {getattr(self, flag)!r})"
                )

    @property
    def n_scenarios(self) -> int:
        return (len(self.V) * len(self.beta) * len(self.window) * len(self.scheduler)
                * len(self.arrival) * len(self.events))

    def scenarios(self) -> list[Scenario]:
        """Grid order: events, arrival, scheduler, window, beta outermost;
        V innermost."""
        return [
            Scenario(idx, float(V), float(beta), int(W), sched, arr,
                     self.use_pallas, self.sharded, events=ev)
            for idx, (ev, arr, sched, W, beta, V) in enumerate(
                itertools.product(self.events, self.arrival, self.scheduler,
                                  self.window, self.beta, self.V)
            )
        ]


@dataclasses.dataclass
class SweepResult:
    spec: SweepSpec
    scenarios: list[Scenario]
    results: list  # SimResult | CohortResult, aligned with ``scenarios``
    n_batches: int  # number of scenario partitions

    def __len__(self) -> int:
        return len(self.scenarios)

    def __iter__(self):
        return iter(zip(self.scenarios, self.results))

    def select(self, **axes: Any) -> list[tuple[Scenario, Any]]:
        """All (scenario, result) pairs whose axes match, in grid order."""
        return [(s, r) for s, r in self if s.matches(**axes)]

    def result(self, **axes: Any):
        """The single result matching ``axes``; raises if not exactly one."""
        hits = self.select(**axes)
        if len(hits) != 1:
            raise KeyError(f"{axes} matches {len(hits)} scenarios, expected 1")
        return hits[0][1]


def _normalize_arrivals(arrivals, spec: SweepSpec, topo: Topology,
                        n_slots: int) -> dict[str, tuple[np.ndarray, np.ndarray | None]]:
    """name -> (actual, predicted|None). A bare array (or ``ArrivalSpec``) is
    the scenario ``"default"`` with perfect prediction; ``ArrivalSpec``
    values are materialized here against the sweep's topology and horizon."""
    from .workload import ArrivalSpec

    if isinstance(arrivals, (np.ndarray, ArrivalSpec)):
        arrivals = {"default": arrivals}
    out: dict[str, tuple[np.ndarray, np.ndarray | None]] = {}
    for name, val in arrivals.items():
        actual, predicted = val if isinstance(val, tuple) else (val, None)
        actual = materialize_arrivals(actual, topo, n_slots)
        if predicted is not None:
            predicted = materialize_arrivals(predicted, topo, n_slots)
        out[name] = (actual, predicted)
    missing = [a for a in spec.arrival if a not in out]
    if missing:
        raise KeyError(f"spec names arrival scenarios {missing} not present in arrivals")
    return out


def _normalize_events(events, spec: SweepSpec, topo: Topology, T: int,
                      inst_container: np.ndarray) -> dict[str, EventTrace | None]:
    """name -> EventTrace|None. ``"none"`` is always the undisturbed fleet;
    :class:`FleetScenario` values are compiled here (with the placement
    vector, so container-level outages resolve)."""
    out: dict[str, EventTrace | None] = {"none": None}
    for name, val in (events or {}).items():
        if val is None:
            out[name] = None
        elif isinstance(val, FleetScenario):
            out[name] = val.compile(topo, T, placement=inst_container)
        elif isinstance(val, EventTrace):
            out[name] = val
        else:
            raise TypeError(f"events[{name!r}] must be FleetScenario | EventTrace | None")
    missing = [e for e in spec.events if e not in out]
    if missing:
        raise KeyError(f"spec names event scenarios {missing} not present in events")
    return out


def _not_ported(engine: str, option: str, item: int):
    return UnsupportedEngineOption(
        engine, option, reason=f"not ported yet (ROADMAP.md, section 1, module item {item})")


def run_sweep(
    topo: Topology,
    net: NetworkCosts,
    inst_container: np.ndarray,
    arrivals,  # np.ndarray | dict[str, np.ndarray | (actual, predicted)]
    T: int,
    spec: SweepSpec,
    mu: np.ndarray | None = None,
    engine: str = "jax",  # jax | cohort-fused (cohort: not ported yet)
    engine_opts: dict | None = None,  # warmup/drain_margin/age_cap/service/slots_per_launch
    #   (cohort-fused), "chunk" (both engines; DESIGN.md §11) and "metrics" (both; §14)
    events=None,  # dict[str, FleetScenario | EventTrace | None] for spec.events
    device="cuda",  # the card unless the caller asks for the CPU
) -> SweepResult:
    """Run every scenario of ``spec`` and return per-scenario results in grid
    order, with the reference's partitions (``n_batches``).

    ``engine="cohort-fused"`` runs each partition as one batch
    (:func:`~repro_torch.core.cohort_fused.run_fused_sweep`);
    ``engine="jax"`` runs each partition's scenarios in grid order through
    the scan engine. Named disruption traces (``spec.events`` / the
    ``events`` map) form one more scenario axis on both.
    ``engine_opts={"metrics": ...}`` selects metric streams for every
    scenario, checked per engine as ``simulate`` checks them. Each scenario's
    result equals its own ``simulate``.
    """
    scenarios = spec.scenarios()
    arr_map = _normalize_arrivals(arrivals, spec, topo, T + max(spec.window) + 1)
    ev_map = _normalize_events(events, spec, topo, T, inst_container)
    opts = dict(engine_opts or {})
    chunk = opts.get("chunk")
    if chunk is not None and (not isinstance(chunk, (int, np.integer)) or chunk <= 0):
        raise ValueError(f"engine_opts['chunk'] must be a positive slot count, got {chunk!r}")
    if engine not in ("jax", "cohort", "cohort-fused"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "cohort":
        raise _not_ported("cohort", "engine", 4)
    if spec.sharded:
        raise _not_ported(engine, "sharded", 5)
    metrics = check_metrics_spec(engine, opts.pop("metrics", None))

    if engine == "cohort-fused":
        if mu is not None:
            raise UnsupportedEngineOption(engine, "mu")
        from .cohort_fused import run_fused_sweep

        results, n_batches = run_fused_sweep(topo, net, inst_container, arr_map, T, spec,
                                             events_map=ev_map, metrics=metrics, device=device,
                                             **opts)
        return SweepResult(spec, scenarios, results, n_batches=n_batches)

    for opt in sorted(set(opts) - {"chunk"}):
        if opt not in OPTION_SUPPORT:
            raise ValueError(f"unknown engine_opts key {opt!r}")
        check_engine_option("jax", opt)
    active_traces = [t for t in (ev_map[scn.events] for scn in scenarios) if t is not None]
    if active_traces:
        _check_mu_override(mu, active_traces[0])
    if any(arr_map[a][1] is not None for a in spec.arrival):
        # distinct 'predicted' streams only make sense on the cohort engines
        # (the scan engine takes its one stream as predicted and actual)
        check_engine_option("jax", "predicted")
    groups: dict[tuple, list[Scenario]] = {}
    for scn in scenarios:
        key = (scn.scheduler, scn.window, scn.use_pallas, ev_map[scn.events] is not None)
        groups.setdefault(key, []).append(scn)
    results: list = [None] * len(scenarios)
    for group in groups.values():
        for scn in group:
            results[scn.index] = _run_sim_impl(
                topo, net, inst_container, arr_map[scn.arrival][0], T, scn.config(), mu=mu,
                events=ev_map[scn.events], chunk=chunk, metrics=metrics, device=device)
    return SweepResult(spec, scenarios, results, n_batches=len(groups))
