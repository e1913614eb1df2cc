"""Disruption traces — time-varying fleet events as dense per-slot capacity
tensors (DESIGN.md §9).

The port's numpy copy of ``repro.core.events`` (importing it from there
would run the JAX engines' package ``__init__``). A declarative list of
:class:`FleetEvent`\\ s — instance failures with recovery, stragglers
(degraded ``mu``), transmission throttling (degraded ``gamma``),
autoscaling and container-level outages — compiles to an
:class:`EventTrace` of three dense (T, I) float32 tensors:

* ``alive_t``  — 0/1 instance liveness per slot;
* ``mu_t``     — *effective* processing capacity (0 where dead);
* ``gamma_t``  — *effective* transmission capacity (0 where dead).

The engines consume one row of each per slot and price dead instances out
(``core.potus.apply_caps``). An identity trace is numerically a no-op: the
trajectories are bit-identical to ``events=None``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .topology import Topology

__all__ = [
    "FleetEvent",
    "FleetScenario",
    "EventTrace",
    "identity_trace",
    "rolling_restart",
    "flash_straggler",
    "k_failures",
    "diurnal_autoscale",
    "random_chaos",
]

_KINDS = ("failure", "scale_down", "outage", "straggler", "throttle")


@dataclasses.dataclass(frozen=True)
class FleetEvent:
    """One disruption over the half-open slot window ``[start, end)``.

    Kinds and their targets:

    * ``failure`` / ``scale_down`` — instances go dead (``alive = 0``).
      ``scale_down`` is the autoscaling spelling of the same tensor effect;
      the distinct name keeps scenarios readable.
    * ``outage`` — container-level correlated failure: every instance whose
      ``placement`` entry equals ``container`` goes dead (requires the
      placement vector at compile time).
    * ``straggler`` — ``mu`` multiplied by ``factor`` (degraded service).
    * ``throttle`` — ``gamma`` multiplied by ``factor`` (degraded egress).

    Targets are the union of ``instances`` and, when set, every instance of
    ``component`` (and of ``container`` for outages).
    """

    kind: str
    start: int
    end: int
    instances: tuple[int, ...] = ()
    component: int | None = None
    container: int | None = None
    factor: float = 1.0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown event kind {self.kind!r} (expected one of {_KINDS})")
        if self.end < self.start:
            raise ValueError(f"event window [{self.start}, {self.end}) is empty-negative")
        if self.kind == "outage" and self.container is None:
            raise ValueError("outage events target a container; set container=")
        if self.kind in ("straggler", "throttle") and not 0.0 <= self.factor:
            raise ValueError(f"factor must be >= 0, got {self.factor}")

    def target_mask(self, topo: Topology, placement: np.ndarray | None) -> np.ndarray:
        """(I,) bool — instances this event touches."""
        mask = np.zeros(topo.n_instances, dtype=bool)
        if self.instances:
            mask[list(self.instances)] = True
        if self.component is not None:
            mask |= topo.inst_comp == self.component
        if self.container is not None:
            if placement is None:
                raise ValueError(
                    "container-level events need the placement vector; pass "
                    "placement= to compile()"
                )
            mask |= np.asarray(placement) == self.container
        return mask


@dataclasses.dataclass(frozen=True)
class EventTrace:
    """Compiled dense view of a scenario: effective per-slot capacity rows."""

    mu_t: np.ndarray  # (T, I) f32 — effective processing capacity (0 where dead)
    gamma_t: np.ndarray  # (T, I) f32 — effective transmission capacity (0 where dead)
    alive_t: np.ndarray  # (T, I) f32 — 0/1 liveness
    name: str = "trace"

    def __post_init__(self):
        if not (self.mu_t.shape == self.gamma_t.shape == self.alive_t.shape):
            raise ValueError("mu_t, gamma_t, alive_t must share one (T, I) shape")

    @property
    def T(self) -> int:
        return self.mu_t.shape[0]

    @property
    def n_instances(self) -> int:
        return self.mu_t.shape[1]

    def prepared(self, T: int) -> "EventTrace":
        """Trace sized to exactly ``T`` slots: truncate, or extend by
        repeating the final row (the fleet holds its last state)."""
        if self.T == T:
            return self
        if self.T > T:
            return EventTrace(self.mu_t[:T], self.gamma_t[:T], self.alive_t[:T], self.name)
        pad = T - self.T
        return EventTrace(
            np.concatenate([self.mu_t, np.repeat(self.mu_t[-1:], pad, axis=0)]),
            np.concatenate([self.gamma_t, np.repeat(self.gamma_t[-1:], pad, axis=0)]),
            np.concatenate([self.alive_t, np.repeat(self.alive_t[-1:], pad, axis=0)]),
            self.name,
        )

    def is_identity(self, topo: Topology) -> bool:
        return bool(
            (self.alive_t == 1.0).all()
            and (self.mu_t == topo.inst_mu[None, :]).all()
            and (self.gamma_t == topo.inst_gamma[None, :]).all()
        )


@dataclasses.dataclass(frozen=True)
class FleetScenario:
    """Declarative event list; ``compile`` produces the dense tensors."""

    events: tuple[FleetEvent, ...] = ()
    name: str = "scenario"

    def compile(
        self, topo: Topology, T: int, placement: np.ndarray | None = None
    ) -> EventTrace:
        """Dense (T, I) tensors. Multiplicative events (straggler, throttle)
        compose; overlapping failure windows union. ``mu_t``/``gamma_t`` are
        *effective*: already zero wherever the instance is dead."""
        I = topo.n_instances
        alive = np.ones((T, I), np.float32)
        mu = np.broadcast_to(topo.inst_mu, (T, I)).astype(np.float32).copy()
        gamma = np.broadcast_to(topo.inst_gamma, (T, I)).astype(np.float32).copy()
        for ev in self.events:
            lo, hi = max(ev.start, 0), min(ev.end, T)
            if hi <= lo:
                continue
            mask = ev.target_mask(topo, placement)
            if ev.kind in ("failure", "scale_down", "outage"):
                alive[lo:hi, mask] = 0.0
            elif ev.kind == "straggler":
                mu[lo:hi, mask] *= ev.factor
            elif ev.kind == "throttle":
                gamma[lo:hi, mask] *= ev.factor
        return EventTrace(mu * alive, gamma * alive, alive, self.name)


def identity_trace(topo: Topology, T: int) -> EventTrace:
    """The no-op trace: all alive at base capacity, for all ``T`` slots."""
    return FleetScenario((), name="identity").compile(topo, T)


# ---------------------------------------------------------------------------
# canned scenario generators
# ---------------------------------------------------------------------------

def rolling_restart(
    topo: Topology,
    start: int,
    down_slots: int,
    stagger: int | None = None,
    instances: Sequence[int] | None = None,
) -> FleetScenario:
    """Restart every instance (or ``instances``) one after another: each is
    down for ``down_slots``, the next restart beginning ``stagger`` slots
    after the previous one started (default: back-to-back)."""
    stagger = down_slots if stagger is None else stagger
    ids = list(range(topo.n_instances)) if instances is None else list(instances)
    events = tuple(
        FleetEvent("failure", start + n * stagger, start + n * stagger + down_slots,
                   instances=(int(i),))
        for n, i in enumerate(ids)
    )
    return FleetScenario(events, name=f"rolling-restart-d{down_slots}")


def flash_straggler(
    topo: Topology,
    start: int,
    duration: int,
    factor: float = 0.25,
    instance: int | None = None,
    rng: np.random.Generator | None = None,
) -> FleetScenario:
    """One bolt instance suddenly serves at ``factor`` of its ``mu`` for
    ``duration`` slots (a GC pause / noisy neighbor), then recovers."""
    if instance is None:
        bolts = topo.bolt_instances
        rng = rng if rng is not None else np.random.default_rng(0)
        instance = int(rng.choice(bolts))
    ev = FleetEvent("straggler", start, start + duration, instances=(int(instance),),
                    factor=factor)
    return FleetScenario((ev,), name=f"flash-straggler-x{factor:g}")


def k_failures(
    topo: Topology,
    k: int,
    start: int,
    duration: int,
    rng: np.random.Generator | None = None,
    bolts_only: bool = True,
) -> FleetScenario:
    """``k`` simultaneous instance failures at ``start``, all recovering
    after ``duration`` slots (a rack power event at the instance level)."""
    rng = rng if rng is not None else np.random.default_rng(0)
    pool = topo.bolt_instances if bolts_only else np.arange(topo.n_instances)
    k = min(k, len(pool))
    picks = rng.choice(pool, size=k, replace=False)
    events = tuple(
        FleetEvent("failure", start, start + duration, instances=(int(i),)) for i in picks
    )
    return FleetScenario(events, name=f"k{k}-failure")


def diurnal_autoscale(
    topo: Topology,
    T: int,
    period: int = 100,
    min_alive_frac: float = 0.5,
    components: Sequence[int] | None = None,
) -> FleetScenario:
    """Autoscaling that tracks a diurnal load curve: in the low half of each
    ``period``, each bolt component keeps only ``ceil(min_alive_frac * P)``
    of its instances alive (always >= 1); the rest scale down and return."""
    comps = (
        [int(c) for c in components]
        if components is not None
        else [c for c in range(topo.n_components) if not topo.comp_is_spout[c]]
    )
    events: list[FleetEvent] = []
    for c in comps:
        inst = topo.instances_of(c)
        keep = max(int(np.ceil(min_alive_frac * len(inst))), 1)
        scaled = tuple(int(i) for i in inst[keep:])
        if not scaled:
            continue
        lo = 0
        while lo < T:
            trough = (lo + period // 2, min(lo + period, T))
            events.append(FleetEvent("scale_down", trough[0], trough[1], instances=scaled))
            lo += period
    return FleetScenario(tuple(events), name=f"diurnal-p{period}")


def random_chaos(
    topo: Topology,
    T: int,
    rng: np.random.Generator,
    n_events: int = 8,
    max_duration: int = 40,
    placement: np.ndarray | None = None,
) -> FleetScenario:
    """Seeded chaos-monkey mixture of every event kind (container outages
    included when ``placement`` is given). Reproducible from the generator
    state alone; used by the ``-m slow`` chaos property tests."""
    kinds = ["failure", "straggler", "throttle", "scale_down"]
    if placement is not None:
        kinds.append("outage")
    events = []
    for _ in range(n_events):
        kind = kinds[int(rng.integers(0, len(kinds)))]
        start = int(rng.integers(0, max(T - 2, 1)))
        dur = int(rng.integers(1, max_duration + 1))
        if kind == "outage":
            events.append(
                FleetEvent("outage", start, start + dur,
                           container=int(rng.integers(0, int(np.max(placement)) + 1)))
            )
            continue
        inst = (int(rng.integers(0, topo.n_instances)),)
        factor = float(rng.uniform(0.1, 0.9))
        events.append(FleetEvent(kind, start, start + dur, instances=inst, factor=factor))
    return FleetScenario(tuple(events), name="random-chaos")
