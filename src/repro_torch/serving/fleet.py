"""Replica fleet — R model replicas behind one POTUS dispatcher (DESIGN.md §10).

A numpy copy of ``repro.serving.fleet`` in the port; ``from_model`` builds
the port's :class:`~.engine.ServingEngine` replicas.

The serving bridge's fleet half: a :class:`ReplicaFleet` owns ``R`` replica
backends with heterogeneous capacity and shared continuous-batching slot
accounting, and exports per-replica ``backlog_tokens`` — the ``Q_in`` the
dispatcher prices (paper eq. 16). Backends come in two flavors:

* :class:`SimReplica` — token-accounting only: a per-slot **token budget**
  (``service_rate`` tokens/slot, the vLLM-style iteration budget) served
  oldest-request-first over at most ``max_batch`` in-flight requests. Exact
  fluid arithmetic, so a fleet of these is differentially testable against
  the in-graph cohort oracle (the cohort-fused engine with the token-length
  ``service`` axis) — the parity test in ``tests/test_torch_serving.py``.
* :class:`repro_torch.serving.engine.ServingEngine` — the real model-backed
  replica (KV cache, prefill/decode); same ``submit``/``step(rate)``/
  ``backlog_tokens``/``n_free_slots`` surface, built via
  :meth:`ReplicaFleet.from_model`.

Transit semantics match the simulators: requests dispatched at slot ``t``
land in the replica's queue at slot ``t+1`` (the engines' one-slot
``transit`` delay), so the dispatcher always observes the same ``Q_in`` the
in-graph engines would. Disruption traces (``core.events``) drive the fleet
through ``step(mu_row=, alive_row=)``: a dead replica serves nothing (its
backlog is stranded, never dropped — it re-drains on recovery) and a
straggler serves at the degraded ``mu_t`` rate.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["FleetRequest", "SimReplica", "ReplicaFleet"]


@dataclasses.dataclass
class FleetRequest:
    """One inference request in token-accounting units (a *tuple* whose
    service time is its token length — DESIGN.md §10)."""

    rid: int
    tokens: float  # total tokens of service the request needs
    submitted: int  # slot the request entered the system
    frontend: int = 0
    replica: int = -1
    served: float = 0.0  # tokens of service received so far
    finished: int = -1  # completion slot (-1 while in flight)

    @property
    def remaining(self) -> float:
        return self.tokens - self.served

    @property
    def done(self) -> bool:
        return self.finished >= 0


class SimReplica:
    """Token-accounting replica: continuous batching without the model.

    Per slot, up to ``max_batch`` requests are in flight (admitted
    oldest-first from the local queue as slots free), and a budget of
    ``service_rate`` tokens (or the slot's effective event rate) is served
    oldest-request-first across the in-flight set. With a non-binding
    ``max_batch`` the backlog follows exactly the fluid bolt dynamics
    ``q(t+1) = max(q(t) + landed - mu, 0)`` the in-graph engines integrate —
    the invariant the fleet-vs-fused differential test pins.
    """

    def __init__(self, service_rate: float, max_batch: int = 8):
        self.service_rate = float(service_rate)
        self.max_batch = int(max_batch)
        self.active: list[FleetRequest] = []  # in-flight, oldest first
        self.queue: list[FleetRequest] = []  # admitted, awaiting a slot
        self.tokens_served = 0.0

    # ---- dispatcher-facing metrics -------------------------------------
    @property
    def backlog_tokens(self) -> float:
        """Outstanding work in tokens (queued + in-flight remainders)."""
        return float(sum(r.remaining for r in self.queue) + sum(r.remaining for r in self.active))

    @property
    def n_free_slots(self) -> int:
        return self.max_batch - len(self.active)

    # ---- request lifecycle ----------------------------------------------
    def submit(self, req: FleetRequest) -> None:
        self.queue.append(req)

    def step(self, rate: float | None = None, t: int = 0) -> list[FleetRequest]:
        """Serve one slot at the effective ``rate``; returns requests that
        finish this slot (their ``finished`` stamped with ``t``)."""
        budget = self.service_rate if rate is None else float(rate)
        while self.queue and len(self.active) < self.max_batch:
            self.active.append(self.queue.pop(0))
        done: list[FleetRequest] = []
        for r in self.active:
            if budget <= 0.0:
                break
            take = min(budget, r.remaining)
            r.served += take
            budget -= take
            self.tokens_served += take
            if r.remaining <= 0.0:
                r.finished = t
                done.append(r)
        self.active = [r for r in self.active if not r.done]
        return done


class ReplicaFleet:
    """R replicas with shared slot accounting and one-slot dispatch transit.

    The fleet is policy-free: a dispatcher (``PotusDispatcher`` or any
    baseline) decides the (frontend, replica) assignment each slot, calls
    :meth:`dispatch`, then :meth:`step` advances every replica together.
    ``backlog_tokens`` deliberately *excludes* in-transit requests — it is
    the post-service queue state of the previous slot, exactly the ``Q_in``
    the in-graph engines observe before landing their ``transit`` buffer.
    """

    def __init__(self, replicas: list, recorder=None):
        self.replicas = list(replicas)
        R = len(self.replicas)
        self._inflight: list[list] = [[] for _ in range(R)]  # lands at next step()
        self._dispatched: list[list] = [[] for _ in range(R)]  # this slot's routing
        self.recorder = recorder  # obs.FlightRecorder — per-slot fleet rows (DESIGN.md §14)

    @classmethod
    def from_model(cls, cfg, model, service_rates, max_batch: int = 4,
                   max_len: int = 128) -> "ReplicaFleet":
        """Model-backed fleet: one :class:`ServingEngine` per rate, sharing
        one model (replicas serve the same weights; each has its own cache)."""
        from .engine import ServingEngine

        return cls([
            ServingEngine(cfg, model, max_batch=max_batch, max_len=max_len,
                          service_rate=float(r))
            for r in service_rates
        ])

    def __len__(self) -> int:
        return len(self.replicas)

    # ---- dispatcher-facing metrics -------------------------------------
    @property
    def backlog_tokens(self) -> np.ndarray:
        """(R,) — the Q_in vector, excluding in-transit requests."""
        return np.array([e.backlog_tokens for e in self.replicas], np.float64)

    @property
    def free_slots(self) -> np.ndarray:
        return np.array([e.n_free_slots for e in self.replicas], np.int64)

    @property
    def tokens_served(self) -> float:
        return float(sum(e.tokens_served for e in self.replicas))

    # ---- per-slot protocol ----------------------------------------------
    def dispatch(self, replica: int, req) -> None:
        """Route one request; it lands in the replica's queue next slot."""
        if hasattr(req, "replica"):
            req.replica = replica
        self._dispatched[replica].append(req)

    def step(self, t: int = 0, mu_row: np.ndarray | None = None,
             alive_row: np.ndarray | None = None) -> list:
        """Advance every replica one slot; returns this slot's completions.

        ``mu_row``/``alive_row`` are one slot of an ``EventTrace`` restricted
        to the replica instances (token units): the effective rate is
        ``mu_row * alive_row`` — zero for a dead replica, whose queued work
        holds in place until recovery (mass is conserved through outages,
        matching the engines' masking rule, DESIGN.md §9).
        """
        done: list = []
        for r, eng in enumerate(self.replicas):
            for req in self._inflight[r]:  # land last slot's transit
                eng.submit(req)
            self._inflight[r] = self._dispatched[r]
            self._dispatched[r] = []
            rate = eng.service_rate if mu_row is None else float(mu_row[r])
            if alive_row is not None:
                rate *= float(alive_row[r])
            done.extend(eng.step(rate=rate, t=t))  # both replica kinds take the slot
        if self.recorder is not None:
            backlogs = self.backlog_tokens
            self.recorder.record(
                slot=t,
                backlog_tokens=float(backlogs.sum()),
                backlog_max=float(backlogs.max()) if len(backlogs) else 0.0,
                inflight=sum(len(q) for q in self._inflight),
                completed=len(done),
                tokens_served=self.tokens_served,
            )
        return done
