"""POTUS request dispatcher — the paper's system translated to an LM fleet —
the port's counterpart of ``repro.serving.dispatcher``.

Mapping (DESIGN.md §10): inference requests are *tuples*; model replicas are
*instances* of one "serve" component; hosts are *containers*; ``U[k,k']`` is
the inter-host transfer cost; per-replica outstanding work is ``Q_in``; the
frontends' pending-request buffers are the spout output queues, whose
lookahead window holds *predicted* future requests.

Each scheduling slot the dispatcher runs Algorithm 1 — the port's
``core.potus.potus_schedule`` (or a baseline from ``core.baselines`` via
``cfg.scheduler``), with the ``SchedProblem`` and the cost matrix built once
on ``device`` at construction. On the card, ``scheduler="potus"`` runs the
hand-written fused schedule kernel (``potus_schedule``) once per slot; the
slot's X comes back to the host in one copy.

Window/backlog bookkeeping mirrors ``core.cohort_fused._fused_step`` slot
for slot — observe → schedule → drain (window ascending, then pending) →
carry unshipped actuals as admission backlog → shift — which is what makes
the fleet-vs-fused differential test possible: the dispatcher IS the fused
engine's spout, run on the host. Disruption traces enter through
``route(events_row=...)``: one ``(mu, gamma, alive)`` slot of an
``EventTrace`` compiled on ``self.topo`` becomes a ``SlotCaps``.

Observability (DESIGN.md §14): ``recorder=`` (an ``obs.FlightRecorder``)
takes one row per ``route()`` — slot, h, shipped, pending, window,
comm_cost_total — and the scheduler call runs under the span
``potus/serving/scheduler-call`` (``repro_torch.obs.trace``, off by
default).

``DispatcherConfig(sharded=True)`` (the reference's instance-sharded route)
is not ported yet and raises.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.network import NetworkCosts
from ..core.potus import caps_for_slot, make_problem
from ..core.simulator import _get_scheduler
from ..core.topology import Component, build_topology
from ..device import resolve_device
from ..obs.trace import span as obs_span

__all__ = ["DispatcherConfig", "PotusDispatcher", "integral_assign"]

#: the span name of the per-slot scheduler call, as in the reference's trace
SCHED_SPAN = "potus/serving/scheduler-call"


@dataclasses.dataclass
class DispatcherConfig:
    V: float = 1.0
    beta: float = 1.0
    window: int = 0  # lookahead slots (predictive pre-admission)
    gamma: float = 64.0  # max requests a frontend ships per slot
    tokens_per_request: float = 1.0  # Q_in normalization: backlog tokens per request
    scheduler: str = "potus"  # "potus" | "potus-loop" | "shuffle" | "jsq"
    sharded: bool = False  # not ported yet: raises


def integral_assign(assign: np.ndarray, rng: np.random.Generator | None = None) -> np.ndarray:
    """Round a fluid (F, R) assignment to integer request counts.

    Largest-remainder rounding per frontend row: row totals round to the
    nearest integer, entries keep their floors, and the leftover units go to
    the largest fractional parts (ties → lowest replica index). With ``rng``,
    leftover units are instead *sampled* proportionally to the fractional
    parts (without replacement), so an exact tie (shuffle's even split) does
    not collapse onto the lowest-index replicas every slot.
    """
    assign = np.asarray(assign, np.float64)
    out = np.floor(assign).astype(np.int64)
    for f in range(assign.shape[0]):
        short = int(np.rint(assign[f].sum())) - int(out[f].sum())
        if short <= 0:
            continue
        frac = assign[f] - out[f]
        pos = np.nonzero(frac > 1e-12)[0]
        if rng is not None and len(pos) >= short:
            picks = rng.choice(pos, size=short, replace=False,
                               p=frac[pos] / frac[pos].sum())
            out[f, picks] += 1
        else:
            order = np.lexsort((np.arange(len(frac)), -frac))
            out[f, order[:short]] += 1
    return out


class PotusDispatcher:
    def __init__(
        self,
        n_frontends: int,
        replica_hosts: np.ndarray,  # (R,) host id per replica
        frontend_hosts: np.ndarray,  # (F,) host id per frontend
        host_costs: np.ndarray,  # (n_hosts, n_hosts) per-request transfer cost
        replica_rates: np.ndarray,  # (R,) service capacity, in Q_in units/slot
        cfg: DispatcherConfig = DispatcherConfig(),
        recorder=None,  # obs.FlightRecorder — per-slot routing rows (DESIGN.md §14)
        device="cuda",
    ):
        if cfg.sharded:
            raise NotImplementedError(
                "DispatcherConfig(sharded=True) is not ported yet (ROADMAP.md, section 1, "
                "module item 5); route on one device")
        R = len(replica_hosts)
        F = n_frontends
        self.cfg = cfg
        self.device = resolve_device(device)
        app = [
            Component("frontend", 0, True, parallelism=F, successors=(1,)),
            Component("serve", 0, False, parallelism=R,
                      proc_capacity=float(np.mean(replica_rates))),
        ]
        self.topo = build_topology([app], gamma=cfg.gamma)
        # true heterogeneous capacities, so event scenarios compiled on this
        # topology (core.events generators scale inst_mu) see the real rates
        self.topo.inst_mu[F:] = np.asarray(replica_rates, np.float32)
        self.mu = self.topo.inst_mu
        placement = np.concatenate([frontend_hosts, replica_hosts]).astype(np.int32)
        K = int(host_costs.shape[0])
        self.net = NetworkCosts(
            name="serving-fleet",
            n_servers=K,
            n_containers=K,
            server_dist=np.asarray(host_costs, np.float32),
            container_server=np.arange(K, dtype=np.int32),
            U=np.asarray(host_costs, np.float32),
        )
        # built once on the device; every route() reuses the problem and U
        self.prob = make_problem(self.topo, self.net, placement, self.device)
        self._U = torch.as_tensor(self.net.U, dtype=torch.float32, device=self.device)
        self._sched = _get_scheduler(cfg.scheduler)
        self.F, self.R = F, R
        # lookahead window per frontend: predicted request counts per slot
        self.window = np.zeros((F, cfg.window + 1), np.float32)
        # admission backlog: actual arrivals not yet shipped (gamma-bound
        # slots, dead frontends, no-alive-replica slots); never dropped
        self.pending = np.zeros(F, np.float32)
        self.comm_cost_total = 0.0
        self.h_last = 0.0  # drift backlog h(t) = sum Q_in + beta * sum Q_out
        self.h_history: list[float] = []
        self._u_pair = self.net.U[np.ix_(placement, placement)]
        self.recorder = recorder

    def observe_prediction(self, predicted: np.ndarray) -> None:
        """predicted: (F, window+1) request counts for slots t..t+W."""
        self.window = np.asarray(predicted, np.float32).reshape(self.F, -1)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def route(
        self,
        arrivals: np.ndarray,
        replica_backlogs: np.ndarray,
        events_row: tuple | None = None,
    ) -> np.ndarray:
        """One slot of Algorithm 1.

        arrivals: (F,) new requests at each frontend this slot;
        replica_backlogs: (R,) outstanding work per replica, in
        ``tokens_per_request`` units (e.g. ``ReplicaFleet.backlog_tokens``);
        events_row: optional ``(mu, gamma, alive)`` triple of (I,) arrays —
        one slot of an ``EventTrace`` compiled on ``self.topo``.

        Returns the fluid (F, R) assignment (request counts; see
        :func:`integral_assign` for integer routing) and updates the window,
        admission backlog, and h(t) diagnostics, in the reference's order.
        """
        I, C = self.topo.n_instances, self.topo.n_components
        self.window[:, 0] += np.asarray(arrivals, np.float32)

        q_in = np.zeros(I, np.float32)
        q_in[self.F:] = np.asarray(replica_backlogs, np.float32) / self.cfg.tokens_per_request
        q_out = np.zeros((I, C), np.float32)
        q_out[: self.F, 1] = self.window.sum(axis=1)
        must = np.zeros((I, C), np.float32)
        must[: self.F, 1] = self.window[:, 0] + self.pending

        caps = None
        if events_row is not None:
            caps = caps_for_slot(*(self._tensor(a) for a in events_row))
        with obs_span(SCHED_SPAN, sharded=False):
            X = self._sched(self.prob, self._U, self._tensor(q_in), self._tensor(q_out),
                            self._tensor(must), float(self.cfg.V), float(self.cfg.beta),
                            caps=caps).cpu().numpy()
        self.h_last = float(q_in.sum() + self.cfg.beta * q_out.sum())
        self.h_history.append(self.h_last)
        self.comm_cost_total += float((X * self._u_pair).sum())
        assign = X[: self.F, self.F:]  # (F, R) fluid request counts
        # drain window ascending, then pending (the fused engine's spout
        # drain buffer order: lookahead buckets first, admission trailing)
        shipped = assign.sum(axis=1)
        for f in range(self.F):
            rem = shipped[f]
            for w in range(self.window.shape[1]):
                take = min(rem, self.window[f, w])
                self.window[f, w] -= take
                rem -= take
            take = min(rem, self.pending[f])
            self.pending[f] -= take
        # carry unshipped actuals; shift the window (next prediction -> pos 0)
        self.pending += self.window[:, 0]
        self.window[:, :-1] = self.window[:, 1:]
        self.window[:, -1] = 0.0
        if self.recorder is not None:
            self.recorder.record(
                slot=len(self.h_history) - 1,
                h=self.h_last,
                shipped=float(assign.sum()),
                pending=float(self.pending.sum()),
                window=float(self.window.sum()),
                comm_cost_total=self.comm_cost_total,
            )
        return assign
