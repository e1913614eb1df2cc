"""Streaming-application model (paper §3.1-§3.2).

Applications are DAGs of *components* (spouts and bolts). Each component is
instantiated as ``parallelism`` independent *instances*; instances are packed
into *containers* hosted on *servers* (placement is computed separately, see
``core.placement``). All static structure is held in dense numpy arrays so the
simulators and the JAX scheduler can consume it directly.

Index conventions used across the whole package:
  c  : component id        in [0, C)
  i  : instance id          in [0, I)
  k  : container id         in [0, K)
  a  : application id       in [0, A)

A numpy copy of ``repro.core.topology``, kept in the port so that it imports nothing of the
JAX package; it must stay ``np.array_equal`` to the reference from the same seed
(``tests/test_torch_numpy_copies.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "Component",
    "Topology",
    "build_topology",
    "random_apps",
    "linear_app",
    "diamond_app",
]


@dataclasses.dataclass
class Component:
    """One vertex of an application DAG."""

    name: str
    app: int
    is_spout: bool
    parallelism: int
    proc_capacity: float = 4.0  # mu: tuples/slot each instance can process
    successors: tuple[int, ...] = ()  # component ids within the same app list
    selectivity: tuple[float, ...] = ()  # tuples emitted to each successor per processed tuple


@dataclasses.dataclass
class Topology:
    """Dense-array view of every application in the system."""

    n_components: int
    n_instances: int
    n_apps: int

    comp_app: np.ndarray  # (C,) int32
    comp_is_spout: np.ndarray  # (C,) bool
    comp_parallelism: np.ndarray  # (C,) int32
    adj: np.ndarray  # (C, C) bool — comp -> successor comp
    selectivity: np.ndarray  # (C, C) float32 — tuples to c' per tuple processed at c

    inst_comp: np.ndarray  # (I,) int32
    inst_mu: np.ndarray  # (I,) float32 — processing capacity (0 for spouts)
    inst_gamma: np.ndarray  # (I,) float32 — transmission capacity (eq. 1)

    comp_names: tuple[str, ...] = ()

    # ---- derived helpers -------------------------------------------------
    def instances_of(self, c: int) -> np.ndarray:
        return np.nonzero(self.inst_comp == c)[0]

    @property
    def spout_instances(self) -> np.ndarray:
        return np.nonzero(self.comp_is_spout[self.inst_comp])[0]

    @property
    def bolt_instances(self) -> np.ndarray:
        return np.nonzero(~self.comp_is_spout[self.inst_comp])[0]

    def successors_of_comp(self, c: int) -> np.ndarray:
        return np.nonzero(self.adj[c])[0]

    def predecessors_of_comp(self, c: int) -> np.ndarray:
        return np.nonzero(self.adj[:, c])[0]

    @property
    def terminal_components(self) -> np.ndarray:
        return np.nonzero(~self.adj.any(axis=1))[0]

    def edge_mask_instances(self) -> np.ndarray:
        """(I, I) bool — True where instance i may send tuples to i'."""
        return self.adj[np.ix_(self.inst_comp, self.inst_comp)]

    def max_out_instances(self) -> int:
        """Worst-case candidate-set size of Algorithm 1 (successor instances)."""
        out = 0
        for c in range(self.n_components):
            succ = self.successors_of_comp(c)
            out = max(out, int(self.comp_parallelism[succ].sum()))
        return out

    def expected_rates(self, stream_rates: np.ndarray) -> np.ndarray:
        """Propagate expected per-component *processed* tuple rates.

        ``stream_rates``: (I, C) — mean arrival rate per (spout instance,
        successor component) stream (λ in the paper). Spouts do not process;
        bolt inflow = direct spout streams + upstream processed × selectivity.
        Returns (C,) expected processed-tuple rate per component (0 for
        spouts).
        """
        C = self.n_components
        rates = np.zeros(C, dtype=np.float64)
        direct = stream_rates.sum(axis=0).astype(np.float64)
        order = topo_order(self.adj)
        for c in order:
            if self.comp_is_spout[c]:
                continue
            inflow = direct[c]
            for p in self.predecessors_of_comp(c):
                if not self.comp_is_spout[p]:
                    inflow += rates[p] * self.selectivity[p, c]
            rates[c] = inflow
        return rates


def topo_order(adj: np.ndarray) -> list[int]:
    n = adj.shape[0]
    indeg = adj.sum(axis=0).astype(int)
    stack = [c for c in range(n) if indeg[c] == 0]
    order: list[int] = []
    while stack:
        c = stack.pop()
        order.append(c)
        for c2 in np.nonzero(adj[c])[0]:
            indeg[c2] -= 1
            if indeg[c2] == 0:
                stack.append(int(c2))
    if len(order) != n:
        raise ValueError("application topology contains a cycle")
    return order


def build_topology(apps: Sequence[Sequence[Component]], gamma: float = 8.0) -> Topology:
    """Flatten per-app component lists into a :class:`Topology`.

    Each app is a list of Components whose ``successors`` refer to indices
    *within that app's list*; they are re-based onto global component ids.
    """
    comp_app, comp_is_spout, comp_par, names = [], [], [], []
    edges: list[tuple[int, int, float]] = []
    mu_per_comp: list[float] = []
    base = 0
    for a, comps in enumerate(apps):
        for ci, comp in enumerate(comps):
            comp_app.append(a)
            comp_is_spout.append(comp.is_spout)
            comp_par.append(comp.parallelism)
            mu_per_comp.append(comp.proc_capacity)
            names.append(f"app{a}/{comp.name}")
            sel = comp.selectivity or tuple(1.0 for _ in comp.successors)
            if len(sel) != len(comp.successors):
                raise ValueError("selectivity length must match successors")
            for s, f in zip(comp.successors, sel):
                edges.append((base + ci, base + s, f))
        base += len(comps)

    C = base
    adj = np.zeros((C, C), dtype=bool)
    selectivity = np.zeros((C, C), dtype=np.float32)
    for c, c2, f in edges:
        adj[c, c2] = True
        selectivity[c, c2] = f
    topo_order(adj)  # validates acyclicity

    inst_comp, inst_mu = [], []
    for c in range(C):
        for _ in range(comp_par[c]):
            inst_comp.append(c)
            inst_mu.append(0.0 if comp_is_spout[c] else mu_per_comp[c])
    I = len(inst_comp)

    return Topology(
        n_components=C,
        n_instances=I,
        n_apps=len(apps),
        comp_app=np.array(comp_app, dtype=np.int32),
        comp_is_spout=np.array(comp_is_spout, dtype=bool),
        comp_parallelism=np.array(comp_par, dtype=np.int32),
        adj=adj,
        selectivity=selectivity,
        inst_comp=np.array(inst_comp, dtype=np.int32),
        inst_mu=np.array(inst_mu, dtype=np.float32),
        inst_gamma=np.full((I,), gamma, dtype=np.float32),
        comp_names=tuple(names),
    )


# ---------------------------------------------------------------------------
# Canonical app generators (paper §5.1: 5 apps, depth 3-5, 3-6 components,
# per-instance capacity 3-5 tuples/slot).
# ---------------------------------------------------------------------------

def linear_app(depth: int, parallelism: int = 2, mu: float = 4.0) -> list[Component]:
    comps = []
    for d in range(depth):
        comps.append(
            Component(
                name=f"stage{d}",
                app=0,
                is_spout=(d == 0),
                parallelism=parallelism,
                proc_capacity=mu,
                successors=(d + 1,) if d + 1 < depth else (),
            )
        )
    return comps


def diamond_app(parallelism: int = 2, mu: float = 4.0) -> list[Component]:
    return [
        Component("src", 0, True, parallelism, mu, successors=(1, 2)),
        Component("left", 0, False, parallelism, mu, successors=(3,)),
        Component("right", 0, False, parallelism, mu, successors=(3,)),
        Component("sink", 0, False, parallelism, mu),
    ]


def random_apps(
    rng: np.random.Generator,
    n_apps: int = 5,
    depth_range: tuple[int, int] = (3, 5),
    comps_range: tuple[int, int] = (3, 6),
    parallelism_range: tuple[int, int] = (2, 4),
    mu_range: tuple[float, float] = (3.0, 5.0),
) -> list[list[Component]]:
    """Random layered DAGs matching the paper's simulation profile."""
    apps: list[list[Component]] = []
    for a in range(n_apps):
        depth = int(rng.integers(depth_range[0], depth_range[1] + 1))
        n_comp = int(rng.integers(max(comps_range[0], depth), comps_range[1] + 1))
        # distribute components over layers; layer 0 is the single spout.
        layer_of = [0] + sorted(int(rng.integers(1, depth)) for _ in range(n_comp - 2)) + [depth - 1]
        layer_of = layer_of[:n_comp]
        layers: dict[int, list[int]] = {}
        for ci, l in enumerate(layer_of):
            layers.setdefault(l, []).append(ci)
        comps = []
        for ci in range(n_comp):
            l = layer_of[ci]
            nxt_layer = min((l2 for l2 in layers if l2 > l), default=None)
            succ = tuple(layers[nxt_layer]) if nxt_layer is not None else ()
            # flow-conserving splits keep utilization uniform across depth
            # (a fan-out duplicates the stream; 1/n keeps total flow constant)
            sel = tuple(1.0 / len(succ) for _ in succ) if succ else ()
            comps.append(
                Component(
                    name=f"c{ci}",
                    app=a,
                    is_spout=(l == 0),
                    parallelism=int(rng.integers(parallelism_range[0], parallelism_range[1] + 1)),
                    proc_capacity=float(rng.integers(int(mu_range[0]), int(mu_range[1]) + 1)),
                    successors=succ,
                    selectivity=sel,
                )
            )
        apps.append(comps)
    return apps
