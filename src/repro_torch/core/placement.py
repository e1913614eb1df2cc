"""T-Heron instance placement (paper §5.1, adapted from T-Storm [15]).

Given a topology and expected per-stream spout rates, sort instances by their
expected (incoming + outgoing) tuple traffic in descending order, then
greedily assign each to the container that minimizes the *incremental
cross-container traffic*, subject to a per-container instance cap.

A numpy copy of ``repro.core.placement``, kept in the port so that it imports nothing of the
JAX package; it must stay ``np.array_equal`` to the reference from the same seed
(``tests/test_torch_numpy_copies.py``).
"""
from __future__ import annotations

import numpy as np

from .network import NetworkCosts
from .topology import Topology

__all__ = ["t_heron_placement", "instance_traffic", "random_placement"]


def _rate_matrices(topo: Topology, stream_rates: np.ndarray):
    """comp_proc: (C,) processed rate; flow: (C, C) tuple rate on comp edge."""
    comp_proc = topo.expected_rates(stream_rates)  # bolts only
    C = topo.n_components
    flow = np.zeros((C, C), dtype=np.float64)
    # spout streams go directly to their target component
    spout_to = np.zeros((C, C))
    for i in range(topo.n_instances):
        c = int(topo.inst_comp[i])
        if topo.comp_is_spout[c]:
            spout_to[c] += stream_rates[i]
    for c in range(C):
        if topo.comp_is_spout[c]:
            flow[c] = spout_to[c]
        else:
            flow[c] = comp_proc[c] * topo.selectivity[c]
    return comp_proc, flow


def instance_traffic(topo: Topology, stream_rates: np.ndarray) -> np.ndarray:
    """(I,) expected in+out tuple rate per instance (uniform split within a
    component, which holds in steady state under both Shuffle and POTUS)."""
    _, flow = _rate_matrices(topo, stream_rates)
    comp_in = flow.sum(axis=0)
    comp_out = flow.sum(axis=1)
    per_inst = (comp_in + comp_out)[topo.inst_comp] / np.maximum(
        topo.comp_parallelism[topo.inst_comp], 1
    )
    return per_inst.astype(np.float32)


def t_heron_placement(
    topo: Topology,
    net: NetworkCosts,
    stream_rates: np.ndarray,
    max_per_container: int | None = None,
) -> np.ndarray:
    """Return (I,) container assignment."""
    I, K = topo.n_instances, net.n_containers
    if max_per_container is None:
        max_per_container = int(np.ceil(I / K)) + 1

    traffic = instance_traffic(topo, stream_rates)
    _, flow = _rate_matrices(topo, stream_rates)
    # expected instance-pair rate: edge flow split uniformly over pairs
    par = np.maximum(topo.comp_parallelism.astype(np.float64), 1)
    pair_flow = flow / (par[:, None] * par[None, :])  # (C, C)

    order = np.argsort(-traffic, kind="stable")
    assign = np.full(I, -1, dtype=np.int32)
    load = np.zeros(K, dtype=np.int32)
    placed: list[int] = []

    for i in order:
        ci = int(topo.inst_comp[i])
        best_k, best_cost = -1, np.inf
        for k in range(K):
            if load[k] >= max_per_container:
                continue
            inc = 0.0
            for j in placed:
                cj = int(topo.inst_comp[j])
                r = pair_flow[ci, cj] + pair_flow[cj, ci]
                if r > 0.0:
                    inc += r * net.U[k, assign[j]]
            if inc < best_cost - 1e-12:
                best_cost, best_k = inc, k
        if best_k < 0:
            raise ValueError("no container has remaining capacity")
        assign[i] = best_k
        load[best_k] += 1
        placed.append(int(i))
    return assign


def random_placement(rng: np.random.Generator, topo: Topology, net: NetworkCosts) -> np.ndarray:
    return rng.integers(0, net.n_containers, size=topo.n_instances).astype(np.int32)
