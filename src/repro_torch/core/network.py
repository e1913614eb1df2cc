"""Cluster network model — per-tuple communication costs U[k,k'] (paper §3.5).

The paper evaluates on Jellyfish and Fat-Tree fabrics with 24 switches and 16
servers (§5.1). We reproduce both: ``U[k,k']`` is the number of links a tuple
traverses from container ``k`` to container ``k'`` (0 intra-container, 1
between containers on the same server, else 2 + switch-graph shortest path).

``U`` may be refreshed per time slot (the paper assumes U(t) is known a priori
at decision time); ``congestion_scale`` provides that hook.

A numpy copy of ``repro.core.network``, kept in the port so that it imports nothing of the
JAX package; it must stay ``np.array_equal`` to the reference from the same seed
(``tests/test_torch_numpy_copies.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["NetworkCosts", "jellyfish", "fat_tree", "container_costs"]


@dataclasses.dataclass
class NetworkCosts:
    name: str
    n_servers: int
    n_containers: int
    server_dist: np.ndarray  # (S, S) float32 — link hops between servers
    container_server: np.ndarray  # (K,) int32
    U: np.ndarray  # (K, K) float32 — per-tuple cost between containers

    def scaled(self, factor: np.ndarray | float) -> np.ndarray:
        """Per-slot cost matrix U(t) (paper allows time variation)."""
        return (self.U * factor).astype(np.float32)


def _bfs_all_pairs(adj: np.ndarray) -> np.ndarray:
    n = adj.shape[0]
    dist = np.full((n, n), np.inf)
    for s in range(n):
        dist[s, s] = 0
        frontier = [s]
        d = 0
        while frontier:
            d += 1
            nxt = []
            for u in frontier:
                for v in np.nonzero(adj[u])[0]:
                    if dist[s, v] == np.inf:
                        dist[s, v] = d
                        nxt.append(int(v))
            frontier = nxt
    if np.isinf(dist).any():
        raise ValueError("switch graph is disconnected")
    return dist


def jellyfish(
    rng: np.random.Generator,
    n_switches: int = 24,
    n_servers: int = 16,
    switch_degree: int = 4,
) -> tuple[np.ndarray, np.ndarray]:
    """Jellyfish: random regular graph among switches [44]; servers attached
    round-robin. Returns (server_dist, switch_of_server)."""
    # random regular-ish graph by repeated edge swaps of a ring + random chords
    adj = np.zeros((n_switches, n_switches), dtype=bool)
    deg = np.zeros(n_switches, dtype=int)
    # start from a ring for connectivity
    for u in range(n_switches):
        v = (u + 1) % n_switches
        adj[u, v] = adj[v, u] = True
    deg += 2
    # add random edges until degrees reach switch_degree
    attempts = 0
    while (deg < switch_degree).any() and attempts < 10_000:
        attempts += 1
        cand = np.nonzero(deg < switch_degree)[0]
        if len(cand) < 2:
            break
        u, v = rng.choice(cand, size=2, replace=False)
        if not adj[u, v]:
            adj[u, v] = adj[v, u] = True
            deg[u] += 1
            deg[v] += 1
    sw_dist = _bfs_all_pairs(adj)
    switch_of_server = np.arange(n_servers) % n_switches
    server_dist = sw_dist[np.ix_(switch_of_server, switch_of_server)] + 2.0
    np.fill_diagonal(server_dist, 0.0)
    # same-switch servers: up + down through one switch
    same_switch = switch_of_server[:, None] == switch_of_server[None, :]
    server_dist = np.where(same_switch & (server_dist > 0), 2.0, server_dist)
    return server_dist.astype(np.float32), switch_of_server


def fat_tree(k: int = 4) -> tuple[np.ndarray, np.ndarray]:
    """Canonical k-ary fat-tree [45]; k=4 gives 16 servers, 20 switches.

    (The paper quotes 24 switches / 16 servers; a k=4 fat-tree hosting 16
    servers has 20 switches — we keep the canonical construction and note the
    delta in DESIGN.md.)
    """
    n_pods = k
    n_core = (k // 2) ** 2
    n_agg = n_pods * (k // 2)
    n_edge = n_pods * (k // 2)
    n_sw = n_core + n_agg + n_edge
    adj = np.zeros((n_sw, n_sw), dtype=bool)

    def core(i):
        return i

    def agg(p, i):
        return n_core + p * (k // 2) + i

    def edge(p, i):
        return n_core + n_agg + p * (k // 2) + i

    for p in range(n_pods):
        for a in range(k // 2):
            for e in range(k // 2):
                adj[agg(p, a), edge(p, e)] = adj[edge(p, e), agg(p, a)] = True
            for c in range(k // 2):
                cid = core(a * (k // 2) + c)
                adj[agg(p, a), cid] = adj[cid, agg(p, a)] = True

    sw_dist = _bfs_all_pairs(adj)
    n_servers = n_pods * (k // 2) * (k // 2)
    switch_of_server = np.repeat(
        [edge(p, e) for p in range(n_pods) for e in range(k // 2)], k // 2
    )[:n_servers]
    server_dist = sw_dist[np.ix_(switch_of_server, switch_of_server)] + 2.0
    np.fill_diagonal(server_dist, 0.0)
    same = switch_of_server[:, None] == switch_of_server[None, :]
    server_dist = np.where(same & (server_dist > 0), 2.0, server_dist)
    return server_dist.astype(np.float32), switch_of_server


def container_costs(
    name: str,
    server_dist: np.ndarray,
    containers_per_server: int = 2,
    intra_server_cost: float = 1.0,
) -> NetworkCosts:
    """Expand server distances into the container-level cost matrix U."""
    S = server_dist.shape[0]
    K = S * containers_per_server
    container_server = np.repeat(np.arange(S), containers_per_server).astype(np.int32)
    U = server_dist[np.ix_(container_server, container_server)].astype(np.float32)
    same_server = container_server[:, None] == container_server[None, :]
    U = np.where(same_server, intra_server_cost, U)
    np.fill_diagonal(U, 0.0)
    return NetworkCosts(
        name=name,
        n_servers=S,
        n_containers=K,
        server_dist=server_dist.astype(np.float32),
        container_server=container_server,
        U=U.astype(np.float32),
    )
