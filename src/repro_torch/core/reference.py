"""Pure-Python exact oracle for Algorithm 1 (and the per-slot LP (15)).

The port's numpy copy of ``repro.core.reference``: the test oracle for the
port's batched schedulers, in f64 with exact integer semantics, and a
brute-force solver of problem (15) for tiny instances, to verify that the
greedy is optimal. It imports only numpy.
"""
from __future__ import annotations

import itertools

import numpy as np

__all__ = ["potus_schedule_reference", "solve_lp_bruteforce", "prices_reference"]


def prices_reference(edge_mask, inst_comp, inst_container, U, q_in, q_out, V, beta):
    I = len(inst_comp)
    l = np.full((I, I), np.inf, dtype=np.float64)
    for i in range(I):
        for j in range(I):
            if edge_mask[i, j]:
                l[i, j] = (V * U[inst_container[i], inst_container[j]] + q_in[j]
                           - beta * q_out[i, inst_comp[j]])
    return l


def potus_schedule_reference(
    edge_mask: np.ndarray,  # (I, I) bool
    inst_comp: np.ndarray,  # (I,)
    inst_container: np.ndarray,  # (I,)
    comp_count: np.ndarray,  # (C,)
    gamma: np.ndarray,  # (I,)
    U: np.ndarray,  # (K, K)
    q_in: np.ndarray,  # (I,)
    q_out: np.ndarray,  # (I, C)
    must_send: np.ndarray,  # (I, C)
    V: float,
    beta: float,
) -> np.ndarray:
    """Exact Algorithm 1. Ties broken toward the lowest instance index,
    matching ``torch.argmin`` in the batched version."""
    I = len(inst_comp)
    l = prices_reference(edge_mask, inst_comp, inst_container, U, q_in, q_out, V, beta)
    X = np.zeros((I, I), dtype=np.float64)

    for i in range(I):
        budget = q_out[i].astype(np.float64).copy()
        used = 0.0
        cand = [j for j in range(I) if edge_mask[i, j] and l[i, j] < 0.0]
        # greedy water-fill (lines 9-14)
        while used < gamma[i] - 1e-12 and cand:
            j = min(cand, key=lambda j: (l[i, j], j))
            cj = inst_comp[j]
            alloc = max(min(gamma[i] - used, budget[cj]), 0.0)
            X[i, j] += alloc
            budget[cj] -= alloc
            used += alloc
            cand.remove(j)
        # mandatory dispatch of actual arrivals (line 5-6 / eq. 4)
        for c in range(q_out.shape[1]):
            if must_send[i, c] <= 0:
                continue
            shipped = sum(X[i, j] for j in range(I) if edge_mask[i, j] and inst_comp[j] == c)
            short = must_send[i, c] - shipped
            if short > 1e-12:
                targets = [j for j in range(I) if edge_mask[i, j] and inst_comp[j] == c]
                for j in targets:
                    X[i, j] += short / len(targets)
    return X


def solve_lp_bruteforce(
    edge_mask, inst_comp, gamma, q_out, l, max_units: int = 6
) -> tuple[float, np.ndarray]:
    """Exhaustive integer search of problem (15) for one source instance set.

    Only for tiny instances (tests). Returns (objective, X)."""
    I = len(inst_comp)
    best_obj, best_X = 0.0, np.zeros((I, I))
    for i in range(I):
        succ = [j for j in range(I) if edge_mask[i, j]]
        if not succ:
            continue
        best_i, best_alloc = 0.0, None
        ranges = [range(0, max_units + 1) for _ in succ]
        for alloc in itertools.product(*ranges):
            if sum(alloc) > gamma[i]:
                continue
            per_comp: dict[int, float] = {}
            for j, a in zip(succ, alloc):
                per_comp[inst_comp[j]] = per_comp.get(inst_comp[j], 0) + a
            if any(v > q_out[i, c] + 1e-9 for c, v in per_comp.items()):
                continue
            obj = sum(l[i, j] * a for j, a in zip(succ, alloc))
            if obj < best_i - 1e-12:
                best_i, best_alloc = obj, alloc
        if best_alloc is not None:
            for j, a in zip(succ, best_alloc):
                best_X[i, j] = a
        best_obj += best_i
    return best_obj, best_X
