"""Scheduling configuration and arrival preparation shared by the engines.

The port's counterpart of the parts of ``repro.core.simulator`` that the
fused cohort engine needs: :class:`SimConfig`, :func:`pad_arrivals` and
:func:`materialize_arrivals`. The plain scan engine (``engine="jax"``) is not
ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .topology import Topology

__all__ = ["SimConfig", "pad_arrivals", "materialize_arrivals"]


@dataclasses.dataclass
class SimConfig:
    V: float = 3.0
    beta: float = 1.0
    window: int = 0
    scheduler: str = "potus"  # potus | potus-loop | shuffle | jsq
    use_pallas: bool = False
    sharded: bool = False


def pad_arrivals(arrivals: np.ndarray, n: int) -> np.ndarray:
    """Zero-pad the arrival tensor to at least ``n`` slots; longer inputs are
    returned unchanged (callers slice the range they need)."""
    if arrivals.shape[0] >= n:
        return arrivals
    pad = np.zeros((n - arrivals.shape[0],) + arrivals.shape[1:], arrivals.dtype)
    return np.concatenate([arrivals, pad], axis=0)


def materialize_arrivals(arrivals, topo: Topology, n_slots: int) -> np.ndarray:
    """Resolve an ``ArrivalSpec`` into a concrete ``(n_slots, I, C)`` tensor;
    arrays pass through unchanged (DESIGN.md §11)."""
    from .workload import ArrivalSpec

    if isinstance(arrivals, ArrivalSpec):
        return arrivals.generate(topo, n_slots)
    return np.asarray(arrivals)
