"""Named per-slot metric streams computed inside the engines' slot loops —
the port's counterpart of ``repro.obs.metrics`` (DESIGN.md §14).

A :class:`MetricsSpec` selects streams by name; each selected stream becomes
one extra per-slot output of the engine (a ``(width,)`` row per slot,
stacked to ``(T, width)``). With ``metrics=None`` an engine runs exactly the
code it ran before the streams existed, so the trajectories are bitwise
those of a run without them; the streams only read the slot's quantities.

Stream semantics (all per scheduling slot, after the slot's dispatch):

==============  =====  ========================================================
name            width  columns
==============  =====  ========================================================
backlog         1      ``h`` — drift backlog h(t) = sum Q_in + beta * sum Q_out
queue_depth     3      ``p50, p95, max`` of the per-instance input queues
price           2      ``spread`` (max-min) and ``min_gap`` (runner-up minus
                       cheapest) of the per-instance price V*u_mean + Q_in
dispatch        2      ``imbalance`` (max/mean of landed mass; 0 when idle)
                       and ``entropy`` (Shannon, normalized by log I)
transit         1      ``occupancy`` — total mass in flight in transit buffers
backlog_comp    C      per-component sum of input queues (runtime width)
held            2      ``held`` (admission backlog carried) and ``dropped``
                       (mispredicted mass retired by reconciliation)
window          3      ``tp, fp, tn`` prediction-reconciliation counts
saturation      2      ``capped, served`` — age-cap boundary mass vs total
payload         1      ``floats`` — per-slot cross-device collective payload
                       (host-side constant; 0 off-mesh)
==============  =====  ========================================================

The tables, :class:`MetricsSpec`, :class:`MetricsFrame` (the ``repro-obs/v1``
JSON) and the numpy host twins are copies of the reference's; the in-slot
streams (:func:`compute_scan_streams`) are torch functions of the slot's
tensors, f32 on the run's device. This module imports nothing of
``repro_torch.core``: the engines import it.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch

__all__ = [
    "STREAMS",
    "DEFAULT_STREAMS",
    "ENGINE_STREAMS",
    "MetricsSpec",
    "MetricsFrame",
    "build_frame",
    "compute_scan_streams",
    "scan_stream_names",
    "unsupported_streams",
]

OBS_JSON_SCHEMA = "repro-obs/v1"

# name -> static column labels (backlog_comp is runtime-width: one column per
# component, labeled at frame-build time)
STREAMS: dict[str, tuple[str, ...]] = {
    "backlog": ("h",),
    "queue_depth": ("p50", "p95", "max"),
    "price": ("spread", "min_gap"),
    "dispatch": ("imbalance", "entropy"),
    "transit": ("occupancy",),
    "backlog_comp": (),  # runtime width C
    "held": ("held", "dropped"),
    "window": ("tp", "fp", "tn"),
    "saturation": ("capped", "served"),
    "payload": ("floats",),
}

# streams every engine can serve; MetricsSpec.coerce(True) selects these
DEFAULT_STREAMS: tuple[str, ...] = (
    "backlog", "queue_depth", "price", "dispatch", "transit",
    "backlog_comp", "payload",
)

# which engines can compute each stream (engine names match
# repro_torch.core.engine.ENGINES; kept as data so obs never imports core)
ENGINE_STREAMS: dict[str, frozenset[str]] = {
    "jax": frozenset(DEFAULT_STREAMS),
    "sharded": frozenset(DEFAULT_STREAMS),
    "cohort": frozenset(DEFAULT_STREAMS) | {"held", "window"},
    "cohort-fused": frozenset(DEFAULT_STREAMS) | {"held", "window", "saturation"},
}


@dataclasses.dataclass(frozen=True)
class MetricsSpec:
    """Frozen, hashable selection of metric streams."""

    streams: tuple[str, ...] = DEFAULT_STREAMS

    def __post_init__(self):
        unknown = [s for s in self.streams if s not in STREAMS]
        if unknown:
            raise ValueError(
                f"unknown metric stream(s) {unknown}; known: {sorted(STREAMS)}")
        if len(set(self.streams)) != len(self.streams):
            raise ValueError(f"duplicate metric streams in {self.streams}")

    @classmethod
    def coerce(cls, metrics: Any) -> "MetricsSpec | None":
        """Normalize ``EngineSpec(metrics=...)`` input.

        Accepts None (off), an existing spec, ``True`` (the every-engine
        :data:`DEFAULT_STREAMS`), a single stream name, or an iterable of
        stream names.
        """
        if metrics is None:
            return None
        if isinstance(metrics, cls):
            return metrics
        if metrics is True:
            return cls()
        if isinstance(metrics, str):
            return cls(streams=(metrics,))
        if isinstance(metrics, Iterable):
            return cls(streams=tuple(metrics))
        raise TypeError(
            f"metrics must be None, True, a MetricsSpec, a stream name, or an "
            f"iterable of stream names; got {type(metrics).__name__}")


def unsupported_streams(engine: str, spec: MetricsSpec) -> tuple[str, ...]:
    """Streams in ``spec`` the named engine cannot compute."""
    ok = ENGINE_STREAMS.get(engine, frozenset())
    return tuple(s for s in spec.streams if s not in ok)


def stream_engines(name: str) -> tuple[str, ...]:
    """Engines that support stream ``name`` (for error messages)."""
    return tuple(sorted(e for e, ok in ENGINE_STREAMS.items() if name in ok))


def scan_stream_names(spec: MetricsSpec) -> tuple[str, ...]:
    """Streams computed inside the slot loop (``payload`` is a host-side
    constant)."""
    return tuple(n for n in spec.streams if n != "payload")


def _rank_index(p: float, n: int) -> int:
    # nearest-rank quantile index (no interpolation -> shard-count invariant)
    return min(n - 1, max(0, math.ceil(p * n) - 1))


def _queue_depth(ctx: Mapping[str, Any]) -> torch.Tensor:
    q = torch.sort(ctx["q_in"]).values
    n = int(q.shape[0])
    return torch.stack([q[_rank_index(0.5, n)], q[_rank_index(0.95, n)], q[-1]])


def _price(ctx: Mapping[str, Any]) -> torch.Tensor:
    p = torch.sort(ctx["price"]).values
    gap = p[1] - p[0] if p.shape[0] > 1 else torch.zeros((), dtype=p.dtype, device=p.device)
    return torch.stack([p[-1] - p[0], gap])


def _dispatch(ctx: Mapping[str, Any]) -> torch.Tensor:
    landed = ctx["landed"]
    n = int(landed.shape[0])
    total = landed.sum()
    safe = torch.where(total > 0, total, 1.0)
    imbalance = torch.where(total > 0, landed.max() * n / safe, 0.0)
    frac = landed / safe
    h = -torch.where(frac > 0, frac * torch.log(frac), 0.0).sum()
    entropy = torch.where(total > 0, h / math.log(n) if n > 1 else 0.0, 0.0)
    return torch.stack([imbalance, entropy])


_COMPUTERS: dict[str, Callable[[Mapping[str, Any]], torch.Tensor]] = {
    "backlog": lambda ctx: torch.reshape(ctx["h"], (1,)),
    "queue_depth": _queue_depth,
    "price": _price,
    "dispatch": _dispatch,
    "transit": lambda ctx: torch.reshape(ctx["transit_total"], (1,)),
    "backlog_comp": lambda ctx: ctx["comp_backlog"],
    "held": lambda ctx: torch.stack([ctx["held"], ctx["dropped"]]),
    "window": lambda ctx: torch.stack([ctx["tp"], ctx["fp"], ctx["tn"]]),
    "saturation": lambda ctx: torch.stack([ctx["capped"], ctx["served"]]),
}


def compute_scan_streams(
    names: tuple[str, ...], ctx: Mapping[str, Any]
) -> tuple[torch.Tensor, ...]:
    """One ``(width,)`` row per selected in-slot stream, in spec order.

    ``ctx`` carries the slot's raw quantities as tensors on the run's device
    (``h``, ``q_in``, ``price``, ``landed``, ``transit_total``,
    ``comp_backlog``, and — where the engine supports them —
    ``held``/``dropped``, ``tp``/``fp``/``tn``, ``capped``/``served``).
    Every row is float32, as in the engines.
    """
    return tuple(_COMPUTERS[n](ctx).to(torch.float32) for n in names)


def _np_queue_depth(ctx):
    q = np.sort(np.asarray(ctx["q_in"], np.float32))
    n = q.shape[0]
    return np.array([q[_rank_index(0.5, n)], q[_rank_index(0.95, n)], q[-1]])


def _np_price(ctx):
    p = np.sort(np.asarray(ctx["price"], np.float32))
    gap = p[1] - p[0] if p.shape[0] > 1 else 0.0
    return np.array([p[-1] - p[0], gap])


def _np_dispatch(ctx):
    landed = np.asarray(ctx["landed"], np.float32)
    n = landed.shape[0]
    total = landed.sum()
    if total <= 0:
        return np.zeros(2)
    frac = landed / total
    h = -np.where(frac > 0, frac * np.log(np.where(frac > 0, frac, 1.0)), 0.0).sum()
    return np.array([landed.max() * n / total, h / math.log(n) if n > 1 else 0.0])


_HOST_COMPUTERS: dict[str, Callable[[Mapping[str, Any]], np.ndarray]] = {
    "backlog": lambda ctx: np.array([ctx["h"]]),
    "queue_depth": _np_queue_depth,
    "price": _np_price,
    "dispatch": _np_dispatch,
    "transit": lambda ctx: np.array([ctx["transit_total"]]),
    "backlog_comp": lambda ctx: np.asarray(ctx["comp_backlog"], np.float64),
    "held": lambda ctx: np.array([ctx["held"], ctx["dropped"]]),
    "window": lambda ctx: np.array([ctx["tp"], ctx["fp"], ctx["tn"]]),
    "saturation": lambda ctx: np.array([ctx["capped"], ctx["served"]]),
}


def compute_host_streams(
    names: tuple[str, ...], ctx: Mapping[str, Any]
) -> tuple[np.ndarray, ...]:
    """Numpy twin of :func:`compute_scan_streams` for a host-loop engine —
    same names, same formulas, same row shapes."""
    return tuple(np.asarray(_HOST_COMPUTERS[n](ctx), np.float64) for n in names)


@dataclasses.dataclass
class MetricsFrame:
    """Host-side materialized metric streams: one ``(T, width)`` array each."""

    spec: MetricsSpec
    streams: dict[str, np.ndarray]
    columns: dict[str, tuple[str, ...]]

    @property
    def n_slots(self) -> int:
        return next(iter(self.streams.values())).shape[0] if self.streams else 0

    def to_json(self) -> dict:
        return {
            "schema": OBS_JSON_SCHEMA,
            "spec": list(self.spec.streams),
            "n_slots": self.n_slots,
            "streams": {
                name: {
                    "columns": list(self.columns[name]),
                    "values": np.asarray(arr, np.float64).round(6).tolist(),
                }
                for name, arr in self.streams.items()
            },
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)
            f.write("\n")

    @classmethod
    def from_json(cls, payload: Mapping[str, Any]) -> "MetricsFrame":
        if payload.get("schema") != OBS_JSON_SCHEMA:
            raise ValueError(
                f"expected schema {OBS_JSON_SCHEMA!r}, got {payload.get('schema')!r}")
        streams = {}
        columns = {}
        for name, body in payload["streams"].items():
            streams[name] = np.asarray(body["values"], np.float64)
            columns[name] = tuple(body["columns"])
        return cls(spec=MetricsSpec(streams=tuple(payload["spec"])),
                   streams=streams, columns=columns)

    @classmethod
    def load(cls, path: str) -> "MetricsFrame":
        with open(path) as f:
            return cls.from_json(json.load(f))


def build_frame(
    spec: MetricsSpec,
    scan_arrays: Iterable[Any],
    *,
    n_slots: int,
    payload_floats: float = 0.0,
) -> MetricsFrame:
    """Assemble a :class:`MetricsFrame` from the engine's stacked stream
    outputs.

    ``scan_arrays`` holds one ``(T, width)`` host array per
    :func:`scan_stream_names` entry, in spec order; the ``payload`` stream (a
    per-slot constant known only on the host) is filled in here.
    """
    names = scan_stream_names(spec)
    arrays = [np.asarray(a) for a in scan_arrays]
    if len(arrays) != len(names):
        raise ValueError(f"expected {len(names)} stream arrays, got {len(arrays)}")
    streams: dict[str, np.ndarray] = {}
    columns: dict[str, tuple[str, ...]] = {}
    for name, arr in zip(names, arrays):
        if arr.ndim != 2 or arr.shape[0] != n_slots:
            raise ValueError(f"stream {name!r}: expected ({n_slots}, w), got {arr.shape}")
        streams[name] = arr
        columns[name] = STREAMS[name] or tuple(f"c{i}" for i in range(arr.shape[1]))
    if "payload" in spec.streams:
        streams["payload"] = np.full((n_slots, 1), float(payload_floats), np.float64)
        columns["payload"] = STREAMS["payload"]
    return MetricsFrame(spec=spec, streams=streams, columns=columns)
