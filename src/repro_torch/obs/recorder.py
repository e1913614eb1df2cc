"""Fixed-size flight recorder for host-loop components (serving layer) — the
port's copy of ``repro.obs.recorder`` (DESIGN.md §14).

A :class:`FlightRecorder` keeps the last ``capacity`` slots of whatever
fields its owner records — a postmortem ring for disruption runs, where the
interesting window is the tail right before/after a failure. The serving
dispatcher records one row per ``route()`` call and the ``ReplicaFleet``
one row per ``step()``; :meth:`dump` emits the ring as repro-bench/v2-style
JSON (same envelope the benchmark snapshots use) so the existing tooling can
read it.
"""
from __future__ import annotations

import json
from collections import deque
from typing import Any

__all__ = ["FlightRecorder"]

RECORDER_JSON_SCHEMA = "repro-bench/v2"


class FlightRecorder:
    """Ring buffer of per-slot observation rows (oldest rows evicted)."""

    def __init__(self, capacity: int = 256, fields: tuple[str, ...] | None = None):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self.fields = tuple(fields) if fields is not None else None
        self._rows: deque[dict] = deque(maxlen=self.capacity)
        self.dropped = 0  # rows evicted from the ring so far

    def record(self, **values: Any) -> None:
        if self.fields is not None:
            values = {k: v for k, v in values.items() if k in self.fields}
        if len(self._rows) == self.capacity:
            self.dropped += 1
        self._rows.append({k: _scalar(v) for k, v in values.items()})

    def rows(self) -> list[dict]:
        return list(self._rows)

    def dump(self) -> dict:
        return {
            "schema": RECORDER_JSON_SCHEMA,
            "capacity": self.capacity,
            "dropped": self.dropped,
            "rows": self.rows(),
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.dump(), f, indent=1)
            f.write("\n")

    def clear(self) -> None:
        self._rows.clear()
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._rows)


def _scalar(v: Any) -> Any:
    # numpy scalars, 0-d arrays and 0-d torch tensors -> plain Python numbers,
    # arrays and tensors -> lists, so json.dump never chokes
    item = getattr(v, "item", None)
    if item is not None and getattr(v, "ndim", 0) == 0:
        return item()
    if hasattr(v, "tolist"):
        return v.tolist()
    return v
