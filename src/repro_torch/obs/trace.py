"""Host-side span tracing with a Chrome-trace (Perfetto-loadable) exporter —
the port's counterpart of ``repro.obs.trace`` (DESIGN.md §14).

Spans wrap the engines' host-visible phases — problem build, chunk,
dispatcher scheduler call — under the naming convention
``potus/<engine-or-layer>/<stage>``, the reference's names. When tracing is
enabled each span also opens a ``torch.profiler.record_function`` range of
the same name, so a ``torch.profiler`` trace of the run lists the engine
phases beside the kernels.

Tracing is **off by default**: :func:`span` is a no-op context manager until
:func:`enable_tracing` runs, so the engines leave the ``with`` statements in
place at no cost. A span reads the host clock only; it never synchronises the
device, so a span over device work measures the time to issue it. Events live
in a bounded ring (oldest dropped) and export via :func:`export_chrome_trace`
as the standard ``{"traceEvents": [...]}`` JSON that chrome://tracing and
Perfetto load directly.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Iterator

import torch

__all__ = [
    "SpanTracer",
    "span",
    "get_tracer",
    "enable_tracing",
    "disable_tracing",
    "chrome_trace",
    "export_chrome_trace",
]


class SpanTracer:
    """Bounded in-memory span collector (thread-safe, nesting-aware)."""

    def __init__(self, capacity: int = 8192):
        self.capacity = int(capacity)
        self._events: deque[dict] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self.enabled = False
        self._t0 = time.perf_counter()

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._t0 = time.perf_counter()

    def _depth(self) -> int:
        return getattr(self._local, "depth", 0)

    @contextlib.contextmanager
    def span(self, name: str, **meta) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        begin = time.perf_counter()
        self._local.depth = self._depth() + 1
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            end = time.perf_counter()
            self._local.depth = self._depth() - 1
            event = {
                "name": name,
                "ph": "X",
                "ts": (begin - self._t0) * 1e6,  # chrome trace wants µs
                "dur": (end - begin) * 1e6,
                "pid": os.getpid(),
                "tid": threading.get_ident() % 2**31,
            }
            if meta:
                event["args"] = {k: str(v) for k, v in meta.items()}
            with self._lock:
                self._events.append(event)

    def chrome_trace(self) -> dict:
        with self._lock:
            events = list(self._events)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
            f.write("\n")

    def __len__(self) -> int:
        return len(self._events)


_TRACER = SpanTracer()


def get_tracer() -> SpanTracer:
    return _TRACER


def enable_tracing(capacity: int | None = None) -> SpanTracer:
    if capacity is not None:
        _TRACER._events = deque(_TRACER._events, maxlen=int(capacity))
        _TRACER.capacity = int(capacity)
    _TRACER.enabled = True
    return _TRACER


def disable_tracing() -> None:
    _TRACER.enabled = False


def span(name: str, **meta):
    """Module-level convenience over the global tracer (no-op when disabled)."""
    return _TRACER.span(name, **meta)


def chrome_trace() -> dict:
    return _TRACER.chrome_trace()


def export_chrome_trace(path: str) -> None:
    _TRACER.export_chrome_trace(path)
