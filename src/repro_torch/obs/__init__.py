"""Observability of the port: metric streams, span tracing, flight recorder
(DESIGN.md §14) — the counterpart of ``repro.obs``.

This package imports nothing from :mod:`repro_torch.core` — the core engines
and the serving layer import ``repro_torch.obs`` at module level, and a
reverse import would create a cycle — and nothing of the reference package.
"""
from .metrics import (
    DEFAULT_STREAMS,
    ENGINE_STREAMS,
    STREAMS,
    MetricsFrame,
    MetricsSpec,
    build_frame,
    compute_host_streams,
    compute_scan_streams,
    scan_stream_names,
    stream_engines,
    unsupported_streams,
)
from .recorder import FlightRecorder
from .trace import (
    SpanTracer,
    chrome_trace,
    disable_tracing,
    enable_tracing,
    export_chrome_trace,
    get_tracer,
    span,
)

__all__ = [
    "DEFAULT_STREAMS",
    "ENGINE_STREAMS",
    "STREAMS",
    "MetricsFrame",
    "MetricsSpec",
    "build_frame",
    "compute_host_streams",
    "compute_scan_streams",
    "scan_stream_names",
    "stream_engines",
    "unsupported_streams",
    "FlightRecorder",
    "SpanTracer",
    "chrome_trace",
    "disable_tracing",
    "enable_tracing",
    "export_chrome_trace",
    "get_tracer",
    "span",
]
