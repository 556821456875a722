"""Observability layer (port of ``repro.obs``): telemetry registry, span
tracing, structured logs.

Zero-overhead when off; see ``telemetry.py`` / ``tracing.py`` / ``log.py``.
"""
from repro_torch.obs.log import get_logger
from repro_torch.obs.telemetry import (
    Counter,
    Gauge,
    Histogram,
    Ring,
    TelemetryRegistry,
    parse_exposition,
)
from repro_torch.obs.tracing import (
    SpanTracer,
    get_tracer,
    instant,
    set_tracer,
    span,
    validate_chrome_trace,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Ring",
    "SpanTracer",
    "TelemetryRegistry",
    "get_logger",
    "get_tracer",
    "instant",
    "parse_exposition",
    "set_tracer",
    "span",
    "validate_chrome_trace",
]
