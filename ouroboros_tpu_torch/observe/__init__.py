"""observe — metrics registry, timing spans, their export and the flight
recorder.

Ported from `ouroboros_tpu/observe/__init__.py`, with the four modules
the replay reads (consensus/pipeline.py): `metrics`, `spans`, `export` and
`flight`; and `netmetrics`, the per-peer instruments that the mux, the
DeltaQ tracker and the watchdogs publish through.  The adapter,
propagation timelines and scrape endpoint are not ported yet.

Defaults: metric writes are ON and span recording is OFF; `enable()` /
`disable()` flip them together.
"""
from __future__ import annotations

from . import export, flight, metrics, netmetrics, spans
from .flight import FLIGHT, FlightRecorder
from .metrics import REGISTRY, Counter, Gauge, Histogram, MetricsRegistry
from .netmetrics import peer_label
from .spans import RECORDER, Span, SpanRecorder, phase_totals, span

__all__ = [
    "FLIGHT", "FlightRecorder", "REGISTRY", "RECORDER", "Counter", "Gauge",
    "Histogram", "MetricsRegistry", "Span", "SpanRecorder", "disable",
    "enable", "enabled", "export", "flight", "metrics", "netmetrics",
    "peer_label", "phase_totals", "span", "spans",
]


def enable() -> None:
    """Turn on metrics writes and span recording."""
    metrics.REGISTRY.enable()
    spans.RECORDER.enable()


def disable() -> None:
    metrics.REGISTRY.disable()
    spans.RECORDER.disable()


def enabled() -> bool:
    return metrics.REGISTRY.enabled or spans.RECORDER.enabled
