"""observe — metrics registry, timing spans, their export and the flight
recorder.

Ported from `ouroboros_tpu/observe/__init__.py`, with the four modules
the replay reads (consensus/pipeline.py): `metrics`, `spans`, `export` and
`flight`; and `netmetrics`, the per-peer instruments that the mux, the
DeltaQ tracker and the watchdogs publish through; `adapter` (NodeTracers
to metrics) and `propagation` (per-node block-propagation timelines and the
FleetTelemetry merge).  `scrape`, the live scrape endpoint, is imported on
demand, as in the reference: it pulls in the network stack.

Defaults: metric writes are ON and span recording is OFF; `enable()` /
`disable()` flip them together.
"""
from __future__ import annotations

from . import adapter, export, flight, metrics, netmetrics, propagation, \
    spans
from .adapter import counting_node_tracers, metrics_node_tracers
from .flight import FLIGHT, FlightRecorder
from .metrics import REGISTRY, Counter, Gauge, Histogram, MetricsRegistry
from .netmetrics import peer_label
from .propagation import FleetTelemetry, PropagationTracker
from .spans import RECORDER, Span, SpanRecorder, phase_totals, span

# NOTE: observe.scrape is deliberately NOT imported here — it pulls in
# the network stack (snocket/mux), which itself imports observe.metrics;
# consumers `from ouroboros_tpu_torch.observe import scrape` on demand.

__all__ = [
    "FLIGHT", "FleetTelemetry", "FlightRecorder",
    "REGISTRY", "RECORDER", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "PropagationTracker", "Span", "SpanRecorder",
    "adapter", "counting_node_tracers", "disable", "enable", "enabled",
    "export", "flight", "metrics", "metrics_node_tracers", "netmetrics",
    "peer_label", "phase_totals", "propagation", "span", "spans",
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
