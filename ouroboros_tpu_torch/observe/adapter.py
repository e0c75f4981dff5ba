"""NodeTracers -> metrics adapter.

The node's typed event stream (utils/tracer.py dataclasses) becomes
registry counters WITHOUT string matching: each event counts under
`node.<subsystem>.<EventTypeName>`, keyed by the event's CLASS — the
typed log schema is the metric schema.  Events carrying an `n` field
(e.g. TraceChainSyncEvent batches) count by that weight.

`metrics_node_tracers()` builds a NodeTracers bundle whose tracers do
only this; `counting(tracer)` wraps an existing tracer so the events
still reach their original sink (sim trace, JSONL bridge) and are
counted on the way through.

Ported from `ouroboros_tpu/observe/adapter.py` (the port imports nothing
of the JAX package). Copied whole.
"""
from __future__ import annotations

from ..utils.tracer import NodeTracers, Tracer
from . import metrics as _metrics


def _emit_for(subsystem: str, reg=None):
    reg = reg or _metrics.registry()
    counters: dict = {}           # event class -> Counter (no re-lookup)

    def emit(ev) -> None:
        cls = type(ev)
        c = counters.get(cls)
        if c is None:
            c = reg.counter(f"node.{subsystem}.{cls.__name__}")
            counters[cls] = c
        c.inc(getattr(ev, "n", 1))
    return emit


def metrics_tracer(subsystem: str, reg=None) -> Tracer:
    """A Tracer counting each event under node.<subsystem>.<EventType>."""
    return Tracer(_emit_for(subsystem, reg))


def counting(subsystem: str, inner: Tracer, reg=None) -> Tracer:
    """Count events AND forward them to `inner` (tee)."""
    emit = _emit_for(subsystem, reg)
    if not inner.active:
        return Tracer(emit)

    def both(ev) -> None:
        emit(ev)
        inner.trace(ev)
    return Tracer(both)


def metrics_node_tracers(reg=None) -> NodeTracers:
    """The per-subsystem bundle, every subsystem counting into the
    registry (protocol events become metrics with zero string
    matching)."""
    return NodeTracers(chain_db=metrics_tracer("chaindb", reg),
                       forge=metrics_tracer("forge", reg),
                       fetch=metrics_tracer("fetch", reg),
                       chain_sync=metrics_tracer("chainsync", reg))


def counting_node_tracers(inner: NodeTracers, reg=None) -> NodeTracers:
    """Wrap an existing bundle: events still reach their sinks, and are
    counted on the way through."""
    return NodeTracers(chain_db=counting("chaindb", inner.chain_db, reg),
                       forge=counting("forge", inner.forge, reg),
                       fetch=counting("fetch", inner.fetch, reg),
                       chain_sync=counting("chainsync", inner.chain_sync,
                                           reg))
