"""Flight recorder — a bounded ring of the last moments before a failure.

The reference stack keeps an always-on tracer seam precisely so a crash
leaves evidence (SURVEY.md §5); the bench-scoped spans and metrics
cannot play that role — spans are drained per rep and metric
history is a point-in-time snapshot.  This module is the crash-proof
analog: while ARMED, every span close, every instrument write and any
`note()`d typed event lands in one process-wide ring
(`collections.deque(maxlen=N)` — appends are GIL-atomic, so the
pipelined replay's producer and consumer record concurrently without a
lock), and a failure path dumps the ring as

- ``flight.trace.json`` — the span entries as chrome://tracing
  `trace_event` JSON (load via chrome://tracing or ui.perfetto.dev);
- ``flight.jsonl``      — every ring entry in arrival order, one JSON
  object per line, ``kind`` ∈ {span, metric, event} (a header line
  leads with the dump reason and entry count).

Cost model: DISARMED is one attribute read per instrument write and per
span close (`flight is None`); ARMED adds one tuple build + deque
append.  Nothing is formatted until `dump()`.

Clock discipline matches observe/spans.py: entry timestamps come from
`monotonic_now()`, i.e. the active runtime's VIRTUAL clock under
simharness — a seeded threadnet failure therefore dumps byte-identical
bytes on every replay of the same seed (golden-tested), and a
production failure dumps real monotonic time.

Wired failure paths: consensus/pipeline.py dumps on a ReplayResult
error or a producer crash; testing/threadnet.py dumps the chaos sim's
trace tail when a seeded chaos run raises.  Arming is explicit
(`FLIGHT.arm()`), typically around a long replay or a chaos sweep;
``OURO_FLIGHT_DIR`` overrides the dump directory.

Ported from `ouroboros_tpu/observe/flight.py` (the port imports nothing of
the JAX package). Copied whole (the threadnet failure path it names is not
ported yet).
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import deque
from typing import List, Optional

from . import export as _export
from . import metrics as _metrics
from . import spans as _spans

#: dumps are load-bearing evidence: count them whether or not
#: observation is enabled
_DUMPS = _metrics.counter("observe.flight_dumps", always=True)


def default_dump_dir() -> str:
    return os.environ.get("OURO_FLIGHT_DIR") or os.path.join(
        tempfile.gettempdir(), "ouro-flight")


class FlightRecorder:
    """The bounded ring + its arm/dump lifecycle.  One process-wide
    instance (`FLIGHT`) hooks the global registry and span recorder;
    tests build private ones against private registries/recorders."""

    def __init__(self, capacity: int = 4096,
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 recorder: Optional[_spans.SpanRecorder] = None):
        self.capacity = capacity
        self.armed = False
        self._reg = registry if registry is not None else _metrics.REGISTRY
        self._rec = recorder if recorder is not None else _spans.RECORDER
        self._ring: deque = deque(maxlen=capacity)
        self._was_rec_enabled = False

    # -- lifecycle -----------------------------------------------------------
    def arm(self, capacity: Optional[int] = None) -> "FlightRecorder":
        """Start recording.  Span recording is forced on while armed (a
        flight recorder without spans records nothing worth replaying);
        the recorder's prior state is restored on disarm.  Re-arming an
        armed recorder is a no-op state-wise — the ORIGINAL pre-arm
        recorder state survives, so nested arm/disarm pairs cannot leave
        span recording forced on forever."""
        if capacity is not None and capacity != self._ring.maxlen:
            self._ring = deque(self._ring, maxlen=capacity)
        if not self.armed:
            self._was_rec_enabled = self._rec.enabled
        self.armed = True
        self._rec.enabled = True
        self._reg.flight = self
        self._rec.flight = self
        return self

    def disarm(self) -> None:
        self.armed = False
        if self._reg.flight is self:
            self._reg.flight = None
        if self._rec.flight is self:
            self._rec.flight = None
        if not self._was_rec_enabled:
            self._rec.enabled = False

    def clear(self) -> None:
        self._ring.clear()

    def __len__(self) -> int:
        return len(self._ring)

    # -- recording hooks (called from metrics/spans while armed) -------------
    def span(self, sp: _spans.Span) -> None:
        self._ring.append(
            (sp.t1, "span", sp.name, sp.cat, sp.t0, sp.t1))

    def metric(self, name: str, op: str, v) -> None:
        self._ring.append((_spans.monotonic_now(), "metric", name, op, v))

    def note(self, event, t: Optional[float] = None) -> None:
        """Record one typed event (utils/tracer.py dataclass or any
        object — rendered through the typed JSONL schema at dump time).
        Pass `t` when the event carries its own clock reading (a sim
        trace tail noted AFTER the simulation exited must keep the
        virtual times it happened at, not the wall clock of the
        post-mortem — the byte-identical-replay contract)."""
        if self.armed:
            self._ring.append((_spans.monotonic_now() if t is None
                               else t, "event", event))

    def tracer(self):
        """A live Tracer feeding the ring — plug into NodeTracers to make
        protocol events part of the flight record."""
        from ..utils.tracer import Tracer
        return Tracer(self.note)

    # -- dumping -------------------------------------------------------------
    def entries(self) -> List[tuple]:
        return list(self._ring)

    def _spans_of(self, entries) -> List[_spans.Span]:
        out = []
        for e in entries:
            if e[1] == "span":
                sp = _spans.Span(e[2], e[3], e[4])
                sp.t1 = e[5]
                out.append(sp)
        return out

    def dump(self, dir_path: Optional[str] = None,
             reason: str = "") -> dict:
        """Write the ring to `dir_path` (default OURO_FLIGHT_DIR or a
        tmp-rooted ouro-flight/) as chrome-trace + JSONL; returns the
        paths.  The ring is snapshotted once so a concurrent recorder
        thread cannot tear the dump."""
        dir_path = dir_path or default_dump_dir()
        os.makedirs(dir_path, exist_ok=True)
        entries = self.entries()
        trace_path = os.path.join(dir_path, "flight.trace.json")
        _export.write_chrome_trace(trace_path, self._spans_of(entries))
        jsonl_path = os.path.join(dir_path, "flight.jsonl")
        with open(jsonl_path, "w") as f:
            f.write(json.dumps(
                {"kind": "flight", "reason": reason,
                 "entries": len(entries)},
                separators=(",", ":")) + "\n")
            for e in entries:
                f.write(json.dumps(self._record(e),
                                   separators=(",", ":")) + "\n")
        _DUMPS.inc()
        return {"dir": dir_path, "trace": trace_path, "jsonl": jsonl_path}

    @staticmethod
    def _record(e: tuple) -> dict:
        t, kind = round(e[0], 9), e[1]
        if kind == "span":
            return {"t": t, "kind": kind, "name": e[2], "cat": e[3],
                    "t0": round(e[4], 9), "t1": round(e[5], 9)}
        if kind == "metric":
            return {"t": t, "kind": kind, "name": e[2], "op": e[3],
                    "v": e[4]}
        rec = {"t": t, "kind": "event"}
        rec.update(_export.event_record(e[2]))
        return rec

    def dump_on_failure(self, reason: str) -> Optional[dict]:
        """The failure-path entry point: a no-op unless armed, so the
        error paths that call it (pipeline, threadnet) stay free in
        normal runs."""
        if not self.armed:
            return None
        return self.dump(reason=reason)


#: the process-wide flight recorder (hooks REGISTRY + RECORDER)
FLIGHT = FlightRecorder()
