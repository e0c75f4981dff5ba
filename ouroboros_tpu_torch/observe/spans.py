"""Hierarchical timing spans with explicit device fencing.

A span is one named, categorised interval on the host timeline; spans
nest, forming one tree per top-level region (a replay window, a bench
rep, a compile).  Categories are the replay phase vocabulary the bench
attributes time to:

    host-seq   the sequential host pass (nonce evolution, envelope
               checks, proof extraction)
    dispatch   host-side prep + async kernel dispatch (submit_window)
    device     blocking on device results (the finish_window drain, a
               precompute fill and its wait for the card)
    compile    what stands in for a compile in the port: the CUDA
               kernel library's nvcc build or load and a path's first
               launch (parallel/mesh.py:log_compile_time)
    sync       explicit `torch.cuda.synchronize()` fences draining the
               card's queued work before a timed region
    disk       storage-layer reads + CBOR decode on the streaming
               replay's prefetch thread (storage/stream.py) — the
               seconds the read-ahead hides under device verify

Clock discipline: **monotonic only** — `time.perf_counter()` on the
host, the active runtime's virtual clock under simharness (Sim time in
tests, the IO runtime's monotonic offset in production).  No wall-clock
(`time.time()`-style) reads anywhere: span math must be immune to NTP
steps, and sim tests must see exact virtual durations.

Fencing: a span created with `fence=True` waits for the card's queued
work (`torch.cuda.synchronize()`) at BOTH edges, so the measured
interval covers exactly the work dispatched inside it and inherits
nothing in flight.  The fence is skipped unless CUDA is already
initialised — host-only flows must not touch the card just by timing
themselves.

Disabled recording is near-free: `span()` returns one shared null
context manager (no allocation, no clock read).

CPU time: outside a runtime, a span also reads `time.thread_time()` at
both edges, and `Span.cpu` holds the calling thread's CPU seconds inside
it.  Its wall time less its CPU time is the time the thread was off the
CPU: waiting for the interpreter lock, descheduled, or blocked in a call
(a wait for the card among them).  Under a runtime `cpu` stays None,
since the runtime's clock is not the thread's.  `SpanRecorder.totals()`
gives (count, wall seconds, CPU seconds) by name over every span closed
since the recorder was last enabled.

Thread discipline: the pipelined replay runs its host-sequential pass on
a background producer thread (consensus/pipeline.py), so the recorder
keeps one open-span stack PER THREAD (a producer's `window.host_seq`
must never adopt the consumer's `window.drain` as a child just because
they overlap in wall time).  Completed roots land in one shared,
lock-guarded list so a drain sees both threads' trees.

Ported from `ouroboros_tpu/observe/spans.py` (the port imports nothing of
the JAX package). Changed: `device_fence` waits on the CUDA card
(`torch.cuda.synchronize()`) instead of the JAX fence, and only when torch
is imported and CUDA already initialised.
"""
from __future__ import annotations

import sys
import threading
import time
from typing import List, Optional

from ..simharness import runtime as _runtime
from . import metrics as _metrics

PHASES = ("host-seq", "dispatch", "device", "compile", "sync", "stall",
          "disk")


def monotonic_now() -> float:
    """Virtual monotonic time under an active sim/IO runtime, host
    perf_counter otherwise."""
    rt = _runtime.current_or_none()
    if rt is not None:
        return rt.now()
    return time.perf_counter()


def device_fence() -> None:
    """Wait for the work queued on the CUDA card.  No-op unless torch is
    imported and CUDA already initialised (a fenced span in a host-only
    process must not touch the card)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return
    torch.cuda.synchronize()


class Span:
    """One completed (or in-flight) interval.  `t0`/`t1` are clock
    readings from `monotonic_now`; `children` are spans closed while
    this one was the innermost open span; `cpu` is the recording
    thread's CPU seconds between the edges (None under a runtime)."""

    __slots__ = ("name", "cat", "t0", "t1", "children", "meta", "cpu",
                 "_c0")

    def __init__(self, name: str, cat: str, t0: float):
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.t1: Optional[float] = None
        self.children: List["Span"] = []
        self.meta: Optional[dict] = None
        self.cpu: Optional[float] = None
        self._c0: Optional[float] = None    # thread_time() at the open

    @property
    def duration(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def __repr__(self):
        return (f"Span({self.name!r}, cat={self.cat!r}, "
                f"dur={self.duration:.6f}, "
                f"children={len(self.children)})")


class _NullSpan:
    """Shared no-op context manager for the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _LiveSpan:
    __slots__ = ("_rec", "_name", "_cat", "_fence", "_span")

    def __init__(self, rec: "SpanRecorder", name: str, cat: str,
                 fence: bool):
        self._rec = rec
        self._name = name
        self._cat = cat
        self._fence = fence
        self._span: Optional[Span] = None

    def __enter__(self) -> Span:
        if self._fence:
            device_fence()
        self._span = self._rec._open(self._name, self._cat)
        return self._span

    def __exit__(self, *exc):
        if self._fence:
            device_fence()
        self._rec._close(self._span)
        return False


class SpanRecorder:
    """Process-wide span collector: an open-span stack plus the list of
    completed root trees.  Bounded — a forgotten enabled recorder in a
    long-lived node must not grow without limit; overflow drops new
    roots and counts them."""

    def __init__(self, enabled: bool = False, max_roots: int = 100_000):
        self.enabled = enabled
        self.max_roots = max_roots
        self.roots: List[Span] = []
        self._tls = threading.local()      # per-thread open-span stack
        self._lock = threading.Lock()      # guards roots/dropped/_totals
        self.dropped = 0
        # name -> (count, wall s, cpu s) since the last enable()
        self._totals: dict = {}
        self.flight = None                 # armed FlightRecorder
        self._drop_counter = _metrics.counter("observe.spans_dropped",
                                              always=True)
        # per-phase duration histograms, bound lazily ONCE per category
        # (a span close must not pay a registry lookup): every close
        # feeds `latency.phase.<cat>`, so phase p50/p95/p99 are live on
        # the scrape endpoint while a replay runs
        self._phase_hist: dict = {}

    def _hist_for(self, cat: str):
        h = self._phase_hist.get(cat)
        if h is None:
            h = _metrics.latency_histogram(f"latency.phase.{cat}")
            self._phase_hist[cat] = h
        return h

    @property
    def _stack(self) -> List[Span]:
        """Open-span stack of the CALLING thread: nesting is a per-thread
        notion — a producer-thread span overlapping a consumer-thread
        span in wall time is concurrency, not containment."""
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    # -- the public surface ------------------------------------------------
    def span(self, name: str, cat: str = "host-seq", fence: bool = False):
        """Context manager timing one interval.  Near-free when the
        recorder is disabled (returns a shared null CM)."""
        if not self.enabled:
            return _NULL
        return _LiveSpan(self, name, cat, fence)

    def enable(self) -> None:
        with self._lock:
            self._totals = {}
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def drain(self) -> List[Span]:
        """Completed root spans since the last drain (open spans stay on
        the stack and attach to a later drain's roots when closed)."""
        with self._lock:
            out, self.roots = self.roots, []
        return out

    def clear(self) -> None:
        with self._lock:
            self.roots = []
            self._tls = threading.local()
            self.dropped = 0
            self._totals = {}

    def totals(self) -> dict:
        """{name: (count, wall seconds, CPU seconds)} over the spans
        closed since the recorder was last enabled (or cleared); drain()
        and disable() keep it.  CPU seconds are None where a span of the
        name was recorded under a runtime."""
        with self._lock:
            return dict(self._totals)

    # -- recording ---------------------------------------------------------
    def _open(self, name: str, cat: str) -> Span:
        sp = Span(name, cat, monotonic_now())
        if _runtime.current_or_none() is None:
            # read after the wall clock at the open and before it at the
            # close, so the CPU interval lies inside the wall one
            sp._c0 = time.thread_time()
        self._stack.append(sp)
        return sp

    def _close(self, sp: Span) -> None:
        if sp.t1 is not None:
            # already stamped: this span was adopted as a child by an
            # earlier out-of-order close (or its CM exited twice);
            # recording it again would attach it under a second
            # parent or root and double-count it in phase_totals
            return
        c1 = time.thread_time() if sp._c0 is not None else None
        sp.t1 = monotonic_now()
        if c1 is not None:
            sp.cpu = c1 - sp._c0
        fl = self.flight
        if fl is not None:
            fl.span(sp)
        # tolerate out-of-order closes (a generator-held span closed
        # late): pop up to and including sp, re-parenting survivors
        stack = self._stack
        closed = [sp]
        if sp in stack:
            while stack:
                top = stack.pop()
                if top is sp:
                    break
                if top.t1 is None:
                    top.t1 = sp.t1
                    if c1 is not None and top._c0 is not None:
                        top.cpu = c1 - top._c0
                    closed.append(top)
                sp.children.append(top)
        parent = stack[-1] if stack else None
        # phase-latency feed: one sample per contiguous same-category
        # episode — a span nested under a SAME-cat parent (JaxBackend's
        # "window.drain" inside the pipeline's "pipeline.drain", both
        # device) is the same wait seen twice, and observing both would
        # double the histogram count and skew the quantiles
        if parent is None or parent.cat != sp.cat:
            self._hist_for(sp.cat).observe(sp.t1 - sp.t0)
        if parent is not None:
            parent.children.append(sp)
        with self._lock:
            totals = self._totals
            for s in closed:
                n, wall, cpu = totals.get(s.name, (0, 0.0, 0.0))
                totals[s.name] = (n + 1, wall + s.duration,
                                  None if cpu is None or s.cpu is None
                                  else cpu + s.cpu)
            if parent is None:
                if len(self.roots) < self.max_roots:
                    self.roots.append(sp)
                else:
                    self.dropped += 1
                    self._drop_counter.inc()


RECORDER = SpanRecorder()


def recorder() -> SpanRecorder:
    return RECORDER


def span(name: str, cat: str = "host-seq", fence: bool = False):
    """observe.spans.span("window.drain", cat="device") — module-level
    convenience over the process-wide recorder."""
    rec = RECORDER
    if not rec.enabled:
        return _NULL
    return _LiveSpan(rec, name, cat, fence)


def enabled() -> bool:
    return RECORDER.enabled


def intervals_of(spans_: List[Span], cat: Optional[str] = None,
                 name: Optional[str] = None) -> list:
    """(t0, t1) intervals of every completed span in the forest matching
    `cat` and/or `name` (None = match all).  Inputs for overlap math —
    the bench's host-under-device attribution."""
    out = []
    for root in spans_:
        for sp in root.walk():
            if sp.t1 is None:
                continue
            if cat is not None and sp.cat != cat:
                continue
            if name is not None and sp.name != name:
                continue
            out.append((sp.t0, sp.t1))
    return out


def merge_intervals(intervals: list) -> list:
    """Union of intervals as a sorted, disjoint list."""
    merged: list = []
    for t0, t1 in sorted(intervals):
        if merged and t0 <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], t1))
        else:
            merged.append((t0, t1))
    return merged


def overlap_seconds(a: list, b: list) -> float:
    """Total seconds where the union of `a` intersects the union of `b`
    — e.g. host-seq time HIDDEN under in-flight device time.  The two
    forests' clocks must be comparable (same monotonic_now source)."""
    a, b = merge_intervals(a), merge_intervals(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def phase_totals(spans_: List[Span]) -> dict:
    """Seconds per category over a forest of span trees.

    Each span contributes its SELF time (duration minus its children's
    durations) to its own category, so a dispatch span containing a
    compile span attributes the compile seconds to `compile`, never
    twice.  Categories outside PHASES aggregate under their own name."""
    totals: dict = {}

    def add(sp: Span):
        inner = sum(c.duration for c in sp.children)
        totals[sp.cat] = totals.get(sp.cat, 0.0) + max(
            0.0, sp.duration - inner)
        for c in sp.children:
            add(c)

    for sp in spans_:
        add(sp)
    return totals
