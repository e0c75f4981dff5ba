"""Process-wide metrics registry — named counters/gauges/histograms with
deterministic snapshots.

The reference threads a contravariant `Tracer m a` through every
constructor but ships no metrics layer; our reproduction had outgrown
its ad-hoc equivalents (private counters in crypto/precompute.py and
crypto/autotune.py, one-off breakdowns printed by bench.py).  This
module is the one seam they all migrate into.

Design constraints, in order:

1. **Near-free when disabled.**  Every observational write goes through
   one flag read (`registry.enabled`); a disabled registry performs NO
   instrument writes at all — asserted by the bench --smoke probe via
   `data_writes`, which counts gated writes that actually landed.
2. **Deterministic snapshots.**  `snapshot()` returns instruments in
   sorted name order with values that are pure functions of the workload
   at a fixed seed (counts, not wall times), so two bench runs emit
   byte-identical `metrics` sections and the output stays diffable.
   Instruments that hold measured durations or other run-varying values
   are created with `stable=False` and excluded from `snapshot()`
   (they still appear in the Prometheus exposition, which is allowed to
   vary run to run).
3. **Functional counters stay functional.**  The migrated precompute /
   autotune counters are *load-bearing* — tests and bench assertions
   gate on them (warm windows do zero fills; frozen tuners reject
   writes).  Those are created with `always=True`: they count whether or
   not observation is enabled, and their writes are not charged to
   `data_writes` (they are program state that happens to be exported,
   not observation).

Instruments can exist unregistered (``Counter("x")``): per-instance
caches in tests get private counters with the same API while only the
process-wide singletons bind into the global registry — two fresh
`PrecomputeCache` instances never fight over one name.

Ported from `ouroboros_tpu/observe/metrics.py` (the port imports nothing
of the JAX package). Copied whole.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Tuple


class Counter:
    """Monotonic-by-convention numeric cell.  `value` is read/write so
    migrated call sites using `cache.hits += 1` keep working through a
    property alias."""

    kind = "counter"
    __slots__ = ("name", "value", "always", "stable", "_reg")

    def __init__(self, name: str, reg: Optional["MetricsRegistry"] = None,
                 always: bool = False, stable: bool = True):
        self.name = name
        self.value = 0
        self.always = always
        self.stable = stable
        self._reg = reg

    def inc(self, n: int = 1) -> None:
        reg = self._reg
        if self.always:
            self.value += n
        elif reg is not None and reg.enabled:
            self.value += n
            reg.data_writes += 1
        else:
            return
        if reg is not None and reg.flight is not None:
            reg.flight.metric(self.name, "inc", n)

    def snapshot_value(self):
        return self.value


class Gauge:
    """Last-write-wins numeric cell."""

    kind = "gauge"
    __slots__ = ("name", "value", "always", "stable", "_reg")

    def __init__(self, name: str, reg: Optional["MetricsRegistry"] = None,
                 always: bool = False, stable: bool = True):
        self.name = name
        self.value = 0
        self.always = always
        self.stable = stable
        self._reg = reg

    def set(self, v) -> None:
        reg = self._reg
        if self.always:
            self.value = v
        elif reg is not None and reg.enabled:
            self.value = v
            reg.data_writes += 1
        else:
            return
        if reg is not None and reg.flight is not None:
            reg.flight.metric(self.name, "set", v)

    def snapshot_value(self):
        return self.value


# default buckets suit the quantities this repo observes (queue depths,
# batch sizes, retry counts) — powers of two up to a replay window
DEFAULT_BUCKETS: Tuple[float, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256,
                                      512, 1024, 2048, 4096)

# fixed log-spaced latency bucket edges: 1µs doubling up to ~134s.  ONE
# shared vocabulary for every duration histogram (queue waits, span
# phases, submit→drain, arrival gaps) so quantiles from any two
# instruments — or two runs — are comparable bucket for bucket, and the
# exposition stays byte-stable for a fixed workload.
LATENCY_BUCKETS: Tuple[float, ...] = tuple(1e-6 * 2 ** i for i in range(28))


def quantile_from_buckets(buckets: Tuple[float, ...], counts: List,
                          q: float) -> float:
    """Deterministic quantile from per-bucket counts (len(counts) ==
    len(buckets) + 1, the final cell being the +inf overflow).

    rank = q * total observations; the answer interpolates linearly
    inside the bucket containing that rank ([0, b0] for the first, the
    top edge for overflow — an unbounded bucket cannot be interpolated).
    Pure integer/float arithmetic on the counts: two histograms with
    identical counts yield byte-identical quantiles regardless of
    observation or creation order."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    rank = q * total
    cum = 0
    for i, c in enumerate(counts[:-1]):
        prev, cum = cum, cum + c
        if c and cum >= rank:
            lo = buckets[i - 1] if i else 0.0
            hi = buckets[i]
            return round(lo + (hi - lo) * (rank - prev) / c, 9)
    return float(buckets[-1]) if buckets else 0.0


class Histogram:
    """Fixed-bucket histogram (cumulative counts on export, per the
    Prometheus convention; stored per-bucket so observe() is one index
    update).  `buckets=LATENCY_BUCKETS` makes it the log-bucket latency
    form with deterministic p50/p95/p99 via `quantiles()`."""

    kind = "histogram"
    __slots__ = ("name", "buckets", "counts", "total", "count", "always",
                 "stable", "_reg")

    def __init__(self, name: str, reg: Optional["MetricsRegistry"] = None,
                 buckets: Iterable[float] = DEFAULT_BUCKETS,
                 always: bool = False, stable: bool = True):
        self.name = name
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)   # +inf overflow
        self.total = 0.0
        self.count = 0
        self.always = always
        self.stable = stable
        self._reg = reg

    def _record(self, v) -> None:
        i = 0
        for i, b in enumerate(self.buckets):
            if v <= b:
                break
        else:
            i = len(self.buckets)
        self.counts[i] += 1
        self.total += v
        self.count += 1

    def observe(self, v) -> None:
        reg = self._reg
        if self.always:
            self._record(v)
        elif reg is not None and reg.enabled:
            self._record(v)
            reg.data_writes += 1
        else:
            return
        if reg is not None and reg.flight is not None:
            reg.flight.metric(self.name, "observe", v)

    def quantile(self, q: float) -> float:
        """Deterministic q-quantile (0 < q < 1) from the bucket counts —
        see quantile_from_buckets.  p50/p95/p99 of a latency histogram
        are pure functions of the observation multiset."""
        return quantile_from_buckets(self.buckets, self.counts, q)

    def quantiles(self) -> dict:
        """The {p50, p95, p99} triple every latency consumer wants."""
        return {"p50": self.quantile(0.50),
                "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

    def snapshot_value(self):
        # integers only (total may be float when observing floats; round
        # to a fixed precision so the snapshot stays byte-stable)
        return {"count": self.count,
                "sum": round(self.total, 9),
                "buckets": {repr(b): c for b, c in
                            zip(self.buckets, self.counts[:-1])},
                "overflow": self.counts[-1]}


class MetricsRegistry:
    """Name -> instrument map with idempotent creation and deterministic
    snapshots.  One process-wide instance lives at `observe.metrics
    .REGISTRY`; tests build private ones."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.data_writes = 0          # gated writes that landed (probe)
        self.flight = None            # armed FlightRecorder (observe/flight)
        self._instruments: Dict[str, object] = {}

    # -- creation (idempotent by name) ----------------------------------
    def _make(self, cls, name: str, **kw):
        inst = self._instruments.get(name)
        if inst is not None:
            if not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}")
            return inst
        inst = cls(name, reg=self, **kw)
        self._instruments[name] = inst
        return inst

    def counter(self, name: str, always: bool = False,
                stable: bool = True) -> Counter:
        return self._make(Counter, name, always=always, stable=stable)

    def gauge(self, name: str, always: bool = False,
              stable: bool = True) -> Gauge:
        return self._make(Gauge, name, always=always, stable=stable)

    def histogram(self, name: str, buckets: Iterable[float] = DEFAULT_BUCKETS,
                  always: bool = False, stable: bool = True) -> Histogram:
        return self._make(Histogram, name, buckets=buckets, always=always,
                          stable=stable)

    def get(self, name: str):
        return self._instruments.get(name)

    # -- enable/disable --------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    # -- snapshots --------------------------------------------------------
    def instruments(self) -> List[object]:
        return [self._instruments[k] for k in sorted(self._instruments)]

    def snapshot(self, include_unstable: bool = False) -> dict:
        """{name: value} in sorted name order.  Only `stable` instruments
        by default — the deterministic, diffable subset (bench emits this
        verbatim into its JSON).  Histograms render as nested dicts with
        repr'd bucket edges."""
        out = {}
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            if inst.stable or include_unstable:
                out[name] = inst.snapshot_value()
        return out

    def snapshot_json(self, include_unstable: bool = False) -> str:
        """Canonical byte form of snapshot() (sorted keys, no spaces) —
        the thing two same-seed runs must agree on byte for byte."""
        return json.dumps(self.snapshot(include_unstable),
                          sort_keys=True, separators=(",", ":"))

    def reset(self) -> None:
        """Zero every instrument (tests); registration survives."""
        for inst in self._instruments.values():
            if isinstance(inst, Histogram):
                inst.counts = [0] * (len(inst.buckets) + 1)
                inst.total = 0.0
                inst.count = 0
            else:
                inst.value = 0
        self.data_writes = 0


# the process-wide registry: crypto caches, the autotuner, network
# counters and the span layer all bind into this one
REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return REGISTRY


def counter(name: str, always: bool = False, stable: bool = True) -> Counter:
    return REGISTRY.counter(name, always=always, stable=stable)


def gauge(name: str, always: bool = False, stable: bool = True) -> Gauge:
    return REGISTRY.gauge(name, always=always, stable=stable)


def histogram(name: str, buckets: Iterable[float] = DEFAULT_BUCKETS,
              always: bool = False, stable: bool = True) -> Histogram:
    return REGISTRY.histogram(name, buckets=buckets, always=always,
                              stable=stable)


def latency_histogram(name: str) -> Histogram:
    """A duration histogram on the shared LATENCY_BUCKETS vocabulary.
    Measured seconds vary run to run, so latency instruments are always
    `stable=False` — exported live (scrape/Prometheus) but excluded from
    the deterministic snapshot bench embeds.  Bind the handle ONCE at
    module/init scope: `observe()` through a fresh registry lookup on a
    hot path is the OBS002 lint."""
    return REGISTRY.histogram(name, buckets=LATENCY_BUCKETS, stable=False)


def enabled() -> bool:
    return REGISTRY.enabled
