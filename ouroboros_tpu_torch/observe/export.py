"""Render observability state for external consumers.

Three formats, one per audience:

- `prometheus_text(registry)` — the text exposition format a scrape
  endpoint serves (counters/gauges/histograms, `ouro_` namespace, names
  dot->underscore mangled, sorted — deterministic for a fixed registry
  state).
- `chrome_trace(spans)` — span trees as chrome://tracing / Perfetto
  `trace_event` JSON ("X" complete events, microsecond timestamps).
  Load via chrome://tracing "Load" or ui.perfetto.dev.
- `events_jsonl(events)` — typed utils/tracer.py events as JSON lines:
  one object per event carrying the dataclass type name and its fields
  (bytes hex-encoded), so a log pipeline gets the TYPED schema instead
  of parsing strings.  `jsonl_tracer(fh)` is the live bridge: a Tracer
  writing each traced event straight to a file handle.

Ported from `ouroboros_tpu/observe/export.py` (the port imports nothing of
the JAX package). Copied whole.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, List

from ..utils.tracer import Tracer
from .metrics import Histogram, MetricsRegistry, quantile_from_buckets
from .spans import Span

PROM_PREFIX = "ouro_"


def _split_labels(name: str) -> tuple:
    """(base, inner-label-text) for names carrying a `{k="v",...}` label
    block (observe/netmetrics.py labeled instruments); ("name", "") for
    plain names."""
    if name.endswith("}") and "{" in name:
        base, labels = name.split("{", 1)
        return base, labels[:-1]
    return name, ""


def _mangle(base: str) -> str:
    out = []
    for ch in base:
        out.append(ch if (ch.isalnum() or ch == "_") else "_")
    return PROM_PREFIX + "".join(out)




def _prom_num(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def prometheus_text(reg: MetricsRegistry,
                    include_unstable: bool = True) -> str:
    """Text exposition of every instrument (unstable ones included by
    default — a scrape endpoint wants live values; pass False for the
    deterministic subset)."""
    lines: List[str] = []
    typed: set = set()
    for inst in reg.instruments():
        if not (inst.stable or include_unstable):
            continue
        base, labels = _split_labels(inst.name)
        name = _mangle(base)
        # ONE TYPE line per base name: labeled series of one base are
        # samples of one metric, and a real Prometheus parser rejects a
        # duplicate TYPE line (instruments iterate in sorted-name order,
        # so same-base series are contiguous)
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {inst.kind}")
        if isinstance(inst, Histogram):
            pre = labels + "," if labels else ""
            suf = f"{{{labels}}}" if labels else ""
            cum = 0
            for edge, c in zip(inst.buckets, inst.counts[:-1]):
                cum += c
                lines.append(f'{name}_bucket{{{pre}le='
                             f'"{_prom_num(edge)}"}} {cum}')
            cum += inst.counts[-1]
            lines.append(f'{name}_bucket{{{pre}le="+Inf"}} {cum}')
            lines.append(f"{name}_sum{suf} {_prom_num(inst.total)}")
            lines.append(f"{name}_count{suf} {inst.count}")
        else:
            suf = f"{{{labels}}}" if labels else ""
            lines.append(f"{name}{suf} {_prom_num(inst.value)}")
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> dict:
    """Minimal exposition parser: {metric_name: float} for plain sample
    lines (bucketed samples keep their label suffix as part of the key).
    Used by the bench smoke gate to assert the exporter round-trips."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            key, val = line.rsplit(None, 1)
            out[key] = float(val)
        except ValueError as e:
            raise ValueError(f"unparseable exposition line: {line!r}") \
                from e
    return out


def prom_histograms(parsed: dict) -> dict:
    """Histogram base names present in a parsed exposition: every metric
    with a `<name>_count` sample and at least one `<name>_bucket{le=..}`
    sample."""
    out = []
    for key in parsed:
        if key.endswith("_count"):
            base = key[:-len("_count")]
            if any(k.startswith(base + '_bucket{le="') for k in parsed):
                out.append(base)
    return {b: parsed[b + "_count"] for b in sorted(out)}


def prom_histogram_quantiles(parsed: dict, base: str,
                             qs=(0.50, 0.95, 0.99)) -> dict:
    """Deterministic quantiles recomputed from a SCRAPED exposition —
    the consumer-side mirror of Histogram.quantiles(), so a remote
    scraper (tools/obsreport.py --live, the acceptance test) extracts
    the same p50/p95/p99 the process would report locally.  `base` is
    the mangled metric name (e.g. "ouro_pipeline_submit_drain_secs")."""
    pre = base + '_bucket{le="'
    pts = []
    for key, v in parsed.items():
        if key.startswith(pre):
            le = key[len(pre):-2]
            if le != "+Inf":
                pts.append((float(le), v))
    pts.sort()
    edges = tuple(p[0] for p in pts)
    counts, prev = [], 0.0
    for _, cum in pts:                     # cumulative -> per-bucket
        counts.append(cum - prev)
        prev = cum
    counts.append(parsed.get(base + "_count", prev) - prev)  # overflow
    return {f"p{round(q * 100)}": quantile_from_buckets(edges, counts, q)
            for q in qs}


# --- chrome://tracing -------------------------------------------------------

def chrome_trace(spans: Iterable[Span], pid: int = 1) -> dict:
    """`trace_event` JSON for a forest of span trees.  Each category gets
    its own tid row so the five replay phases render as parallel tracks;
    timestamps are the spans' monotonic clock readings in microseconds
    (chrome only cares about relative position)."""
    events: List[dict] = []
    tids: dict = {}

    def emit(sp: Span):
        tid = tids.setdefault(sp.cat, len(tids) + 1)
        ev = {"name": sp.name, "cat": sp.cat, "ph": "X",
              "ts": round(sp.t0 * 1e6, 3),
              "dur": round(sp.duration * 1e6, 3),
              "pid": pid, "tid": tid}
        if sp.meta:
            ev["args"] = sp.meta
        events.append(ev)
        for c in sp.children:
            emit(c)

    for sp in spans:
        emit(sp)
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": cat}} for cat, tid in sorted(
                 tids.items(), key=lambda kv: kv[1])]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: Iterable[Span]) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(spans), f, sort_keys=True)
        f.write("\n")


# --- typed tracer events -> JSONL ------------------------------------------

def _json_safe(v):
    if isinstance(v, (bytes, bytearray)):
        return v.hex()
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {k: _json_safe(x)
                for k, x in dataclasses.asdict(v).items()}
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set, frozenset)):
        return [_json_safe(x) for x in v]
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


def event_record(ev) -> dict:
    """One typed event as a JSON-safe dict: {"type": TypeName, ...fields}.
    Dataclass events contribute their fields (a field literally named
    "type" — none today — would land as "type_" rather than clobber the
    schema key); anything else lands under "payload" (still typed by its
    class name — no string matching)."""
    rec = {"type": type(ev).__name__}
    if dataclasses.is_dataclass(ev) and not isinstance(ev, type):
        for f in dataclasses.fields(ev):
            key = f.name if f.name != "type" else "type_"
            rec[key] = _json_safe(getattr(ev, f.name))
    else:
        rec["payload"] = _json_safe(ev)
    return rec


def events_jsonl(events: Iterable) -> str:
    """Render an event sequence as JSON lines (deterministic: insertion
    order of fields is the dataclass field order; keys not re-sorted so
    `type` leads every line)."""
    return "".join(json.dumps(event_record(ev), separators=(",", ":"))
                   + "\n" for ev in events)


def jsonl_tracer(fh) -> Tracer:
    """A live Tracer writing each event to `fh` as one JSON line — the
    utils/tracer.py -> log-pipeline bridge."""
    def emit(ev):
        fh.write(json.dumps(event_record(ev), separators=(",", ":")))
        fh.write("\n")
    return Tracer(emit)
