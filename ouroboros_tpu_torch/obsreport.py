"""obsreport — human-readable summary of a bench round's observability
sections, and a live view of a running node's scrape endpoint.

    python -m ouroboros_tpu_torch.obsreport BENCH_r05.json
    python -m ouroboros_tpu_torch.obsreport MULTICHIP_r05.json
    python -m ouroboros_tpu_torch.obsreport --live HOST:PORT [--interval 5]
    python -m ouroboros_tpu_torch.obsreport --fleet fleet.json
    python -m ouroboros_tpu_torch.obsreport --flight DIR [--tail 20]

Accepts a raw bench JSON object (what a bench run prints), a
harness record wrapping one under ``parsed`` (the committed
BENCH_r*.json files), or a MULTICHIP_rNN.json mesh-dryrun record
(``{n_devices, rc, tail}`` — the MULTICHIP_OBS/MESH_SCALING JSON lines
are recovered from the stored stdout tail and rendered as a mesh
section: devices, prewarm/compile attribution, per-shard padding waste,
and sharded vs single-device replay throughput when both legs are
recorded).  For a bench round it prints, in order:

- the headline (proofs/s, speedup vs the CPU baseline, rep spread);
- the per-phase table from the ``variance`` section — median / min /
  max / absolute and relative spread per replay phase across the timed
  reps, with the dominant phase (largest absolute spread) starred.
  This is the attributed form of the old bare "vrf spread 45%" warning:
  the starred row names WHERE the cross-rep seconds moved;
- the ``overlap`` section: host-seq seconds hidden under
  in-flight device windows, hidden fraction and producer permit stalls
  — cross-rep medians;
- the ``stream`` section, when the round ran the streaming
  disk->decode->verify engine: read-ahead depth, disk+decode seconds
  hidden under device verify, snapshot write/restore timings and the
  restart probe — rounds without one render unchanged;
- the precompute cache stats (hit/miss/device_fill/eviction);
- the registry metrics snapshot (the deterministic subset bench embeds).

Rounds recorded before the observability layer lack the
``phases``/``variance``/``metrics`` sections and the earliest rounds
lack ``overlap``; each missing section is reported as absent rather
than failing, so the CLI works across the whole BENCH_r*.json history.

``--live ADDR`` scrapes a running process's metrics endpoint
(observe/scrape.py, served over the project's own snocket/SDU
transport) and renders replay progress (blocks done / ETA / blocks per
sec / windows in flight / hidden fraction) plus p50/p95/p99 for every
latency histogram — repeat with ``--interval N``.

``--fleet PATH`` renders a FleetTelemetry report (the JSON dict a chaos
threadnet run leaves on ``ChaosResult.fleet``): time-to-50%/
95%-adoption quantiles, per-edge delivery latency, partition-healing
times, and the per-peer mux byte accounting.

``--flight DIR`` renders a flight-recorder dump directory
(observe/flight.py): the reason header, aggregated metric deltas, and
the last ``--tail`` span/event ring entries — post-mortems no longer
require hand-reading flight.jsonl.

Exit codes: 0 report printed, 2 unreadable/unrecognised input.

Ported from `tools/obsreport.py` (the port imports nothing of the JAX
package or of `tools/`). Copied whole: `PHASES` and the exposition
parsers are the port's `observe/`, `--live` dials through the port's
snockets under its IO runtime, and comments and messages that named old
issues are reworded.
"""
from __future__ import annotations

import json
import sys
from typing import List, Optional

from .observe.spans import PHASES

PHASE_ORDER = PHASES + ("other",)

OVERLAP_MEDIANS = (
    ("host_seq_secs_median", "host-seq total"),
    ("device_secs_median", "device drains"),
    ("host_hidden_secs_median", "host-seq hidden under device"),
    ("hidden_frac_median", "hidden fraction"),
    ("producer_stall_secs_median", "producer permit stalls"),
)


def load_bench(path: str) -> dict:
    """The bench result object from `path` — unwraps a harness record's
    ``parsed`` field and tolerates a list of parsed JSON lines (the
    replay headline is the dict carrying ``metric``)."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict) and "parsed" in doc and "metric" not in doc:
        doc = doc["parsed"]
    if isinstance(doc, list):
        dicts = [d for d in doc if isinstance(d, dict) and "metric" in d]
        if not dicts:
            raise ValueError("no bench result object in JSON list")
        doc = dicts[-1]
    if not isinstance(doc, dict) or "metric" not in doc:
        raise ValueError("not a bench result (no 'metric' field)")
    return doc


def _table(rows: List[List[str]], header: List[str]) -> List[str]:
    widths = [max(len(str(r[i])) for r in [header] + rows)
              for i in range(len(header))]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    lines = [fmt.format(*header), fmt.format(*("-" * w for w in widths))]
    lines += [fmt.format(*(str(c) for c in row)) for row in rows]
    return lines


def _fmt_secs(v) -> str:
    return f"{v:.4f}" if isinstance(v, (int, float)) else "-"


def render(doc: dict) -> str:
    out: List[str] = []

    # -- headline -----------------------------------------------------------
    out.append(f"{doc.get('metric', '?')}: {doc.get('value', '?')} "
               f"{doc.get('unit', '')}".rstrip())
    if "vs_baseline" in doc:
        out.append(f"  vs CPU baseline: {doc['vs_baseline']}x"
                   f"  (reps={doc.get('reps', '?')}, "
                   f"rep spread={doc.get('spread', '?')})")
    bd = doc.get("breakdown")
    if bd:
        out.append(f"  breakdown: device {bd.get('device_secs')}s / "
                   f"host {bd.get('host_secs')}s")

    # -- phase variance -----------------------------------------------------
    out.append("")
    var = doc.get("variance") or {}
    per_phase = var.get("per_phase")
    if per_phase:
        out.append("per-phase seconds across timed reps "
                   "(* = largest absolute spread):")
        dom = var.get("dominant_phase")
        rows = []
        for ph in PHASE_ORDER:
            st = per_phase.get(ph)
            if st is None:
                continue
            rows.append([("*" if ph == dom else " ") + ph,
                         _fmt_secs(st.get("median")),
                         _fmt_secs(st.get("min")),
                         _fmt_secs(st.get("max")),
                         _fmt_secs(st.get("spread_secs")),
                         st.get("spread_rel", "-")])
        out += _table(rows, ["phase", "median", "min", "max",
                             "spread_s", "rel"])
        if dom is not None:
            out.append(f"largest cross-rep spread: '{dom}' "
                       f"({var.get('dominant_spread_secs')}s min->max) — "
                       f"the phase to blame for rep-to-rep variance")
    else:
        out.append("no 'variance' section (round predates the "
                   "observability layer)")

    # -- host/device overlap -------------------------------------------------
    out.append("")
    ov = doc.get("overlap") or {}
    if any(k in ov for k, _ in OVERLAP_MEDIANS):
        reps = len(ov.get("per_rep") or ())
        out.append(f"pipelined-replay overlap (medians over "
                   f"{reps or '?'} reps):")
        rows = [[label, ov.get(key, "-")] for key, label in
                OVERLAP_MEDIANS if key in ov]
        out += _table(rows, ["quantity", "median"])
        hf = ov.get("hidden_frac_median")
        if isinstance(hf, (int, float)):
            out.append(f"{100 * hf:.0f}% of the host sequential pass ran "
                       f"while a window was in flight on device — the "
                       f"closer to 100%, the closer host time is to free")
    else:
        out.append("no 'overlap' section (round predates the threaded "
                   "producer/consumer replay attribution)")

    # -- streaming replay section --------------------------------------------
    # rounds without one render unchanged: the section only appears once
    # a bench round ran the disk->decode->verify engine
    stream = doc.get("stream")
    if stream:
        out.append("")
        out += _render_stream(stream)

    # -- verification-service serve section ---------------------------------
    serve = doc.get("serve")
    if serve:
        out.append("")
        out += _render_serve(serve)

    # -- precompute cache ---------------------------------------------------
    out.append("")
    pc = doc.get("precompute")
    if pc:
        out.append("precompute cache:")
        out += _table([[k, pc[k]] for k in sorted(pc)],
                      ["stat", "value"])
    else:
        out.append("no 'precompute' section")

    # -- metrics snapshot ---------------------------------------------------
    out.append("")
    snap = doc.get("metrics")
    if snap:
        out.append("metrics snapshot (deterministic subset):")
        rows = []
        for name in sorted(snap):
            v = snap[name]
            if isinstance(v, dict):       # histogram
                v = f"count={v.get('count')} sum={v.get('sum')}"
            rows.append([name, v])
        out += _table(rows, ["metric", "value"])
    else:
        out.append("no 'metrics' section")
    return "\n".join(out) + "\n"


def _render_stream(st: dict) -> List[str]:
    """The ``stream`` section of a bench round: the
    disk->decode->verify engine's read-ahead accounting (how many
    storage seconds hid under device verify), and the snapshot write /
    restore timings behind `db_analyser --resume`."""
    out: List[str] = []
    out.append(f"streaming replay (disk -> decode -> verify, read-ahead "
               f"{st.get('read_ahead', '?')} windows):")
    rows = [
        ["blocks streamed", st.get("blocks", "-")],
        ["chunks read", st.get("chunks_read", "-")],
        ["bytes read", st.get("bytes_read", "-")],
        ["era crossings in-stream", st.get("era_crossings", "-")],
        ["prefetch stalls (reader ahead)", st.get("prefetch_stalls",
                                                  "-")],
        ["disk+decode secs", _fmt_secs(st.get("disk_secs"))],
        ["  of which hidden under device", _fmt_secs(
            st.get("disk_hidden_secs"))],
    ]
    out += _table(rows, ["quantity", "value"])
    hf = st.get("disk_hidden_frac")
    if isinstance(hf, (int, float)):
        out.append(f"{100 * hf:.0f}% of disk+decode ran while a window "
                   f"was in flight on device — the read-ahead's hiding "
                   f"power (same reading as the host-seq overlap above)")
    snaps = st.get("snapshots_written")
    if snaps is not None:
        out.append(f"snapshots: {snaps} written in "
                   f"{_fmt_secs(st.get('snapshot_write_secs'))}s; "
                   f"restore scan {_fmt_secs(st.get('restore_secs'))}s"
                   + (f"; resumed from slot {st['resumed_from_slot']}"
                      if st.get("resumed_from_slot") is not None
                      else ""))
    restart = st.get("restart")
    if restart:
        out.append(f"restart probe: reopened from the tip snapshot in "
                   f"{_fmt_secs(restart.get('restore_secs'))}s, "
                   f"{restart.get('blocks_replayed', '?')} blocks "
                   f"re-replayed, state-hash parity "
                   f"{restart.get('state_hash_parity')}")
    return out


def _render_serve(serve: dict) -> List[str]:
    """The ``serve`` section of a bench round: request-latency
    quantiles of the coalescing service vs the unbatched CPU baseline,
    the coalesced-batch-size histogram, and the fallback / deadline-miss
    / back-pressure accounting across the three trace legs."""
    out: List[str] = []
    sat = serve.get("saturated") or {}
    out.append(f"verification service (seed {serve.get('seed', '?')}, "
               f"deadline {serve.get('deadline_secs', '?')}s"
               + (", modeled device costs" if serve.get("modeled_costs")
                  else ", measured device costs") + "):")
    if sat:
        out.append(f"  saturated: {sat.get('requests')} requests, "
                   f"{sat.get('proofs_per_sec')} proofs/s = "
                   f"{sat.get('vs_unbatched_cpu')}x the unbatched "
                   f"per-request CPU baseline "
                   f"({sat.get('cpu_unbatched_proofs_per_sec')} /s)")
        lq, cq = sat.get("latency") or {}, \
            sat.get("cpu_unbatched_latency") or {}
        rows = [["service", lq.get("p50", "-"), lq.get("p95", "-"),
                 lq.get("p99", "-")],
                ["cpu unbatched", cq.get("p50", "-"), cq.get("p95", "-"),
                 cq.get("p99", "-")]]
        out += _table(rows, ["request latency (s)", "p50", "p95", "p99"])
        within = sat.get("p95_within_deadline")
        out.append(f"  p95 within deadline: {within}; deadline misses "
                   f"{sat.get('deadline_misses')} "
                   f"({sat.get('deadline_miss_frac')})")
        hist = sat.get("batch_size_hist") or {}
        if hist:
            out.append("  coalesced batch sizes (size: flushes):")
            out += _table([[k, hist[k]] for k in
                           sorted(hist, key=lambda s: int(s))],
                          ["batch", "count"])
        svc = sat.get("service") or {}
        out.append(f"  device batches {svc.get('device_batches')} "
                   f"({svc.get('device_requests')} reqs) / CPU fallback "
                   f"{svc.get('fallback_batches')} "
                   f"({svc.get('fallback_requests')} reqs)")
    light = serve.get("light_load") or {}
    if light:
        out.append(f"  light load: {light.get('requests')} requests, "
                   f"device batches {light.get('device_batches')} "
                   f"(break-even n*={light.get('break_even_n')}; 0 = "
                   f"every flush took the CPU fallback), "
                   f"{light.get('fallback_requests')} fallback reqs")
    bp = serve.get("backpressure") or {}
    if bp:
        out.append(f"  back-pressure: {bp.get('requests')} requests vs "
                   f"queue {bp.get('max_queue')}: "
                   f"{bp.get('backpressure_waits')} blocked submits, "
                   f"{bp.get('completed')} completed")
    be = (serve.get("break_even") or {}).get("entries") or {}
    if be:
        rows = [[p, be[p].get("n_star"), be[p].get("cpu_secs_per_req"),
                 be[p].get("device_secs_batch")] for p in sorted(be)]
        out += _table(rows, ["primitive", "n*", "cpu s/req",
                             "device s/batch"])
    parity = all(leg.get("parity") for leg in (sat, light, bp) if leg)
    out.append(f"  verdict parity vs CpuRefBackend on every leg: "
               f"{parity}")
    return out


# ---------------------------------------------------------------------------
# MULTICHIP mesh-dryrun rounds
# ---------------------------------------------------------------------------

def load_multichip(path: str) -> Optional[dict]:
    """The multichip harness record from `path`, or None when the file
    is not one (callers fall through to load_bench).  The MULTICHIP_OBS
    and MESH_SCALING JSON lines are parsed out of the stored tail under
    ``obs``/``scaling`` (None when the round died before printing them —
    the rc says how)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(doc, dict) or "rc" not in doc \
            or "n_devices" not in doc:
        return None
    out = {"n_devices": doc.get("n_devices"), "rc": doc.get("rc"),
           "ok": doc.get("ok"), "obs": None, "scaling": None}
    for line in (doc.get("tail") or "").splitlines():
        for marker, key in (("MULTICHIP_OBS ", "obs"),
                            ("MESH_SCALING ", "scaling")):
            i = line.find(marker)
            if i < 0:
                continue
            try:
                out[key] = json.loads(line[i + len(marker):])
            except json.JSONDecodeError:
                pass
    return out


def render_multichip(doc: dict) -> str:
    """Mesh section of a MULTICHIP round: run identity, compile
    attribution, the sharded pipelined replay (parity, throughput,
    per-shard occupancy/padding waste) and the single-device comparison
    leg when the round recorded one."""
    out: List[str] = []
    out.append(f"multichip dryrun: {doc.get('n_devices', '?')} devices, "
               f"rc={doc.get('rc')} "
               f"({'green' if doc.get('rc') == 0 else 'RED'})")
    obs = doc.get("obs")
    if not obs:
        out.append("no MULTICHIP_OBS line in the stored tail (the round "
                   "died before attribution, or predates it)")
        return "\n".join(out) + "\n"

    compile_rows = [[k, obs[k]] for k in sorted(obs)
                    if k.endswith("_compile_secs")]
    if compile_rows:
        out.append("")
        out.append("compile attribution (seconds outside timed regions):")
        out += _table(compile_rows, ["stage", "secs"])
    if "over_budget_after" in obs:
        out.append(f"OVER BUDGET after '{obs['over_budget_after']}' "
                   f"({obs.get('elapsed_secs')}s of "
                   f"{obs.get('budget_secs')}s)")

    sh = obs.get("sharded_replay")
    out.append("")
    if sh:
        out.append("sharded pipelined replay (the real chain, not the "
                   "prewarm window):")
        rows = [[k, sh[k]] for k in sorted(sh) if k != "padding"]
        out += _table(rows, ["field", "value"])
        pad = sh.get("padding") or {}
        if pad:
            out.append("per-shard occupancy / padding waste:")
            out += _table([[k, pad[k]] for k in sorted(pad)],
                          ["stat", "value"])
        single = obs.get("single_device_replay") or {}
        sp, dp = (single.get("proofs_per_sec"),
                  sh.get("proofs_per_sec"))
        if sp and dp:
            out.append(f"sharded vs single-device: {dp} vs {sp} proofs/s "
                       f"({dp / sp:.2f}x on this mesh)")
        elif dp:
            out.append("no single-device leg recorded (budget-gated); "
                       "sharded throughput stands alone")
    else:
        out.append("no sharded_replay section (round predates the "
                   "sharded pipelined replay)")

    scaling = doc.get("scaling")
    if scaling:
        out.append("")
        out.append(f"mesh scaling: wall {scaling.get('wall_secs')} / "
                   f"dispatches per window "
                   f"{scaling.get('dispatches_per_window')} "
                   f"(relative n-vs-1: "
                   f"{scaling.get('relative_wall_n_vs_1')})")
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# --fleet: render a FleetTelemetry report
# ---------------------------------------------------------------------------

def load_fleet(path: str) -> dict:
    """The fleet report dict from `path`; accepts the bare report or a
    wrapper carrying it under ``fleet`` (a dumped ChaosResult)."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict) and "adoption" not in doc \
            and isinstance(doc.get("fleet"), dict):
        doc = doc["fleet"]
    if not isinstance(doc, dict) or "adoption" not in doc \
            or "nodes" not in doc:
        raise ValueError("not a fleet report (no 'adoption'/'nodes')")
    return doc


def _fmt_dist(d: dict) -> List[str]:
    return [str(d.get("n", 0)), _fmt_secs(d.get("p50")),
            _fmt_secs(d.get("p95")), _fmt_secs(d.get("max"))]


def render_fleet(doc: dict) -> str:
    out: List[str] = []
    nodes = doc.get("nodes") or []
    ad = doc.get("adoption") or {}
    out.append(f"fleet telemetry: {len(nodes)} nodes, "
               f"{ad.get('blocks', 0)} blocks tracked "
               f"({ad.get('fully_adopted_blocks', 0)} adopted by every "
               f"node)")
    out.append("")
    out.append("block adoption (seconds from first adoption; "
               "quantiles over blocks):")
    rows = [["time to 50% of nodes"] + _fmt_dist(ad.get("time_to_50")
                                                 or {}),
            ["time to 95% of nodes"] + _fmt_dist(ad.get("time_to_95")
                                                 or {})]
    out += _table(rows, ["quantity", "blocks", "p50", "p95", "max"])

    edges = doc.get("per_edge_delivery") or {}
    out.append("")
    if edges:
        out.append("per-edge delivery latency (receiver first-header-"
                   "seen minus sender adoption, seconds):")
        rows = [[edge] + _fmt_dist(edges[edge]) for edge in sorted(edges)]
        out += _table(rows, ["edge", "n", "p50", "p95", "max"])
    else:
        out.append("no per-edge deliveries recorded")

    parts = doc.get("partitions") or []
    if parts:
        out.append("")
        out.append("partition healing (first cross-group delivery "
                   "after the window):")
        rows = [[p.get("start"), p.get("end"),
                 _fmt_secs(p.get("healed_after_secs"))
                 if p.get("healed_after_secs") is not None
                 else "NEVER"] for p in parts]
        out += _table(rows, ["start", "end", "healed after (s)"])

    mux = doc.get("mux") or {}
    out.append("")
    if mux:
        out.append("per-peer mux accounting (edge|side; bytes are SDU "
                   "payload bytes):")
        rows = []
        for key in sorted(mux):
            m = mux[key]
            rows.append([key, m.get("egress_bytes"),
                         m.get("egress_sdus"), m.get("ingress_bytes"),
                         m.get("ingress_sdus")])
        out += _table(rows, ["connection", "out B", "out SDU",
                             "in B", "in SDU"])
    else:
        out.append("no mux accounting in this report")
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# --flight: render a flight-recorder dump directory
# ---------------------------------------------------------------------------

def load_flight(dir_path: str) -> tuple:
    """(header, records) from DIR/flight.jsonl (observe/flight.py dump
    layout).  Raises on a missing/garbled dump."""
    import os
    path = os.path.join(dir_path, "flight.jsonl")
    header: Optional[dict] = None
    records: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if header is None and rec.get("kind") == "flight":
                header = rec
                continue
            records.append(rec)
    if header is None:
        raise ValueError(f"{path}: no flight header line")
    return header, records


def render_flight(header: dict, records: List[dict],
                  tail: int = 20) -> str:
    out: List[str] = []
    out.append(f"flight dump: {header.get('entries')} ring entries — "
               f"reason: {header.get('reason') or '(none)'}")

    # -- aggregated metric deltas -------------------------------------------
    deltas: dict = {}
    for r in records:
        if r.get("kind") != "metric":
            continue
        name, op, v = r.get("name"), r.get("op"), r.get("v")
        d = deltas.setdefault(name, {"inc": 0, "observe": 0,
                                     "set": None})
        if op == "inc":
            d["inc"] += v
        elif op == "observe":
            d["observe"] += 1
        elif op == "set":
            d["set"] = v
    out.append("")
    if deltas:
        out.append("metric deltas over the ring:")
        rows = []
        for name in sorted(deltas):
            d = deltas[name]
            what = []
            if d["inc"]:
                what.append(f"+{d['inc']}")
            if d["observe"]:
                what.append(f"{d['observe']} obs")
            if d["set"] is not None:
                what.append(f"last={d['set']}")
            rows.append([name, " ".join(what) or "-"])
        out += _table(rows, ["metric", "delta"])
    else:
        out.append("no metric entries in the ring")

    # -- span/event tail -----------------------------------------------------
    trail = [r for r in records if r.get("kind") in ("span", "event")]
    out.append("")
    out.append(f"last {min(tail, len(trail))} span/event entries "
               f"(of {len(trail)}):")
    for r in trail[-tail:]:
        if r.get("kind") == "span":
            out.append(f"  {r.get('t'):>14.6f}  span   "
                       f"[{r.get('cat')}] {r.get('name')} "
                       f"({(r.get('t1') - r.get('t0')):.6f}s)")
        else:
            detail = {k: v for k, v in r.items()
                      if k not in ("t", "kind")}
            out.append(f"  {r.get('t'):>14.6f}  event  "
                       f"{json.dumps(detail, sort_keys=True)[:120]}")
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# --live: render a scraped exposition (replay progress + latency quantiles)
# ---------------------------------------------------------------------------

PROGRESS_GAUGES = (
    ("ouro_replay_progress_blocks_done", "blocks done"),
    ("ouro_replay_progress_total_blocks", "total blocks"),
    ("ouro_replay_progress_windows_in_flight", "windows in flight"),
    ("ouro_replay_progress_blocks_per_sec", "blocks/sec"),
    ("ouro_replay_progress_eta_secs", "ETA (s)"),
    ("ouro_replay_progress_hidden_frac", "hidden fraction"),
    ("ouro_replay_progress_devices", "mesh devices"),
    ("ouro_replay_progress_padding_waste_frac", "padding waste frac"),
)


def render_live(parsed: dict) -> str:
    """One live frame from a parsed exposition: replay progress, then
    p50/p95/p99 of every histogram present (recomputed scraper-side from
    the cumulative buckets — byte-identical to the serving process's own
    quantiles for the same counts)."""
    from .observe.export import prom_histogram_quantiles, prom_histograms
    out: List[str] = []
    prog = [(label, parsed[key]) for key, label in PROGRESS_GAUGES
            if key in parsed]
    if prog:
        done = parsed.get("ouro_replay_progress_blocks_done")
        total = parsed.get("ouro_replay_progress_total_blocks")
        if total:
            out.append(f"replay progress: {done:.0f}/{total:.0f} blocks "
                       f"({100 * done / total:.1f}%)")
        out.append("")
        out += _table([[l, v] for l, v in prog], ["progress", "value"])
    else:
        out.append("no replay.progress.* gauges in this exposition")
    out.append("")
    hists = prom_histograms(parsed)
    if hists:
        rows = []
        for base, count in sorted(hists.items()):
            if not count:
                continue               # nothing observed yet: skip
            q = prom_histogram_quantiles(parsed, base)
            rows.append([base, int(count), q["p50"], q["p95"], q["p99"]])
        out.append("latency/size histograms (quantiles from scraped "
                   "buckets):")
        out += _table(rows, ["histogram", "count", "p50", "p95", "p99"])
    return "\n".join(out) + "\n"


def _live_once(addr: str) -> str:
    """One scrape over the project transport: host:port dials TCP, a
    /path dials the Unix socket."""
    from .network.snocket import snocket_for
    from .observe.scrape import scrape
    from .simharness import io_run
    if addr.startswith("/"):
        target: object = addr
    else:
        host, port = addr.rsplit(":", 1)
        target = (host, int(port))
    return io_run(scrape(snocket_for(target), target))


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m ouroboros_tpu_torch.obsreport",
        description="render a bench round's observability sections, or "
                    "--live: a running node's scrape endpoint")
    ap.add_argument("path", nargs="?", help="BENCH_rNN.json round file")
    ap.add_argument("--live", metavar="ADDR",
                    help="scrape host:port (or /unix/path) and render "
                         "replay progress + latency quantiles")
    ap.add_argument("--interval", type=float, default=0.0,
                    help="with --live: re-scrape every N seconds until "
                         "interrupted (default: once)")
    ap.add_argument("--fleet", metavar="PATH",
                    help="render a FleetTelemetry report JSON (a chaos "
                         "run's ChaosResult.fleet)")
    ap.add_argument("--flight", metavar="DIR",
                    help="render a flight-recorder dump directory")
    ap.add_argument("--tail", type=int, default=20,
                    help="with --flight: span/event tail length "
                         "(default 20)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    modes = [m for m in (args.path, args.live, args.fleet, args.flight)
             if m is not None]
    if len(modes) != 1:
        ap.print_usage(sys.stderr)
        print("obsreport: give exactly one of PATH, --live ADDR, "
              "--fleet PATH or --flight DIR", file=sys.stderr)
        return 2
    if args.fleet:
        try:
            doc = load_fleet(args.fleet)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"obsreport: cannot read {args.fleet}: {e}",
                  file=sys.stderr)
            return 2
        sys.stdout.write(render_fleet(doc))
        return 0
    if args.flight:
        try:
            header, records = load_flight(args.flight)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"obsreport: cannot read flight dump {args.flight}: "
                  f"{e}", file=sys.stderr)
            return 2
        sys.stdout.write(render_flight(header, records, tail=args.tail))
        return 0
    if args.live:
        from .observe.export import parse_prometheus_text
        try:
            while True:
                sys.stdout.write(
                    render_live(parse_prometheus_text(
                        _live_once(args.live))))
                sys.stdout.flush()
                if args.interval <= 0:
                    return 0
                import time
                time.sleep(args.interval)
                sys.stdout.write("\n")
        except KeyboardInterrupt:
            return 0
        except Exception as e:
            print(f"obsreport: cannot scrape {args.live}: {e}",
                  file=sys.stderr)
            return 2
    mc = load_multichip(args.path)
    if mc is not None:
        sys.stdout.write(render_multichip(mc))
        return 0
    try:
        doc = load_bench(args.path)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"obsreport: cannot read {args.path}: {e}", file=sys.stderr)
        return 2
    sys.stdout.write(render(doc))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
