"""The port's operator tools and observability layer:

- `python -m ouroboros_tpu_torch.perfgate` and `python -m
  ouroboros_tpu_torch.obsreport`: the perfgate and obsreport cases of
  tests/test_tools.py, run against the port's copies (they read the
  committed BENCH_r0*.json and MULTICHIP_r0*.json files and never write
  one); each verdict and each render equal to the JAX package's tool on
  the same input (tools/perfgate.py, tools/obsreport.py; where the port
  rewords a message that named an old issue, the rest is compared);
- `ouroboros_tpu_torch.observe`: the cases of tests/test_observe.py,
  against the JAX package's golden exporter bytes (its fence case reads
  the card's, not JAX's; its case of the precompute cache's hit and miss
  counters waits for the port's cache to count them, ROADMAP queue 1
  item 3);
- `python -m ouroboros_tpu_torch.ping`: tests/test_snocket.py's
  ping-tool case against a port node served over TCP.

Tolerance: none.  Verdicts, rendered text and bytes compare exactly.
"""
import glob
import io
import json
import os
import subprocess
import sys

import pytest

from ouroboros_tpu_torch import simharness as sim
from ouroboros_tpu_torch.observe import adapter, export, metrics, spans
from ouroboros_tpu_torch.observe.metrics import MetricsRegistry
from ouroboros_tpu_torch.observe.spans import Span, SpanRecorder
from ouroboros_tpu_torch.utils.tracer import (
    TraceAddBlock, TraceChainSyncEvent, TraceFetchDecision,
    TraceForgeEvent, collecting,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "golden", "observe")


def _run(*argv):
    return subprocess.run([sys.executable, *argv], cwd=REPO,
                          capture_output=True, text=True, timeout=120)


# ---------------------------------------------------------------------------
# perfgate: the BENCH trajectory as an enforced gate
# ---------------------------------------------------------------------------

def test_perfgate_passes_on_committed_trajectory():
    """Acceptance: rc 0 over the real recorded BENCH_r01..rNN rounds."""
    import glob
    rounds = sorted(glob.glob(os.path.join(REPO, "BENCH_r*.json")))
    assert len(rounds) >= 5
    r = _run("-m", "ouroboros_tpu_torch.perfgate", "--check", *rounds)
    assert r.returncode == 0, r.stdout + r.stderr
    verdict = json.loads(r.stdout)
    assert verdict["ok"] is True
    results = {c["check"]: c["result"] for c in verdict["checks"]}
    assert results["vs_baseline"] == "pass"


def _regressed_round(tmp_path, **fields):
    import glob
    import shutil
    d = tmp_path / "traj"
    d.mkdir()
    for p in sorted(glob.glob(os.path.join(REPO, "BENCH_r0*.json"))):
        shutil.copy(p, d)
    doc = {"metric": "shelley_replay_proofs_per_sec", "value": 5000.0,
           "unit": "proofs/s", **fields}
    (d / "BENCH_r06.json").write_text(
        json.dumps({"n": 6, "rc": 0, "parsed": doc}))
    return sorted(str(p) for p in d.glob("BENCH_r0*.json"))


def test_perfgate_fails_on_synthetic_regressed_round(tmp_path):
    """Acceptance: a regressed r06 (vs_baseline dropped past the floor,
    spread blown, hidden_frac collapsed) exits rc 1 with every check
    named FAIL."""
    paths = _regressed_round(tmp_path, vs_baseline=6.0, spread=0.6,
                             overlap={"hidden_frac_median": 0.05})
    r = _run("-m", "ouroboros_tpu_torch.perfgate", "--check", *paths)
    assert r.returncode == 1, r.stdout + r.stderr
    results = {c["check"]: c["result"]
               for c in json.loads(r.stdout)["checks"]}
    assert results == {"vs_baseline": "FAIL", "rep_spread": "FAIL",
                       "hidden_frac": "FAIL"}


def test_perfgate_single_check_failure_and_thresholds(tmp_path):
    """A round that only regresses spread fails exactly that check, and
    a loosened threshold flips it back to rc 0 (thresholds are real
    knobs, not decoration)."""
    paths = _regressed_round(tmp_path, vs_baseline=13.0, spread=0.6)
    r = _run("-m", "ouroboros_tpu_torch.perfgate", "--check", *paths)
    assert r.returncode == 1
    results = {c["check"]: c["result"]
               for c in json.loads(r.stdout)["checks"]}
    assert results["vs_baseline"] == "pass"
    assert results["rep_spread"] == "FAIL"
    assert results["hidden_frac"] == "skipped"
    r2 = _run("-m", "ouroboros_tpu_torch.perfgate", "--max-spread", "0.7",
              "--check", *paths)
    assert r2.returncode == 0, r2.stdout


def test_perfgate_tightened_spread_binds_from_r06(tmp_path):
    """The rep-spread bound tightened 0.45 -> 0.35
    now that the GC-discipline fix and the ('vrff', m) autotune key
    landed.  A 0.40-spread r06 — fine under the old bound —
    fails; the committed r01-r05 history stays tolerated (the legacy
    bound applies to rounds predating the variance fixes)."""
    paths = _regressed_round(tmp_path, vs_baseline=13.0, spread=0.40)
    r = _run("-m", "ouroboros_tpu_torch.perfgate", "--check", *paths)
    assert r.returncode == 1, r.stdout + r.stderr
    results = {c["check"]: c["result"]
               for c in json.loads(r.stdout)["checks"]}
    assert results["rep_spread"] == "FAIL"
    assert results["vs_baseline"] == "pass"
    # history alone (latest = r05) still passes under the legacy bound
    import glob
    rounds = sorted(glob.glob(os.path.join(REPO, "BENCH_r0*.json")))
    r2 = _run("-m", "ouroboros_tpu_torch.perfgate", "--check", *rounds)
    assert r2.returncode == 0, r2.stdout + r2.stderr


def test_perfgate_unreadable_input_is_rc2(tmp_path):
    bad = tmp_path / "BENCH_r99.json"
    bad.write_text("not json")
    r = _run("-m", "ouroboros_tpu_torch.perfgate", "--check", str(bad))
    assert r.returncode == 2 and "cannot judge" in r.stderr
    r2 = _run("-m", "ouroboros_tpu_torch.perfgate")
    assert r2.returncode == 2


# ---------------------------------------------------------------------------
# perfgate --multichip: the mesh-dryrun trajectory as a gate
# ---------------------------------------------------------------------------

def _multichip_round(tmp_path, n, rc, obs=None):
    tail = "harness noise\n"
    if obs is not None:
        tail += "MULTICHIP_OBS " + json.dumps(obs) + "\nmore noise\n"
    p = tmp_path / f"MULTICHIP_r{n:02d}.json"
    p.write_text(json.dumps({"n_devices": 8, "rc": rc, "ok": rc == 0,
                             "skipped": False, "tail": tail}))
    return str(p)


_GREEN_OBS = {"n_devices": 8, "prewarm_compile_secs": 201.3,
              "sharded_validate_compile_secs": 55.0,
              "state_hash_parity": True,
              "sharded_replay": {"blocks": 24, "proofs": 96,
                                 "proofs_per_sec": 140.0,
                                 "state_hash_parity": True}}


def test_perfgate_multichip_tolerates_presharded_history():
    """The committed MULTICHIP_r01..r05 rounds predate the sharded
    replay (r05 is a red rc=124 with no MULTICHIP_OBS at all): the gate
    reports every check skipped and passes — tier-1 must not fail
    retroactively on history the gate could never have enforced."""
    import glob
    rounds = sorted(glob.glob(os.path.join(REPO, "MULTICHIP_r*.json")))
    assert len(rounds) >= 5
    r = _run("-m", "ouroboros_tpu_torch.perfgate", "--multichip", *rounds)
    assert r.returncode == 0, r.stdout + r.stderr
    mc = json.loads(r.stdout)["multichip"]
    assert mc["ok"] is True and mc["binding"] is False
    assert {c["result"] for c in mc["checks"]} == {"skipped"}


def test_perfgate_multichip_green_round_binds_and_passes(tmp_path):
    """A green r06 carrying the sharded_replay obs makes the gate
    binding: rc, compile attribution and parity all pass (rc 0)."""
    paths = [_multichip_round(tmp_path, 5, 124),
             _multichip_round(tmp_path, 6, 0, obs=_GREEN_OBS)]
    r = _run("-m", "ouroboros_tpu_torch.perfgate", "--multichip", *paths)
    assert r.returncode == 0, r.stdout + r.stderr
    mc = json.loads(r.stdout)["multichip"]
    assert mc["binding"] is True
    assert {c["check"]: c["result"] for c in mc["checks"]} == {
        "rc": "pass", "compile_attribution": "pass",
        "sharded_replay_parity": "pass"}


def test_perfgate_multichip_fails_red_round_after_green(tmp_path):
    """Once a green sharded round is recorded, a later red (timeout
    with no OBS line) fails every check — the MULTICHIP_r05 failure
    mode becomes a merge-gate regression instead of a shrug."""
    paths = [_multichip_round(tmp_path, 6, 0, obs=_GREEN_OBS),
             _multichip_round(tmp_path, 7, 124)]
    r = _run("-m", "ouroboros_tpu_torch.perfgate", "--multichip", *paths)
    assert r.returncode == 1, r.stdout + r.stderr
    mc = json.loads(r.stdout)["multichip"]
    assert {c["check"]: c["result"] for c in mc["checks"]} == {
        "rc": "FAIL", "compile_attribution": "FAIL",
        "sharded_replay_parity": "FAIL"}


def test_perfgate_multichip_fails_lost_parity(tmp_path):
    """An rc=0 round whose sharded replay lost state-hash parity fails
    exactly the parity check."""
    bad_obs = dict(_GREEN_OBS,
                   sharded_replay={"state_hash_parity": False})
    paths = [_multichip_round(tmp_path, 6, 0, obs=_GREEN_OBS),
             _multichip_round(tmp_path, 7, 0, obs=bad_obs)]
    r = _run("-m", "ouroboros_tpu_torch.perfgate", "--multichip", *paths)
    assert r.returncode == 1
    results = {c["check"]: c["result"]
               for c in json.loads(r.stdout)["multichip"]["checks"]}
    assert results == {"rc": "pass", "compile_attribution": "pass",
                       "sharded_replay_parity": "FAIL"}


def test_perfgate_bench_and_multichip_combined(tmp_path):
    """--check and --multichip compose: one verdict, ok only when both
    trajectories pass."""
    import glob
    bench_rounds = sorted(glob.glob(os.path.join(REPO,
                                                 "BENCH_r0*.json")))
    mc = [_multichip_round(tmp_path, 6, 0, obs=_GREEN_OBS),
          _multichip_round(tmp_path, 7, 124)]
    r = _run("-m", "ouroboros_tpu_torch.perfgate", "--check", *bench_rounds,
             "--multichip", *mc)
    assert r.returncode == 1          # bench passes, multichip fails
    doc = json.loads(r.stdout)
    assert doc["ok"] is False
    assert all(c["result"] != "FAIL" for c in doc["checks"])


def _serve_round(tmp_path, n, serve=None):
    doc = {"metric": "shelley_replay_proofs_per_sec", "value": 5000.0,
           "unit": "proofs/s", "vs_baseline": 13.0}
    if serve is not None:
        doc["serve"] = serve
    p = tmp_path / f"BENCH_r{n:02d}.json"
    p.write_text(json.dumps({"n": n, "rc": 0, "parsed": doc}))
    return str(p)


_GREEN_SERVE = {"seed": 7, "deadline_secs": 0.05,
                "saturated": {"vs_unbatched_cpu": 6.3,
                              "p95_within_deadline": True}}


def test_perfgate_serve_skips_on_preservice_history():
    """The committed r01-r05 rounds predate the
    serve section — every serve check reports skipped and the gate
    passes (same binding pattern as --multichip)."""
    import glob
    rounds = sorted(glob.glob(os.path.join(REPO, "BENCH_r0*.json")))
    r = _run("-m", "ouroboros_tpu_torch.perfgate", "--serve", *rounds)
    assert r.returncode == 0, r.stdout + r.stderr
    sv = json.loads(r.stdout)["serve"]
    assert sv["ok"] is True and sv["binding"] is False
    assert {c["result"] for c in sv["checks"]} == {"skipped"}


def test_perfgate_serve_binds_and_gates(tmp_path):
    """A round carrying a serve section makes the gate binding: the
    5x-vs-unbatched floor and the p95-inside-deadline bar both
    enforce."""
    good = [_serve_round(tmp_path, 5),
            _serve_round(tmp_path, 6, serve=_GREEN_SERVE)]
    r = _run("-m", "ouroboros_tpu_torch.perfgate", "--serve", *good)
    assert r.returncode == 0, r.stdout + r.stderr
    sv = json.loads(r.stdout)["serve"]
    assert sv["binding"] is True
    assert {c["check"]: c["result"] for c in sv["checks"]} == {
        "serve_vs_unbatched": "pass", "serve_p95_deadline": "pass"}

    slow = dict(_GREEN_SERVE,
                saturated={"vs_unbatched_cpu": 3.0,
                           "p95_within_deadline": True})
    d2 = tmp_path / "slow"
    d2.mkdir()
    bad = [_serve_round(d2, 6, serve=_GREEN_SERVE),
           _serve_round(d2, 7, serve=slow)]
    r = _run("-m", "ouroboros_tpu_torch.perfgate", "--serve", *bad)
    assert r.returncode == 1, r.stdout + r.stderr
    results = {c["check"]: c["result"]
               for c in json.loads(r.stdout)["serve"]["checks"]}
    assert results == {"serve_vs_unbatched": "FAIL",
                       "serve_p95_deadline": "pass"}

    missed = dict(_GREEN_SERVE,
                  saturated={"vs_unbatched_cpu": 6.0,
                             "p95_within_deadline": False})
    d3 = tmp_path / "missed"
    d3.mkdir()
    bad = [_serve_round(d3, 6, serve=_GREEN_SERVE),
           _serve_round(d3, 7, serve=missed)]
    r = _run("-m", "ouroboros_tpu_torch.perfgate", "--serve", *bad)
    assert r.returncode == 1
    results = {c["check"]: c["result"]
               for c in json.loads(r.stdout)["serve"]["checks"]}
    assert results == {"serve_vs_unbatched": "pass",
                       "serve_p95_deadline": "FAIL"}


def test_obsreport_renders_mesh_section(tmp_path):
    """A MULTICHIP round with the full obs renders devices,
    compile attribution, sharded replay parity/throughput, per-shard
    padding waste, and the sharded-vs-single-device comparison."""
    obs = dict(_GREEN_OBS)
    obs["sharded_replay"] = dict(
        _GREEN_OBS["sharded_replay"],
        padding={"windows": 6, "lanes_used": 112, "lanes_padded": 192,
                 "waste_frac": 0.4167, "shards": 8,
                 "lanes_per_shard_per_window": 4})
    obs["single_device_replay"] = {"secs": 2.0, "proofs_per_sec": 70.0}
    p = _multichip_round(tmp_path, 6, 0, obs=obs)
    r = _run("-m", "ouroboros_tpu_torch.obsreport", p)
    assert r.returncode == 0, r.stderr
    assert "8 devices, rc=0 (green)" in r.stdout
    assert "prewarm_compile_secs" in r.stdout and "201.3" in r.stdout
    assert "state_hash_parity" in r.stdout
    assert "waste_frac" in r.stdout and "0.4167" in r.stdout
    assert "sharded vs single-device: 140.0 vs 70.0 proofs/s (2.00x" \
        in r.stdout


def test_obsreport_renders_overlap_section(tmp_path):
    """Regression: a BENCH_r06-shaped round — the
    `overlap` section with per-rep attributions and medians —
    renders the hidden-fraction/producer-stall medians instead of being
    silently dropped."""
    doc = {
        "metric": "shelley_replay_proofs_per_sec", "value": 20000.0,
        "unit": "proofs/s", "vs_baseline": 15.0, "reps": 5,
        "spread": 0.12,
        "overlap": {
            "per_rep": [
                {"host_seq_secs": 0.8, "device_secs": 2.9,
                 "host_hidden_secs": 0.7, "hidden_frac": 0.875,
                 "producer_stall_secs": 0.05}] * 5,
            "host_seq_secs_median": 0.8,
            "device_secs_median": 2.9,
            "host_hidden_secs_median": 0.7,
            "hidden_frac_median": 0.875,
            "producer_stall_secs_median": 0.05},
    }
    raw = tmp_path / "bench_r06_shape.json"
    raw.write_text(json.dumps(doc))
    wrapped = tmp_path / "BENCH_r06.json"
    wrapped.write_text(json.dumps({"n": 6, "rc": 0, "parsed": doc}))
    for p in (raw, wrapped):
        r = _run("-m", "ouroboros_tpu_torch.obsreport", str(p))
        assert r.returncode == 0, r.stderr
        assert "pipelined-replay overlap (medians over 5 reps)" \
            in r.stdout
        assert "hidden fraction" in r.stdout and "0.875" in r.stdout
        assert "producer permit stalls" in r.stdout and "0.05" in r.stdout
        assert "88% of the host sequential pass" in r.stdout
    # rounds without the section say so instead of rendering nothing
    r = _run("-m", "ouroboros_tpu_torch.obsreport", "BENCH_r05.json")
    assert r.returncode == 0
    assert "no 'overlap' section" in r.stdout


def test_obsreport_renders_serve_section(tmp_path):
    """A round carrying the ``serve`` section (the
    adaptive batching service bench) renders the latency-quantile
    table, the coalesced-batch-size histogram and the fallback /
    deadline-miss / back-pressure accounting."""
    doc = {
        "metric": "verify_service_serve", "value": 6300.0,
        "unit": "proofs/s",
        "serve": {
            "seed": 7, "deadline_secs": 0.05, "modeled_costs": True,
            "break_even": {"device_kind": "modeled-device",
                           "entries": {"ed25519": {
                               "n_star": 3, "cpu_secs_per_req": 1e-3,
                               "device_secs_batch": 0.00712,
                               "bucket": 256}}},
            "saturated": {
                "requests": 2000, "proofs_per_sec": 6300.0,
                "cpu_unbatched_proofs_per_sec": 1000.0,
                "vs_unbatched_cpu": 6.3,
                "latency": {"p50": 0.026, "p95": 0.045, "p99": 0.051},
                "cpu_unbatched_latency": {"p50": 1.62, "p95": 3.26,
                                          "p99": 3.40},
                "p95_within_deadline": True, "deadline_misses": 45,
                "deadline_miss_frac": 0.011,
                "batch_size_hist": {"256": 7, "180": 1},
                "service": {"device_batches": 57,
                            "device_requests": 2000,
                            "fallback_batches": 0,
                            "fallback_requests": 0},
                "parity": True, "leaked_threads": 0},
            "light_load": {"requests": 21, "break_even_n": 3,
                           "device_batches": 0,
                           "fallback_requests": 21, "parity": True,
                           "leaked_threads": 0},
            "backpressure": {"requests": 198, "max_queue": 32,
                             "backpressure_waits": 166,
                             "completed": 198, "parity": True,
                             "leaked_threads": 0},
        },
    }
    p = tmp_path / "serve.json"
    p.write_text(json.dumps(doc))
    r = _run("-m", "ouroboros_tpu_torch.obsreport", str(p))
    assert r.returncode == 0, r.stderr
    assert "verification service" in r.stdout
    assert "6.3x the unbatched per-request CPU baseline" in r.stdout
    assert "p95 within deadline: True" in r.stdout
    assert "coalesced batch sizes" in r.stdout
    assert "device batches 0" in r.stdout          # light-load line
    assert "166 blocked submits" in r.stdout
    assert "verdict parity vs CpuRefBackend on every leg: True" \
        in r.stdout
    # a round without the section renders unchanged
    r2 = _run("-m", "ouroboros_tpu_torch.obsreport", "BENCH_r05.json")
    assert r2.returncode == 0
    assert "verification service" not in r2.stdout


def test_obsreport_renders_stream_section(tmp_path):
    """A round carrying the ``stream`` section (the
    disk->decode->verify engine leg) renders the read-ahead hiding
    accounting and the snapshot/restart timings; rounds without one
    render unchanged."""
    doc = {
        "metric": "shelley_replay_proofs_per_sec", "value": 20000.0,
        "unit": "proofs/s", "vs_baseline": 15.0,
        "stream": {
            "blocks": 10000, "replay_secs": 4.1, "chunks_read": 125,
            "blocks_decoded": 10000, "bytes_read": 6_400_000,
            "era_crossings": 1, "prefetch_stalls": 12, "read_ahead": 4,
            "disk_secs": 1.9, "disk_hidden_secs": 1.7,
            "disk_hidden_frac": 0.894, "host_seq_secs": 0.9,
            "host_hidden_secs": 0.8, "snapshots_written": 5,
            "snapshot_write_secs": 0.21, "restore_secs": 0.0,
            "resumed_from_slot": None,
            "state_hash_parity": True, "proofs_per_sec": 14634.1,
            "restart": {"restore_secs": 0.034, "blocks_replayed": 0,
                        "state_hash_parity": True},
        },
    }
    p = tmp_path / "stream.json"
    p.write_text(json.dumps(doc))
    r = _run("-m", "ouroboros_tpu_torch.obsreport", str(p))
    assert r.returncode == 0, r.stderr
    assert "streaming replay (disk -> decode -> verify, read-ahead 4" \
        in r.stdout
    assert "89% of disk+decode ran while a window was in flight" \
        in r.stdout
    assert "era crossings in-stream" in r.stdout
    assert "snapshots: 5 written" in r.stdout
    assert "restart probe" in r.stdout and "0.0340" in r.stdout
    assert "state-hash parity True" in r.stdout
    # a round without the section renders unchanged
    r2 = _run("-m", "ouroboros_tpu_torch.obsreport", "BENCH_r05.json")
    assert r2.returncode == 0
    assert "streaming replay" not in r2.stdout


def test_obsreport_live_flag_wired():
    r = _run("-m", "ouroboros_tpu_torch.obsreport", "--help")
    assert r.returncode == 0, r.stderr
    assert "--live" in r.stdout and "--interval" in r.stdout
    # --live against a dead port is a clean rc 2, not a traceback
    r2 = _run("-m", "ouroboros_tpu_torch.obsreport", "--live", "127.0.0.1:1")
    assert r2.returncode == 2 and "cannot scrape" in r2.stderr
    # PATH and --live are mutually exclusive
    r3 = _run("-m", "ouroboros_tpu_torch.obsreport")
    assert r3.returncode == 2


def test_obsreport_fleet_renderer(tmp_path):
    """--fleet renders a FleetTelemetry report (bare dict or one nested
    under a dumped ChaosResult's `fleet` key); junk is rc 2."""
    fleet = {
        "nodes": ["node0", "node1"],
        "adoption": {"blocks": 3, "fully_adopted_blocks": 2,
                     "time_to_50": {"n": 3, "p50": 0.1, "p95": 0.2,
                                    "max": 0.2},
                     "time_to_95": {"n": 2, "p50": 0.3, "p95": 0.5,
                                    "max": 0.5},
                     "per_block": []},
        "per_edge_delivery": {"node0->node1": {"n": 4, "p50": 0.05,
                                               "p95": 0.07,
                                               "max": 0.07}},
        "partitions": [{"start": 3.0, "end": 5.0,
                        "healed_after_secs": 0.42},
                       {"start": 9.0, "end": 11.0,
                        "healed_after_secs": None}],
        "mux": {"node0->node1|i": {"ingress_bytes": 100,
                                   "egress_bytes": 200,
                                   "ingress_sdus": 2, "egress_sdus": 3,
                                   "by_proto": {}}},
    }
    bare = tmp_path / "fleet.json"
    bare.write_text(json.dumps(fleet))
    wrapped = tmp_path / "chaos.json"
    wrapped.write_text(json.dumps({"seed": 7, "fleet": fleet}))
    for p in (bare, wrapped):
        r = _run("-m", "ouroboros_tpu_torch.obsreport", "--fleet", str(p))
        assert r.returncode == 0, r.stderr
        assert "2 nodes, 3 blocks tracked" in r.stdout
        assert "time to 95% of nodes" in r.stdout
        assert "node0->node1" in r.stdout
        assert "0.4200" in r.stdout and "NEVER" in r.stdout
        assert "node0->node1|i" in r.stdout
    bad = tmp_path / "junk.json"
    bad.write_text('{"not": "a fleet report"}')
    r = _run("-m", "ouroboros_tpu_torch.obsreport", "--fleet", str(bad))
    assert r.returncode == 2 and "cannot read" in r.stderr


def test_obsreport_flight_renderer(tmp_path):
    """--flight renders a flight-recorder dump dir: reason header,
    aggregated metric deltas, span/event tail.  A dir without a dump is
    rc 2."""
    from ouroboros_tpu_torch.observe import flight as fl
    from ouroboros_tpu_torch.observe import metrics as om
    from ouroboros_tpu_torch.observe import spans as sp
    reg = om.MetricsRegistry()
    rec = sp.SpanRecorder()
    f = fl.FlightRecorder(registry=reg, recorder=rec)
    f.arm()
    try:
        c = reg.counter("probe.count")
        c.inc(3)
        c.inc(2)
        reg.gauge("probe.gauge").set(7)
        with rec.span("w", cat="device"):
            pass
        f.note(("tail", "event"))
        d = tmp_path / "dump"
        f.dump(str(d), reason="unit probe")
    finally:
        f.disarm()
    r = _run("-m", "ouroboros_tpu_torch.obsreport", "--flight", str(d))
    assert r.returncode == 0, r.stderr
    assert "reason: unit probe" in r.stdout
    assert "probe.count" in r.stdout and "+5" in r.stdout
    assert "last=7" in r.stdout
    assert "[device] w" in r.stdout
    r2 = _run("-m", "ouroboros_tpu_torch.obsreport", "--flight", str(tmp_path / "no"))
    assert r2.returncode == 2 and "cannot read flight dump" in r2.stderr


def test_obsreport_cli(tmp_path):
    """`python -m ouroboros_tpu_torch.obsreport` renders a bench JSON (raw or
    harness-wrapped) as the phase/variance/cache summary table, and
    reports pre-observability rounds' sections as absent."""
    doc = {
        "metric": "shelley_replay_proofs_per_sec", "value": 1000.0,
        "unit": "proofs/s", "vs_baseline": 10.0, "reps": 2,
        "spread": 0.1,
        "variance": {
            "per_phase": {
                "device": {"median": 2.0, "min": 1.5, "max": 2.5,
                           "spread_secs": 1.0, "spread_rel": 0.5},
                "host-seq": {"median": 1.0, "min": 0.9, "max": 1.1,
                             "spread_secs": 0.2, "spread_rel": 0.2}},
            "dominant_phase": "device", "dominant_spread_secs": 1.0},
        "precompute": {"hits": 5, "misses": 1},
        "metrics": {"precompute.hits": 5,
                    "d.sizes": {"count": 2, "sum": 3}},
    }
    raw = tmp_path / "bench.json"
    raw.write_text(json.dumps(doc))
    wrapped = tmp_path / "BENCH_rXX.json"
    wrapped.write_text(json.dumps({"n": 1, "rc": 0, "parsed": doc}))
    for p in (raw, wrapped):
        r = _run("-m", "ouroboros_tpu_torch.obsreport", str(p))
        assert r.returncode == 0, r.stderr
        assert "largest cross-rep spread: 'device'" in r.stdout
        assert "*device" in r.stdout and "precompute.hits" in r.stdout
    # historic rounds (no phases/variance/metrics) still render
    r = _run("-m", "ouroboros_tpu_torch.obsreport", "BENCH_r05.json")
    assert r.returncode == 0, r.stderr
    assert "no 'variance' section" in r.stdout
    # a MULTICHIP round renders the mesh section — the
    # committed red r05 has no MULTICHIP_OBS in its tail, and says so
    r = _run("-m", "ouroboros_tpu_torch.obsreport", "MULTICHIP_r05.json")
    assert r.returncode == 0, r.stderr
    assert "8 devices, rc=124 (RED)" in r.stdout
    assert "no MULTICHIP_OBS line" in r.stdout
    # genuinely unrecognised input is still a usage error, not a traceback
    bad = tmp_path / "junk.json"
    bad.write_text('{"neither": "bench nor multichip"}')
    r = _run("-m", "ouroboros_tpu_torch.obsreport", str(bad))
    assert r.returncode == 2 and "cannot read" in r.stderr


# ---------------------------------------------------------------------------
# registry determinism
# ---------------------------------------------------------------------------

def _workload(reg: MetricsRegistry, order: int = 0):
    """The same instrument writes, issued under two creation orders."""
    names = ["b.window", "a.hits", "c.depth"]
    if order:
        names.reverse()
    for n in names:
        if n == "c.depth":
            reg.gauge(n)
        else:
            reg.counter(n)
    reg.counter("a.hits").inc(3)
    reg.counter("b.window").inc()
    reg.gauge("c.depth").set(7)
    h = reg.histogram("d.sizes", buckets=(1, 2, 4))
    for v in (1, 2, 3, 9):
        h.observe(v)


def test_snapshot_sorted_and_byte_identical_across_creation_order():
    r1, r2 = MetricsRegistry(), MetricsRegistry()
    _workload(r1, order=0)
    _workload(r2, order=1)
    snap = r1.snapshot()
    assert list(snap) == sorted(snap)
    assert r1.snapshot_json() == r2.snapshot_json()
    # and across repeated renders of the same registry
    assert r1.snapshot_json() == r1.snapshot_json()


def test_snapshot_values_and_histogram_shape():
    reg = MetricsRegistry()
    _workload(reg)
    snap = reg.snapshot()
    assert snap["a.hits"] == 3
    assert snap["c.depth"] == 7
    assert snap["d.sizes"]["count"] == 4
    assert snap["d.sizes"]["sum"] == 15
    assert snap["d.sizes"]["buckets"] == {"1": 1, "2": 1, "4": 1}
    assert snap["d.sizes"]["overflow"] == 1


def test_unstable_instruments_excluded_from_snapshot_not_prometheus():
    reg = MetricsRegistry()
    reg.counter("stable.count").inc()
    reg.gauge("measured.secs", stable=False).set(1.234)
    snap = reg.snapshot()
    assert "stable.count" in snap and "measured.secs" not in snap
    assert "measured.secs" in reg.snapshot(include_unstable=True)
    prom = export.prometheus_text(reg)
    assert "ouro_measured_secs" in prom and "ouro_stable_count" in prom


def test_instrument_creation_idempotent_and_kind_checked():
    reg = MetricsRegistry()
    c = reg.counter("x")
    assert reg.counter("x") is c
    with pytest.raises(TypeError):
        reg.gauge("x")


def test_reset_zeroes_values_but_keeps_registration():
    reg = MetricsRegistry()
    _workload(reg)
    writes = reg.data_writes
    assert writes > 0
    reg.reset()
    assert reg.data_writes == 0
    assert reg.counter("a.hits").value == 0
    assert reg.histogram("d.sizes", buckets=(1, 2, 4)).count == 0
    assert set(reg.snapshot()) == {"a.hits", "b.window", "c.depth",
                                   "d.sizes"}


# ---------------------------------------------------------------------------
# the zero-overhead probe (disabled observation)
# ---------------------------------------------------------------------------

def test_disabled_registry_performs_zero_writes():
    reg = MetricsRegistry(enabled=False)
    c = reg.counter("c")
    g = reg.gauge("g")
    h = reg.histogram("h")
    c.inc(5)
    g.set(9)
    h.observe(3)
    assert c.value == 0 and g.value == 0 and h.count == 0
    assert reg.data_writes == 0


def test_always_counters_count_when_disabled_without_data_writes():
    """Migrated load-bearing counters (precompute fills, frozen-tuner
    writes) are program state: they count regardless of the flag and
    are never charged to the disabled-observation probe."""
    reg = MetricsRegistry(enabled=False)
    c = reg.counter("precompute.like", always=True)
    c.inc(2)
    assert c.value == 2
    assert reg.data_writes == 0


def test_disabled_recorder_returns_one_shared_null_cm():
    rec = SpanRecorder(enabled=False)
    cm1 = rec.span("a", cat="device")
    cm2 = rec.span("b", cat="compile", fence=True)
    assert cm1 is cm2                      # no per-call allocation
    with cm1:
        pass
    assert rec.roots == [] and rec._stack == []


def test_global_enable_disable_flip_both_layers():
    from ouroboros_tpu_torch import observe
    was_reg, was_rec = metrics.REGISTRY.enabled, spans.RECORDER.enabled
    try:
        observe.disable()
        assert not metrics.REGISTRY.enabled
        assert not spans.RECORDER.enabled
        assert not observe.enabled()
        observe.enable()
        assert observe.enabled()
    finally:
        metrics.REGISTRY.enabled, spans.RECORDER.enabled = was_reg, was_rec


# ---------------------------------------------------------------------------
# span nesting + fencing, wall clock and sim clock
# ---------------------------------------------------------------------------

def test_span_nesting_wall_clock():
    rec = SpanRecorder(enabled=True)
    with rec.span("outer", cat="dispatch"):
        with rec.span("inner", cat="device"):
            pass
    roots = rec.drain()
    assert len(roots) == 1
    outer = roots[0]
    assert outer.name == "outer" and outer.cat == "dispatch"
    (inner,) = outer.children
    assert inner.name == "inner" and inner.cat == "device"
    assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1
    assert rec.drain() == []               # drain is consuming


def test_span_sim_clock_exact_virtual_durations():
    """Under an active Sim runtime the span clock is virtual time, so
    durations are EXACT — the sim-time-aware half of the spans API."""
    rec = SpanRecorder(enabled=True)

    async def main():
        with rec.span("rep", cat="host-seq"):
            await sim.sleep(2.5)
            with rec.span("drain", cat="device"):
                await sim.sleep(1.25)

    sim.run(main())
    (rep,) = rec.drain()
    assert rep.duration == 3.75
    (drain,) = rep.children
    assert drain.duration == 1.25
    assert spans.phase_totals([rep]) == {"host-seq": 2.5, "device": 1.25}


def test_fenced_span_fences_both_edges(monkeypatch):
    fences = []
    monkeypatch.setattr(spans, "device_fence",
                        lambda: fences.append(len(fences)))
    rec = SpanRecorder(enabled=True)
    with rec.span("r", cat="sync", fence=True):
        assert fences == [0]               # entry edge fenced
    assert len(fences) == 2                # exit edge fenced too
    with rec.span("n", cat="sync"):        # fence=False: no fence calls
        pass
    assert len(fences) == 2


def test_device_fence_never_touches_an_idle_card(monkeypatch):
    """The port's fence waits on the card only once CUDA is initialised:
    a host-only process never initialises it by timing itself."""
    import torch
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append(a))
    spans.device_fence()                   # must be a pure no-op
    assert calls == []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    spans.device_fence()
    assert len(calls) == 1
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    spans.device_fence()
    assert "jax" not in sys.modules


def test_phase_totals_attributes_self_time_once():
    outer = Span("submit", "dispatch", 0.0)
    outer.t1 = 10.0
    inner = Span("composite", "compile", 2.0)
    inner.t1 = 7.0
    outer.children.append(inner)
    totals = spans.phase_totals([outer])
    assert totals == {"dispatch": 5.0, "compile": 5.0}
    assert sum(totals.values()) == outer.duration   # nothing counted twice


def test_out_of_order_close_reparents_and_closes_survivors():
    """A generator-held span closed late must not corrupt the stack:
    the still-open inner span is adopted and closed at the same stamp."""
    rec = SpanRecorder(enabled=True)
    a = rec._open("a", "host-seq")
    b = rec._open("b", "device")
    rec._close(a)                          # closes a while b still open
    (root,) = rec.drain()
    assert root is a
    assert [c.name for c in a.children] == ["b"]
    assert b.t1 == a.t1
    assert rec._stack == []


def test_adopted_span_late_close_is_not_recorded_twice():
    """The survivor's OWN context-manager exit still fires after it was
    adopted by the out-of-order close; that second _close must be a
    no-op — re-recording it would add it as a second root (duplicated
    in the chrome trace) and overwrite its t1 past its parent's."""
    rec = SpanRecorder(enabled=True)
    a = rec._open("a", "host-seq")
    b = rec._open("b", "device")
    rec._close(a)                          # adopts + stamps b
    stamped = b.t1
    rec._close(b)                          # b's CM exits late
    (root,) = rec.drain()                  # a only — b is not a root
    assert root is a and a.children == [b]
    assert b.t1 == stamped                 # stamp not overwritten
    assert rec.drain() == []


def test_root_overflow_drops_and_counts():
    rec = SpanRecorder(enabled=True, max_roots=2)
    for i in range(4):
        with rec.span(f"s{i}"):
            pass
    assert len(rec.roots) == 2
    assert rec.dropped == 2


# ---------------------------------------------------------------------------
# exporter golden files
# ---------------------------------------------------------------------------

def _golden_registry() -> MetricsRegistry:
    reg = MetricsRegistry()
    reg.counter("precompute.hits", always=True).inc(5)
    reg.counter("window.count").inc(3)
    reg.gauge("queue.depth").set(4)
    reg.gauge("autotune.last_secs", stable=False).set(0.125)
    h = reg.histogram("batch.size", buckets=(1, 2, 4))
    for v in (1, 1, 3, 9):
        h.observe(v)
    return reg


def _golden_spans():
    rep = Span("rep", "host-seq", 0.0)
    rep.t1 = 10.0
    sub = Span("window.submit", "dispatch", 1.0)
    sub.t1 = 3.0
    comp = Span("window.composite(8,8,2,0)", "compile", 1.5)
    comp.t1 = 2.5
    comp.meta = {"ne": 8}
    drain = Span("window.drain", "device", 3.0)
    drain.t1 = 6.0
    sub.children.append(comp)
    rep.children.extend([sub, drain])
    return [rep]


def _golden_events():
    return [
        TraceChainSyncEvent(peer_id="p1", event="roll-forward", slot=3,
                            n=4),
        TraceForgeEvent(slot=9, outcome="forged"),
        TraceAddBlock(kind="extended", slot=1, block_no=1,
                      hash=b"\x01\x02"),
        ("raw", 7),                        # non-dataclass payload
    ]


def _check_golden(name: str, text: str):
    """The port's exporters write tests/test_observe.py's golden bytes
    (read here, never written)."""
    with open(os.path.join(GOLDEN_DIR, name)) as f:
        golden = f.read()
    assert text == golden, f"{name} differs from the JAX package's golden"


def test_prometheus_exposition_golden_and_roundtrip():
    text = export.prometheus_text(_golden_registry())
    _check_golden("metrics.prom", text)
    parsed = export.parse_prometheus_text(text)
    assert parsed["ouro_precompute_hits"] == 5.0
    assert parsed["ouro_window_count"] == 3.0
    assert parsed["ouro_autotune_last_secs"] == 0.125
    assert parsed['ouro_batch_size_bucket{le="+Inf"}'] == 4.0
    assert parsed["ouro_batch_size_sum"] == 14.0
    assert parsed["ouro_batch_size_count"] == 4.0
    # cumulative bucket counts, per the Prometheus convention
    assert parsed['ouro_batch_size_bucket{le="1"}'] == 2.0
    assert parsed['ouro_batch_size_bucket{le="4"}'] == 3.0


def test_chrome_trace_golden_and_structure():
    doc = export.chrome_trace(_golden_spans())
    _check_golden("spans.trace.json",
                  json.dumps(doc, sort_keys=True) + "\n")
    events = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    names = {e["name"] for e in events}
    assert names == {"rep", "window.submit", "window.composite(8,8,2,0)",
                     "window.drain"}
    # one tid row per category so phases render as parallel tracks
    by_cat = {e["cat"]: e["tid"] for e in events}
    assert len(set(by_cat.values())) == len(by_cat)
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert {m["args"]["name"] for m in meta} == set(by_cat)
    comp = next(e for e in events
                if e["name"] == "window.composite(8,8,2,0)")
    assert comp["ts"] == 1.5e6 and comp["dur"] == 1e6
    assert comp["args"] == {"ne": 8}


def test_events_jsonl_golden_and_typed_schema():
    text = export.events_jsonl(_golden_events())
    _check_golden("events.jsonl", text)
    lines = [json.loads(ln) for ln in text.splitlines()]
    assert [ln["type"] for ln in lines] == [
        "TraceChainSyncEvent", "TraceForgeEvent", "TraceAddBlock",
        "tuple"]
    assert lines[0]["event"] == "roll-forward"   # field kept alongside
    assert lines[0]["n"] == 4
    assert lines[2]["hash"] == "0102"      # bytes hex-encoded
    assert lines[3]["payload"] == ["raw", 7]


def test_jsonl_tracer_is_a_live_bridge():
    fh = io.StringIO()
    tr = export.jsonl_tracer(fh)
    assert tr.active
    tr.trace(TraceForgeEvent(slot=1, outcome="not-leader"))
    tr.trace(TraceForgeEvent(slot=2, outcome="forged"))
    lines = [json.loads(ln) for ln in fh.getvalue().splitlines()]
    assert [(ln["slot"], ln["outcome"]) for ln in lines] == [
        (1, "not-leader"), (2, "forged")]


# ---------------------------------------------------------------------------
# NodeTracers -> metrics adapter
# ---------------------------------------------------------------------------

def test_adapter_counts_by_event_class_not_string():
    reg = MetricsRegistry()
    nt = adapter.metrics_node_tracers(reg)
    nt.chain_sync.trace(TraceChainSyncEvent("p", "roll-forward", 1, n=3))
    nt.chain_sync.trace(TraceChainSyncEvent("p", "validated", 2))
    nt.forge.trace(TraceForgeEvent(5, "forged"))
    snap = reg.snapshot()
    assert snap["node.chainsync.TraceChainSyncEvent"] == 4   # n-weighted
    assert snap["node.forge.TraceForgeEvent"] == 1
    assert "node.fetch.TraceFetchDecision" not in snap


def test_adapter_counting_tee_forwards_and_counts():
    reg = MetricsRegistry()
    inner, evs = collecting()
    t = adapter.counting("fetch", inner, reg)
    ev = TraceFetchDecision("p", 2, 0, "request")
    t.trace(ev)
    assert evs == [ev]                     # event still reaches its sink
    assert reg.snapshot()["node.fetch.TraceFetchDecision"] == 1


# ---------------------------------------------------------------------------
# per-thread span stacks + interval/overlap math (the pipelined
# replay's producer and consumer record concurrently; bench's `overlap`
# section is computed from these primitives)
# ---------------------------------------------------------------------------

def test_spans_per_thread_stacks_never_cross_adopt():
    """A producer-thread span overlapping a consumer-thread span in wall
    time is concurrency, not containment: each thread keeps its own open
    stack, completed roots land in the shared list."""
    import threading

    rec = SpanRecorder(enabled=True)
    gate_a = threading.Event()
    gate_b = threading.Event()

    def producer():
        with rec.span("host_seq", cat="host-seq"):
            with rec.span("pack", cat="host-seq"):
                gate_a.set()            # overlap with the consumer span
                gate_b.wait(5)

    t = threading.Thread(target=producer)
    t.start()
    gate_a.wait(5)
    with rec.span("drain", cat="device"):
        pass
    gate_b.set()
    t.join()
    roots = rec.drain()
    by_name = {r.name: r for r in roots}
    assert set(by_name) == {"host_seq", "drain"}
    assert [c.name for c in by_name["host_seq"].children] == ["pack"]
    assert by_name["drain"].children == []      # no cross-thread adoption


def test_spans_concurrent_closes_are_recorded_without_loss():
    """Many threads closing spans concurrently: every root is recorded
    exactly once (the shared roots list is lock-guarded)."""
    import threading

    rec = SpanRecorder(enabled=True, max_roots=10_000)

    def worker(k):
        for i in range(50):
            with rec.span(f"w{k}.{i}", cat="host-seq"):
                pass

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    roots = rec.drain()
    assert len(roots) == 200
    assert len({r.name for r in roots}) == 200
    assert rec.dropped == 0


def test_interval_and_overlap_math():
    a = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert spans.merge_intervals(a) == [(0.0, 2.0), (3.0, 4.0)]
    # host [0,2]u[3,4]; device [1.5, 3.5] -> overlap 0.5 + 0.5
    assert spans.overlap_seconds(a, [(1.5, 3.5)]) == pytest.approx(1.0)
    assert spans.overlap_seconds([], [(0, 1)]) == 0.0
    assert spans.overlap_seconds([(0, 1)], [(2, 3)]) == 0.0


def test_intervals_of_filters_by_cat_and_name():
    rec = SpanRecorder(enabled=True)
    with rec.span("window.host_seq", cat="host-seq"):
        pass
    with rec.span("window.drain", cat="device"):
        pass
    with rec.span("producer.stall", cat="stall"):
        pass
    roots = rec.drain()
    assert len(spans.intervals_of(roots, name="window.drain")) == 1
    assert len(spans.intervals_of(roots, cat="stall")) == 1
    assert len(spans.intervals_of(roots)) == 3
    assert spans.intervals_of(roots, cat="compile") == []


# ---------------------------------------------------------------------------
# log-bucket latency histograms with deterministic quantiles
# ---------------------------------------------------------------------------

def test_latency_buckets_are_log_spaced_and_shared():
    b = metrics.LATENCY_BUCKETS
    assert b[0] == 1e-6
    assert all(b[i + 1] == b[i] * 2 for i in range(len(b) - 1))
    h = metrics.latency_histogram("lat.vocab.probe")
    assert h.buckets == b
    assert not h.stable                    # measured seconds: unstable


def test_histogram_quantiles_exact_and_deterministic():
    reg = MetricsRegistry()
    h = reg.histogram("q", buckets=(1, 2, 4))
    for v in (1, 1, 3, 9):
        h.observe(v)
    # counts [2, 0, 1, overflow 1]; p50 rank=2 -> top of [0,1];
    # p95/p99 fall into the overflow bucket -> the top edge
    assert h.quantile(0.50) == 1.0
    assert h.quantile(0.95) == 4.0
    assert h.quantiles() == {"p50": 1.0, "p95": 4.0, "p99": 4.0}
    # interpolation inside a mid bucket: rank lands in (2,4]
    h2 = reg.histogram("q2", buckets=(1, 2, 4))
    for v in (1, 3, 3, 3):
        h2.observe(v)
    assert h2.quantile(0.5) == pytest.approx(2.0 + 2.0 * (1.0 / 3.0))
    assert reg.histogram("qe", buckets=(1, 2)).quantile(0.5) == 0.0


def test_histogram_quantiles_creation_order_byte_identical():
    """The registry-level determinism contract extends to quantiles:
    same observations, different creation order -> identical snapshot
    bytes AND identical p50/p95/p99 (they are pure functions of the
    counts)."""
    import json as _json

    def build(order):
        reg = MetricsRegistry()
        names = ["lat.a", "lat.b"]
        if order:
            names.reverse()
        for n in names:
            reg.histogram(n, buckets=metrics.LATENCY_BUCKETS)
        for i in range(20):
            reg.histogram("lat.a",
                          buckets=metrics.LATENCY_BUCKETS).observe(
                              0.001 * (i + 1))
            reg.histogram("lat.b",
                          buckets=metrics.LATENCY_BUCKETS).observe(
                              0.01 * (i + 1))
        return reg
    r1, r2 = build(0), build(1)
    assert r1.snapshot_json() == r2.snapshot_json()
    q1 = {n: r1.get(n).quantiles() for n in ("lat.a", "lat.b")}
    q2 = {n: r2.get(n).quantiles() for n in ("lat.a", "lat.b")}
    assert _json.dumps(q1, sort_keys=True) == _json.dumps(q2,
                                                          sort_keys=True)
    assert 0 < q1["lat.a"]["p50"] <= q1["lat.a"]["p95"] \
        <= q1["lat.a"]["p99"]


def test_span_close_feeds_phase_latency_histograms():
    """Every span close records its duration into latency.phase.<cat>
    on the GLOBAL registry — live per-phase quantiles for the scrape
    endpoint without a second instrumentation pass."""
    h = metrics.REGISTRY.get("latency.phase.device")
    before = h.count if h is not None else 0
    rec = SpanRecorder(enabled=True)
    with rec.span("drain", cat="device"):
        pass
    h = metrics.REGISTRY.get("latency.phase.device")
    assert h is not None and h.count == before + 1
    rec.drain()


def test_prom_quantiles_match_local_quantiles():
    """A scraper recomputes the SAME p50/p95/p99 from the cumulative
    exposition buckets that the process reports locally — the
    obsreport --live contract."""
    reg = MetricsRegistry()
    h = reg.histogram("pipe.lat", buckets=metrics.LATENCY_BUCKETS,
                      stable=False)
    for i in range(50):
        h.observe(0.0001 * (i + 1) ** 2)
    parsed = export.parse_prometheus_text(export.prometheus_text(reg))
    got = export.prom_histogram_quantiles(parsed, "ouro_pipe_lat")
    assert got == h.quantiles()
    assert export.prom_histograms(parsed) == {"ouro_pipe_lat": 50.0}


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def _private_flight(capacity=64):
    from ouroboros_tpu_torch.observe.flight import FlightRecorder
    reg = MetricsRegistry()
    rec = SpanRecorder(enabled=False)
    return FlightRecorder(capacity, registry=reg, recorder=rec), reg, rec


def test_flight_recorder_arm_captures_spans_metrics_events():
    fl, reg, rec = _private_flight()
    c = reg.counter("f.count")
    c.inc()                                # before arming: not recorded
    fl.arm()
    assert rec.enabled                     # arming forces spans on
    with rec.span("w", cat="device"):
        pass
    c.inc(2)
    fl.note(TraceForgeEvent(slot=3, outcome="forged"))
    kinds = [e[1] for e in fl.entries()]
    assert kinds.count("span") == 1
    assert kinds.count("event") == 1
    assert ("f.count" in {e[2] for e in fl.entries()
                          if e[1] == "metric"})
    fl.disarm()
    n = len(fl)
    c.inc()
    assert len(fl) == n                    # disarmed: hook detached
    assert not rec.enabled                 # prior recorder state restored


def test_same_cat_nested_span_records_one_phase_sample():
    """The pipeline's outer "pipeline.drain" wraps JaxBackend's inner
    "window.drain" (both cat=device): ONE wait, ONE histogram sample —
    a same-cat child must not double the latency.phase.device count."""
    h = metrics.REGISTRY.histogram("latency.phase.device",
                                   buckets=metrics.LATENCY_BUCKETS,
                                   stable=False)
    before = h.count
    rec = SpanRecorder(enabled=True)
    with rec.span("pipeline.drain", cat="device"):
        with rec.span("window.drain", cat="device"):
            pass
    assert h.count == before + 1
    # a different-cat child still records under its own phase
    hc = metrics.REGISTRY.get("latency.phase.compile")
    before_c = hc.count if hc is not None else 0
    with rec.span("window.submit", cat="dispatch"):
        with rec.span("composite", cat="compile"):
            pass
    assert metrics.REGISTRY.get("latency.phase.compile").count \
        == before_c + 1
    rec.drain()


def test_flight_arm_is_reentrant_and_note_takes_explicit_time():
    """Nested arm()s must not clobber the saved recorder state (the
    outer disarm restores the TRUE pre-arm state), and note(t=...)
    keeps an event's own clock reading — the post-mortem sim-trace-tail
    path stamps virtual time, not the wall clock of the dump."""
    fl, _reg, rec = _private_flight()
    assert not rec.enabled
    fl.arm()
    fl.arm()                               # reentrant arm
    fl.disarm()
    assert not rec.enabled                 # original state restored
    fl.arm()
    fl.note(("late", 1), t=3.5)
    (entry,) = fl.entries()
    assert entry[0] == 3.5 and entry[1] == "event"
    assert fl._record(entry)["t"] == 3.5
    fl.disarm()


def test_flight_ring_is_bounded():
    fl, reg, rec = _private_flight(capacity=8)
    fl.arm()
    c = reg.counter("f.many")
    for _ in range(50):
        c.inc()
    assert len(fl) == 8
    fl.disarm()


def test_flight_dump_golden_and_byte_identical_replay(tmp_path):
    """A seeded sim failure dumps byte-identical flight files on every
    replay — virtual timestamps only.  Golden regen:
    OURO_REGEN_GOLDEN=1 pytest tests/test_observe.py"""
    def one_run(d):
        fl, reg, rec = _private_flight()
        fl.arm()

        async def main():
            with rec.span("window.host_seq", cat="host-seq"):
                await sim.sleep(1.5)
            reg.counter("replay.windows").inc()
            with rec.span("window.drain", cat="device"):
                await sim.sleep(0.25)
            fl.note(TraceForgeEvent(slot=7, outcome="error"))

        sim.run(main())
        out = fl.dump(str(d), reason="forced failure (test)")
        fl.disarm()
        return out

    out1 = one_run(tmp_path / "a")
    out2 = one_run(tmp_path / "b")
    with open(out1["jsonl"]) as f:
        text1 = f.read()
    with open(out2["jsonl"]) as f:
        assert f.read() == text1           # byte-identical replay
    with open(out1["trace"]) as f:
        assert f.read() == open(out2["trace"]).read()
    _check_golden("flight.jsonl", text1)
    # the chrome dump loads as a trace_event document
    doc = json.load(open(out1["trace"]))
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert names == {"window.host_seq", "window.drain"}
    # header line carries the reason + count
    head = json.loads(text1.splitlines()[0])
    assert head["kind"] == "flight" and "forced failure" in head["reason"]
    assert head["entries"] == len(text1.splitlines()) - 1


def test_flight_dump_on_failure_noop_unless_armed(tmp_path, monkeypatch):
    fl, _reg, _rec = _private_flight()
    monkeypatch.setenv("OURO_FLIGHT_DIR", str(tmp_path / "fr"))
    assert fl.dump_on_failure("boom") is None
    fl.arm()
    out = fl.dump_on_failure("boom")
    assert out is not None and os.path.exists(out["jsonl"])
    assert out["dir"] == str(tmp_path / "fr")
    fl.disarm()


# ---------------------------------------------------------------------------
# the JAX package's tools on the same inputs
# ---------------------------------------------------------------------------

def _without_reworded(text: str) -> str:
    """A render less the lines the port rewords (they named old issues:
    the two saying what a round predates)."""
    return "".join(line for line in text.splitlines(keepends=True)
                   if "predates" not in line)


def _in_process(main, argv):
    import contextlib
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue()


def _same_verdict(port: dict, ref: dict):
    """Equal verdicts: every field, every check's name and result, and
    every detail the port does not reword."""
    assert port.keys() == ref.keys()
    for k in port:
        if isinstance(port[k], dict) and "checks" in port[k]:
            _same_verdict(port[k], ref[k])
        elif k == "checks":
            assert [(c["check"], c["result"]) for c in port[k]] == \
                [(c["check"], c["result"]) for c in ref[k]]
            for p, r in zip(port[k], ref[k]):
                if "lack it" not in p["detail"]:     # reworded by the port
                    assert p["detail"] == r["detail"]
        else:
            assert port[k] == ref[k]


def _gate_cases(tmp_path) -> list:
    bench = sorted(glob.glob(os.path.join(REPO, "BENCH_r0*.json")))
    mc = sorted(glob.glob(os.path.join(REPO, "MULTICHIP_r0*.json")))
    cases = [["--check", *bench], ["--multichip", *mc], ["--serve", *bench],
             ["--check", *bench, "--multichip", *mc, "--serve", *bench]]
    for i, fields in enumerate([
            dict(vs_baseline=6.0, spread=0.6,
                 overlap={"hidden_frac_median": 0.05}),
            dict(vs_baseline=13.0, spread=0.40),
            dict(vs_baseline=13.0, spread=0.2,
                 overlap={"hidden_frac_median": 0.5})]):
        d = tmp_path / f"b{i}"
        d.mkdir()
        cases.append(["--max-spread", "0.3", "--check",
                      *_regressed_round(d, **fields)])
    d = tmp_path / "mc"
    d.mkdir()
    cases.append(["--multichip", _multichip_round(d, 6, 0, obs=_GREEN_OBS),
                  _multichip_round(d, 7, 124)])
    d = tmp_path / "sv"
    d.mkdir()
    cases.append(["--serve", _serve_round(d, 6, serve=_GREEN_SERVE),
                  _serve_round(d, 7, serve=dict(
                      _GREEN_SERVE, saturated={"vs_unbatched_cpu": 3.0,
                                               "p95_within_deadline": True}))])
    return cases


def test_perfgate_verdicts_equal_the_jax_tools(tmp_path):
    from ouroboros_tpu_torch import perfgate
    from tools import perfgate as ref
    for argv in _gate_cases(tmp_path):
        prc, pout = _in_process(perfgate.main, argv)
        rrc, rout = _in_process(ref.main, argv)
        assert prc == rrc, argv
        _same_verdict(json.loads(pout), json.loads(rout))


def test_obsreport_renders_equal_the_jax_tools(tmp_path):
    from ouroboros_tpu_torch import obsreport
    from tools import obsreport as ref
    for p in sorted(glob.glob(os.path.join(REPO, "BENCH_r0*.json"))):
        assert obsreport.render(obsreport.load_bench(p)) == \
            ref.render(ref.load_bench(p))
    obs = dict(_GREEN_OBS, single_device_replay={"proofs_per_sec": 70.0})
    paths = sorted(glob.glob(os.path.join(REPO, "MULTICHIP_r0*.json")))
    paths.append(_multichip_round(tmp_path, 6, 0, obs=obs))
    for p in paths:
        got = obsreport.render_multichip(obsreport.load_multichip(p))
        want = ref.render_multichip(ref.load_multichip(p))
        assert _without_reworded(got) == _without_reworded(want)
        assert got.count("\n") == want.count("\n")
    assert obsreport.load_multichip(paths[0]) == ref.load_multichip(paths[0])
    # a fleet report, a flight dump and a scraped exposition
    fleet = {"nodes": ["n0", "n1", "n2"],
             "adoption": {"blocks": 4, "fully_adopted_blocks": 3,
                          "time_to_50": {"n": 4, "p50": 0.1, "p95": 0.3,
                                         "max": 0.4},
                          "time_to_95": {"n": 3, "p50": 0.2, "p95": 0.6,
                                         "max": 0.6}},
             "per_edge_delivery": {"n0->n1": {"n": 2, "p50": 0.05,
                                              "p95": 0.06, "max": 0.06}},
             "partitions": [{"start": 1.0, "end": 2.0,
                             "healed_after_secs": None}],
             "mux": {"n0->n1|r": {"ingress_bytes": 9, "egress_bytes": 8,
                                  "ingress_sdus": 1, "egress_sdus": 1}}}
    assert obsreport.render_fleet(fleet) == ref.render_fleet(fleet)
    header = {"kind": "flight", "entries": 3, "reason": "probe"}
    records = [{"t": 1.0, "kind": "metric", "name": "a", "op": "inc",
                "v": 2},
               {"t": 1.5, "kind": "span", "cat": "device", "name": "w",
                "t0": 1.0, "t1": 1.25},
               {"t": 2.0, "kind": "event", "what": ["x", 1]}]
    assert obsreport.render_flight(header, records, tail=2) == \
        ref.render_flight(header, records, tail=2)
    reg = MetricsRegistry()
    reg.gauge("replay.progress.blocks_done").set(30)
    reg.gauge("replay.progress.total_blocks").set(40)
    h = reg.histogram("pipe.lat", buckets=metrics.LATENCY_BUCKETS,
                      stable=False)
    for i in range(20):
        h.observe(0.001 * (i + 1))
    parsed = export.parse_prometheus_text(export.prometheus_text(reg))
    live = obsreport.render_live(parsed)
    assert live == ref.render_live(parsed)
    assert "30/40 blocks" in live and "ouro_pipe_lat" in live
    assert obsreport.PHASE_ORDER == ref.PHASE_ORDER


# ---------------------------------------------------------------------------
# tests/test_snocket.py's ping-tool case, on a port node
# ---------------------------------------------------------------------------

def _first_line(proc, timeout: float) -> str:
    import selectors
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    if not sel.select(timeout):
        raise AssertionError(f"no line from the server in {timeout} s")
    return proc.stdout.readline()


def test_ping_tool_against_served_node():
    """cardano-ping analog end to end: serve a port node over TCP, run
    `python -m ouroboros_tpu_torch.ping` against it, expect the
    negotiated version and RTT statistics."""
    server = subprocess.Popen(
        [sys.executable, "-c", """
from ouroboros_tpu_torch.simharness import io_run
from ouroboros_tpu_torch.testing.threadnet import (PraosNetworkFactory,
                                                   ThreadNetConfig)
from ouroboros_tpu_torch.node.socket_net import serve_node
from ouroboros_tpu_torch import simharness as sim

async def main():
    factory = PraosNetworkFactory(ThreadNetConfig(n_nodes=1, k=3, f=1.0))
    kern = factory.make_node(0)
    srv, port = await serve_node(kern, port=0)
    print(port, flush=True)
    await sim.sleep(30.0)

io_run(main())
"""],
        stdout=subprocess.PIPE, text=True, cwd=REPO)
    try:
        port = int(_first_line(server, 60).strip())
        r = subprocess.run(
            [sys.executable, "-m", "ouroboros_tpu_torch.ping", "127.0.0.1",
             str(port), "--count", "3"],
            capture_output=True, text=True, cwd=REPO, timeout=60)
        assert r.returncode == 0, r.stderr
        info = json.loads(r.stdout)
        assert info["ok"] and info["probes"] == 3
        assert info["rtt_avg_ms"] >= 0
        assert info["version"] >= 1
        # a dead port is a failed dial, not a hang
        dead = subprocess.run(
            [sys.executable, "-m", "ouroboros_tpu_torch.ping", "127.0.0.1",
             "1", "--count", "1"],
            capture_output=True, text=True, cwd=REPO, timeout=60)
        assert dead.returncode != 0
    finally:
        server.kill()
        server.wait(timeout=30)
