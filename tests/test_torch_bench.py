"""The port's bench (`python -m ouroboros_tpu_torch.bench`) against the
JAX package's `bench.py`, on the CPU.

`bench.smoke(device="cpu")` passes every gate of the reference's smoke
test; the chain it forges and the replay it times equal the reference's
at the smoke shape on both packages' `CpuRefBackend`s (no JAX program is
compiled); the span and spread math equals the reference's on the same
inputs; history is read from `BENCH_GPU_r*.json` only; and the precompute
cache counts what the reference's counts, under the same registry names.
"""
import json
import pathlib
import subprocess
import sys

import pytest

import bench as ref_bench
from ouroboros_tpu.crypto import precompute as ref_precompute
from ouroboros_tpu.crypto.backend import CpuRefBackend as RefCpuRefBackend
from ouroboros_tpu.observe import spans as ref_spans
from ouroboros_tpu_torch import bench, observe, obsreport, perfgate
from ouroboros_tpu_torch.crypto import precompute
from ouroboros_tpu_torch.crypto.backend import CpuRefBackend
from ouroboros_tpu_torch.crypto.precompute import PrecomputeCache, shared_cache
from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend
from ouroboros_tpu_torch.observe import metrics
from ouroboros_tpu_torch.observe import spans as port_spans

_ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_bench_smoke_parity_gate():
    """`bench.smoke(device="cpu")`: every assertion of the reference's
    `tests/test_tools.py::test_bench_smoke_parity_gate`, copied."""
    res = bench.smoke(device="cpu")
    assert res["state_hash_parity"] and res["verdict_parity"]
    assert res["fold_verdict_parity"]
    assert res["pipelined_producers_run"] >= 1
    assert res["producer_threads_leaked"] == 0
    assert res["overlap_probe"]["host_seq_secs"] > 0
    assert res["vrf_spread_probe"]["ok"]
    assert res["warm_device_fills"] == 0 and res["warm_kes_jobs"] == 0
    assert res["scrape_roundtrip"] and res["scrape_threads_leaked"] == 0
    q = res["scrape_submit_drain_quantiles"]
    assert 0 < q["p50"] <= q["p95"] <= q["p99"]
    assert res["perfgate_ok"]
    sh = res["sharded_replay_smoke"]
    assert sh["ok"] is True
    assert sh.get("skipped") or sh["producer_threads_leaked"] == 0
    sv = res["serve_probe"]
    assert sv["ok"] is True
    assert sv["saturated"]["vs_unbatched_cpu"] >= 5.0
    assert sv["saturated"]["p95_within_deadline"] is True
    assert sv["saturated"]["parity"] is True
    assert sv["light_load"]["device_batches"] == 0
    assert sv["light_load"]["parity"] is True
    assert sv["backpressure"]["backpressure_waits"] > 0
    assert sv["backpressure"]["parity"] is True
    for leg in ("saturated", "light_load", "backpressure"):
        assert sv[leg]["leaked_threads"] == 0
    st = res["stream_probe"]
    assert st["ok"] is True
    assert st["state_hash_parity"] and st["resume_parity"]
    assert st["threads_leaked"] == 0
    assert st["stats"]["chunks_read"] >= 1
    assert st["stats"]["snapshots_written"] >= 1
    assert res["blocks"] == 8
    # the port's own: the gates the reference's smoke gates on but its
    # test does not read, the sharded probe ran (not skipped) on two CPU
    # shards, and the backend's cache reports the reference's keys
    assert res["replay_fill_dispatches"] <= 3
    assert res["disabled_registry_writes"] == 0
    assert res["disabled_spans_recorded"] == 0
    assert res["net_disabled_probe"]["ok"]
    assert sh["skipped"] is None and sh["devices"] == ["cpu", "cpu"]
    assert [v["match"] for v in sh["variants"]] == [True] * 3
    assert set(res["precompute"]) == set(
        ref_precompute.PrecomputeCache().stats())
    # the plain forms count no launch
    assert not any(res["kernel_launches"].values())


def test_bench_cli_flags_exist():
    r = subprocess.run([sys.executable, "-m", "ouroboros_tpu_torch.bench",
                        "--help"], capture_output=True, text=True,
                       timeout=120, cwd=_ROOT)
    assert r.returncode == 0, r.stderr
    for flag in ("--smoke", "--serve", "--serve-seed", "--mesh",
                 "--device"):
        assert flag in r.stdout
    assert "--retune" not in r.stdout


@pytest.mark.parametrize("txs", [0, 2])
def test_chain_and_replay_equal_the_reference(monkeypatch, tmp_path, txs):
    """At the smoke shape (8 blocks, epoch length 500, KES depth 4, with
    and without transactions): the port's synth_chain, load and replay on
    its CpuRefBackend give the reference's state hash and proof count."""
    for mod in (bench, ref_bench):
        monkeypatch.setattr(mod, "BLOCKS", 8)
        monkeypatch.setattr(mod, "TXS", txs)
        monkeypatch.setattr(mod, "EPOCH_LEN", 500)
    extra = ("--kes-depth", "4")
    port_dir = bench.synth_chain(str(tmp_path / "port"), extra)
    ref_dir = ref_bench.synth_chain(str(tmp_path / "ref"), extra)
    rules, blocks = bench.load(port_dir)
    ref_rules, ref_blocks = ref_bench.load(ref_dir)
    assert len(blocks) == len(ref_blocks) == 8
    assert sum(len(b.body) for b in blocks) == 8 * txs
    _s, got_hash, got_proofs = bench.replay(rules, blocks, CpuRefBackend(),
                                            4)
    _s, want_hash, want_proofs = ref_bench.replay(
        ref_rules, ref_blocks, RefCpuRefBackend(), 4)
    assert got_hash == want_hash
    assert got_proofs == want_proofs == 8 * (4 + txs)   # a witness a tx


def _forest(spans_mod):
    """A producer/consumer span forest of two windows in `spans_mod`'s
    Span class."""
    def mk(name, cat, t0, t1, *children):
        sp = spans_mod.Span(name, cat, t0)
        sp.t1 = t1
        sp.children = list(children)
        return sp
    return [
        mk("window.host_seq", "host-seq", 0.0, 1.0),
        mk("window.submit", "dispatch", 1.0, 1.5,
           mk("precompute.fill", "device", 1.1, 1.3)),
        mk("window.host_seq", "host-seq", 1.5, 2.6),
        mk("pipeline.drain", "device", 1.5, 2.2,
           mk("window.drain", "device", 1.6, 2.2)),
        mk("producer.stall", "stall", 2.6, 2.9),
        mk("window.submit", "dispatch", 2.6, 3.0),
        mk("pipeline.drain", "device", 3.0, 3.4,
           mk("window.drain", "device", 3.0, 3.4)),
    ]


_PHASES = [{"host-seq": 1.0, "dispatch": 0.5, "device": 2.0, "other": 0.1},
           {"host-seq": 1.2, "dispatch": 0.4, "device": 2.9, "other": 0.3},
           {"host-seq": 0.9, "dispatch": 0.6, "device": 2.2, "sync": 0.01}]
_OVERLAPS = [{"host_seq_secs": 2.1, "device_secs": 1.0,
              "host_hidden_secs": 0.7, "hidden_frac": 0.333,
              "producer_stall_secs": 0.3},
             {"host_seq_secs": 2.4, "device_secs": 1.2,
              "host_hidden_secs": 0.5, "hidden_frac": 0.208,
              "producer_stall_secs": 0.0},
             {"host_seq_secs": 1.9, "device_secs": 0.8,
              "host_hidden_secs": 0.9, "hidden_frac": 0.474,
              "producer_stall_secs": 0.1}]


@pytest.mark.parametrize("fn, args", [
    ("median_spread", ([3.0, 1.0, 2.0],)),
    ("median_spread", ([0.0, 0.0],)),
    ("check_spread", ("card replay", [1.0, 1.1, 0.9])),
    ("check_spread", ("card replay", [1.0, 2.0, 10.0])),
    ("_phase_variance", (_PHASES,)),
    ("_phase_variance", ([],)),
    ("_overlap_summary", (_OVERLAPS,)),
    ("_overlap_summary", ([],)),
    ("_rep_overlap", "forest"),
    ("_rep_phase_totals", "forest"),
])
def test_span_and_spread_math_equals_the_reference(fn, args):
    if args == "forest":
        import ouroboros_tpu.observe as ref_observe
        import ouroboros_tpu_torch.observe as port_observe
        extra = (3.5,) if fn == "_rep_phase_totals" else ()
        got = getattr(bench, fn)(port_observe, _forest(port_spans), *extra)
        want = getattr(ref_bench, fn)(ref_observe, _forest(ref_spans),
                                      *extra)
    else:
        got = getattr(bench, fn)(*args)
        want = getattr(ref_bench, fn)(*args)
    assert got == want


def _round(path, n, parsed):
    path.write_text(json.dumps({"n": n, "cmd": "bench", "rc": 0,
                                "tail": "", "parsed": parsed}))


def test_compare_previous_reads_gpu_rounds_only(monkeypatch, tmp_path):
    monkeypatch.setattr(bench, "REPO", str(tmp_path))
    assert bench.compare_previous({"ed25519_batch_per_sec": 1.0}) == {}
    _round(tmp_path / "BENCH_r05.json", 5,
           {"metric": "m", "primitives": {"ed25519_batch_per_sec": 1.0,
                                          "vrf_batch_per_sec": 1.0}})
    assert bench.bench_rounds() == []
    assert bench.compare_previous({"ed25519_batch_per_sec": 1.0}) == {}
    _round(tmp_path / "BENCH_GPU_r01.json", 1,
           {"metric": "m", "primitives": {"ed25519_batch_per_sec": 100.0,
                                          "vrf_batch_per_sec": 50.0}})
    got = bench.compare_previous({"ed25519_batch_per_sec": 200.0,
                                  "vrf_batch_per_sec": 25.0,
                                  "kes_batch_per_sec": 10.0})
    assert got == {"vs_round": 1, "ratios": {"ed25519_batch_per_sec": 2.0,
                                             "vrf_batch_per_sec": 0.5}}
    assert [r for r, _d in bench.bench_rounds()] == [1]


def test_smoke_perfgate_reads_gpu_rounds_only(monkeypatch, tmp_path):
    monkeypatch.setattr(bench, "REPO", str(tmp_path))
    # a TPU round that fails every gate is not read
    _round(tmp_path / "BENCH_r07.json", 7,
           {"metric": "m", "vs_baseline": 1.0, "spread": 0.9,
            "overlap": {"hidden_frac_median": 0.0}})
    ok, verdict = bench._smoke_perfgate()
    assert ok and verdict["note"] == "no recorded rounds"
    _round(tmp_path / "BENCH_GPU_r01.json", 1,
           {"metric": "m", "vs_baseline": 2.0, "spread": 0.1,
            "overlap": {"hidden_frac_median": 0.5}})
    ok, verdict = bench._smoke_perfgate()
    assert ok and verdict["latest"] == "BENCH_GPU_r01.json"
    _round(tmp_path / "BENCH_GPU_r02.json", 2,
           {"metric": "m", "vs_baseline": 0.5, "spread": 0.1,
            "overlap": {"hidden_frac_median": 0.5}})
    ok, verdict = bench._smoke_perfgate()
    assert not ok and verdict["latest"] == "BENCH_GPU_r02.json"


def test_a_gpu_round_file_is_read_by_obsreport_and_perfgate(tmp_path):
    cache = PrecomputeCache("cpu")
    cache.kes_get(("k",))
    cache.kes_put(("k",), b"v", True)
    cache.kes_get(("k",))
    line = {"metric": "shelley_replay_proofs_per_sec", "value": 10.0,
            "unit": "proofs/s", "vs_baseline": 2.0, "spread": 0.1,
            "overlap": {"hidden_frac_median": 0.5},
            "precompute": cache.stats()}
    path = tmp_path / "BENCH_GPU_r03.json"
    _round(path, 3, line)
    assert obsreport.load_bench(str(path)) == line
    assert perfgate.check_trajectory([str(path)])["ok"]
    text = obsreport.render(obsreport.load_bench(str(path)))
    assert "precompute cache:" in text
    for stat in ("hits", "misses", "device_fills", "evictions"):
        assert stat in text


def test_span_secs_counts_overlapping_spans_once():
    """`_span_secs` (the cold run's fill seconds): the union of the named
    spans, nested or overlapping ones counted once, others ignored."""
    sp = port_spans.Span("precompute.fill", "device", 0.0)
    sp.t1 = 2.0
    inner = port_spans.Span("precompute.fill", "device", 1.0)
    inner.t1 = 3.0
    sp.children.append(inner)
    later = port_spans.Span("precompute.fill", "device", 5.0)
    later.t1 = 5.5
    other = port_spans.Span("window.drain", "device", 0.0)
    other.t1 = 9.0
    assert bench._span_secs(observe, [sp, later, other],
                            "precompute.fill") == pytest.approx(3.5)


def test_start_device_is_a_no_op_on_the_cpu(monkeypatch):
    """The card's start-up (kernel build, first touch) stays out of the
    cold run's clock; on the CPU there is nothing to build."""
    import torch

    class NoBuild:
        def library(self):
            raise AssertionError("built a kernel library on the CPU")

    bench._start_device(torch.device("cpu"), NoBuild())


def test_timing_backend_charges_each_seam():
    calls = []

    class Inner:
        name = "inner"
        supports_window_fold = True

        def submit_window(self, reqs, fold=False):
            calls.append(("submit", fold))
            return "state"

        def finish_window(self, state):
            calls.append(("finish", state))
            return [True], {}

    tb = bench.TimingBackend(Inner())
    assert tb.name == "inner" and tb.supports_window_fold
    assert tb.finish_window(tb.submit_window([1], fold=True)) == ([True], {})
    assert calls == [("submit", True), ("finish", "state")]
    assert tb.dispatch_secs > 0 and tb.device_secs > 0


def test_cpu_baseline_raises_when_it_cannot_be_built(monkeypatch):
    from ouroboros_tpu_torch.crypto import cpp_backend

    def broken():
        raise OSError("g++ not found")
    monkeypatch.setattr(cpp_backend, "load_library", broken)
    with pytest.raises(OSError, match="g\\+\\+"):
        bench._cpu_backend()


def test_device_info_on_the_cpu():
    import torch
    assert bench._device_info(torch.device("cpu")) == {
        "name": "cpu", "power_limit_w": None, "count": 0}


# -- the precompute cache's counters -------------------------------------

def test_precompute_stats_has_the_reference_keys():
    got = PrecomputeCache("cpu").stats()
    want = ref_precompute.PrecomputeCache().stats()
    assert list(got) == list(want)
    assert got == want                   # all zero, both empty


def _kes_sequence(cache):
    """A known KES hash-path sequence on a 2-entry cache: two misses, a
    hit, three inserts (one eviction), a miss on the evicted key."""
    assert cache.kes_get(("a",)) is None
    cache.kes_put(("a",), b"A", True)
    assert cache.kes_get(("a",)) == (b"A", True)
    assert cache.kes_get(("b",)) is None
    cache.kes_put(("b",), b"B", False)
    cache.kes_put(("c",), b"C", True)
    assert cache.kes_get(("a",)) is None
    return cache.stats()


def test_kes_counters_equal_the_reference_on_a_known_sequence():
    got = _kes_sequence(PrecomputeCache("cpu", max_entries=2))
    want = _kes_sequence(ref_precompute.PrecomputeCache(max_entries=2))
    assert got == want
    assert (got["hits"], got["misses"], got["evictions"]) == (1, 3, 1)
    assert got["kes_entries"] == 2 and got["device_fills"] == 0


def _keys():
    from ouroboros_tpu_torch.crypto import ed25519_ref
    return [ed25519_ref.public_key(bytes([i]) * 32) for i in range(3)]


def _point_sequence(cache, a, b, c):
    cache.assemble([a, b, a])      # 2 misses, one fill of 2 keys
    cache.assemble([a])            # 1 hit
    cache.assemble([b, c])         # 1 hit, 1 miss, a fill, 1 eviction
    cache.assemble([a])            # a was the least recent: a miss again
    return cache.stats()


def test_point_counters_on_a_known_key_sequence():
    got = _point_sequence(PrecomputeCache("cpu", max_entries=2), *_keys())
    assert got == {"entries": 2, "kes_entries": 0, "hits": 2, "misses": 4,
                   "device_fills": 3, "filled_keys": 4, "evictions": 2,
                   "lock_wait": 0}


@pytest.mark.slow
def test_point_counters_equal_the_reference_on_a_known_key_sequence():
    """The reference's fill compiles its a128 program (XLA:CPU)."""
    keys = _keys()
    got = _point_sequence(PrecomputeCache("cpu", max_entries=2), *keys)
    want = _point_sequence(ref_precompute.PrecomputeCache(max_entries=2),
                           *keys)
    assert got == want


def test_precompute_counters_live_in_global_registry():
    """The cache counters are registry instruments AND attributes: one
    source of truth, aliases kept.  The port's copy of the reference's
    test, on the process-wide cache of the CPU."""
    cache = shared_cache("cpu")
    inst = metrics.REGISTRY.get("precompute.hits")
    assert inst is not None
    assert inst is cache._counters["hits"]
    before = cache.hits
    cache.hits += 1                      # writeable alias
    try:
        assert inst.value == before + 1
    finally:
        cache.hits = before


def test_only_the_shared_caches_register():
    """A backend's own cache counts privately; every device's shared
    cache counts into the one set of `precompute.*` instruments."""
    shared = shared_cache("cpu")
    own = TorchBackend("cpu").cache
    for name in PrecomputeCache.COUNTERS + ("lock_wait",):
        inst = metrics.REGISTRY.get(f"precompute.{name}")
        assert inst is shared._counters[name]
        assert own._counters[name] is not inst
        assert inst.always
    assert not metrics.REGISTRY.get("precompute.lock_wait").stable
    assert "precompute.lock_wait" not in metrics.REGISTRY.snapshot()
    before = metrics.REGISTRY.get("precompute.misses").value
    own.kes_get(("never-seen",))
    assert own.misses == 1
    assert metrics.REGISTRY.get("precompute.misses").value == before
    other = precompute.PrecomputeCache("cpu", register=True)
    assert other._counters["hits"] is shared._counters["hits"]


def test_min_bucket_lowers_the_padding_floor():
    assert TorchBackend("cpu")._pad(5) == 128
    small = TorchBackend("cpu", min_bucket=16)
    assert small.min_bucket == 16 and TorchBackend.min_bucket == 128
    assert [small._pad(n) for n in (1, 16, 17, 200)] == [16, 16, 32, 256]
