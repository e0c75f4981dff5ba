"""The metrics' arithmetic: the whole-pass rate, the span readers and the
rooflines' counts, on made-up runs."""
import pytest

import harness
import roofline


def _run(**kw):
    run = {"setup_s": 12.5, "window_s": 40.0, "passes": 8, "blocks": 16384,
           "windows": 16, "lanes": 1_000_000, "ed_lanes": 540_672,
           "vrf_lanes": 32_768, "trace": None}
    run.update(kw)
    return run


def _trace(**kw):
    tr = {"spans": {"window.host_seq": 8.0, "window.submit": 20.0,
                    "precompute.fill": 6.0, "window.fold": 2.0,
                    "window.drain": 0.4},
          "busy_s": 4.0, "kernel_s": {}, "device_ops": [], "idle_gaps": []}
    tr.update(kw)
    return tr


def read(name, run):
    return harness.reader(name)(run)


def test_rate_is_every_block_of_whole_passes_over_the_window():
    assert read("replay_blocks_per_s", _run()) == 16384 / 40.0
    assert read("setup_s", _run()) == 12.5


def test_span_readers():
    run = _run(trace=_trace())
    assert read("host_seq_us_per_block", run) == pytest.approx(
        1e6 * 8.0 / 16384)
    assert read("prep_us_per_lane", run) == pytest.approx(12.0)
    assert read("fill_ms_per_window", run) == pytest.approx(375.0)
    assert read("fold_ms_per_window", run) == pytest.approx(125.0)
    assert read("drain_wait_pct", run) == pytest.approx(1.0)
    assert read("device_idle_pct", run) == pytest.approx(90.0)


@pytest.mark.parametrize("name", ["host_seq_us_per_block",
                                  "prep_us_per_lane", "fill_ms_per_window",
                                  "fold_ms_per_window", "drain_wait_pct",
                                  "device_idle_pct",
                                  "ed25519_split_roofline",
                                  "vrf_verify_roofline"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    assert read(name, _run()) is None
    assert read(name, _run(trace=_trace(spans={}, busy_s=None))) is None


def test_roofline_counts():
    peak = 132 * 64 * 1980e6
    # operations bound both kernels: 208,330 multiply-adds against 129
    # bytes, 565,140 against 274
    assert roofline.least_seconds("ed25519_split", 4096) == pytest.approx(
        4096 * 208_330 / peak)
    assert roofline.least_seconds("vrf_verify", 2048) == pytest.approx(
        2048 * 565_140 / peak)
    # PR 17's device times: 0.3694 ms for 4096 lanes, 0.6731 for 2048
    run = _run(ed_lanes=4096, vrf_lanes=2048, trace=_trace(kernel_s={
        "ed25519_split_kernel(unsigned int const*)": 0.3694e-3,
        "vrf_verify_kernel(unsigned int const*)": 0.6731e-3}))
    assert read("ed25519_split_roofline", run) == pytest.approx(
        100 * 0.05101 / 0.3694, rel=1e-3)
    assert read("vrf_verify_roofline", run) == pytest.approx(
        100 * 0.06916 / 0.6731, rel=1e-3)
