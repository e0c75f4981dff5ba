"""The window seam's readers, the fill's wait and the sequential pass's
off-CPU share, on made-up runs: their arithmetic, and nothing read where
the program recorded nothing to read."""
import pytest

import harness

SEAM = ("split_us_per_lane", "pack_us_per_lane", "cache_us_per_lane",
        "attach_us_per_lane", "launch_us_per_lane")
ALL = SEAM + ("fill_wait_ms_per_window", "host_seq_offcpu_pct")


def _run(spans=None, **kw):
    run = {"setup_s": 12.5, "window_s": 40.0, "passes": 8, "blocks": 16384,
           "windows": 16, "lanes": 1_000_000, "ed_lanes": 540_672,
           "vrf_lanes": 32_768,
           "trace": None if spans is None else {
               "spans": spans, "busy_s": 4.0, "kernel_s": {},
               "device_ops": [], "idle_gaps": []}}
    run.update(kw)
    return run


SPANS = {"window.submit": 20.0, "precompute.fill": 6.0, "window.fold": 2.0,
         "submit.split": 1.0, "submit.pack": 5.0,
         "precompute.assemble": 8.5, "precompute.fill_wait": 4.0,
         "submit.attach": 0.5, "submit.launch": 1.5}


def read(name, run):
    return harness.reader(name)(run)


class _Recorder:
    def __init__(self, totals):
        self._totals = totals

    def totals(self):
        return dict(self._totals)


@pytest.fixture
def recorder(monkeypatch):
    from ouroboros_tpu_torch.observe import spans

    def use(totals):
        monkeypatch.setattr(spans, "RECORDER", _Recorder(totals))
    return use


def test_the_seam_readers_split_prep_where_it_happens():
    run = _run(SPANS)
    got = {name: read(name, run) for name in SEAM}
    assert got == pytest.approx({
        "split_us_per_lane": 1.0, "pack_us_per_lane": 5.0,
        "cache_us_per_lane": 2.5, "attach_us_per_lane": 0.5,
        "launch_us_per_lane": 1.5})
    # the five lie inside prep (window.submit less fill and fold)
    assert sum(got.values()) <= read("prep_us_per_lane", run)
    assert read("fill_wait_ms_per_window", run) == pytest.approx(250.0)
    assert read("fill_wait_ms_per_window", run) \
        <= read("fill_ms_per_window", run)


def test_without_a_fill_the_cache_is_all_host():
    spans = {k: v for k, v in SPANS.items() if not k.startswith(
        "precompute.fill")}
    run = _run(spans)
    assert read("cache_us_per_lane", run) == pytest.approx(8.5)
    assert read("fill_wait_ms_per_window", run) is None


def test_off_cpu_share_of_the_sequential_pass(recorder):
    recorder({"window.host_seq": (32, 8.0, 6.0)})
    assert read("host_seq_offcpu_pct", _run(SPANS)) == pytest.approx(25.0)
    # untraced: nothing read, whatever the recorder holds
    assert read("host_seq_offcpu_pct", _run()) is None


@pytest.mark.parametrize("totals", [{}, {"window.host_seq": (3, 1.5, None)},
                                    {"window.host_seq": (0, 0.0, 0.0)}],
                         ids=["absent", "no-cpu", "empty"])
def test_off_cpu_share_with_nothing_to_read(recorder, totals):
    recorder(totals)
    assert read("host_seq_offcpu_pct", _run(SPANS)) is None


def test_a_program_without_totals_gives_nothing(monkeypatch):
    from ouroboros_tpu_torch.observe import spans
    monkeypatch.setattr(spans, "RECORDER", object())
    assert read("host_seq_offcpu_pct", _run(SPANS)) is None


@pytest.mark.parametrize("name", ALL)
def test_a_seam_reader_with_nothing_to_read_returns_nothing(name, recorder):
    recorder({})
    assert read(name, _run()) is None
    assert read(name, _run({})) is None
    assert read(name, _run(SPANS, lanes=0, windows=0)) is None
