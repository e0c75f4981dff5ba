"""The window seam's spans and the recorder's CPU time (observe/spans.py).

A replay on the CPU records every span of a submit where its work
happens: `submit.split`, `submit.pack`, `precompute.assemble` (with the
fill and its wait inside it), `submit.launch`, then `submit.attach` and
`window.fold` side by side.  Each span carries its thread's CPU seconds
outside a runtime, and `SpanRecorder.totals()` sums both by name.
"""
import time
from types import SimpleNamespace

import pytest

from ouroboros_tpu_torch import replay
from ouroboros_tpu_torch import simharness as sim
from ouroboros_tpu_torch.crypto.backend import Ed25519Req
from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend
from ouroboros_tpu_torch.observe import spans
from ouroboros_tpu_torch.observe.spans import SpanRecorder

SEAM = ("submit.split", "submit.pack", "precompute.assemble",
        "submit.launch", "submit.attach", "window.fold")
EXISTING = ("window.submit", "precompute.fill", "window.fold",
            "window.host_seq", "window.drain", "pipeline.drain")
EPS = 1e-3


def _boom(*_a):
    raise AssertionError("a clock was read")


class _NoLock:
    def __enter__(self):
        raise AssertionError("a lock was taken")

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module")
def replayed():
    """One recorded replay of 12 blocks in windows of 8: its result and
    the root spans it closed."""
    seen = []
    real = replay._span_seconds

    def keep(roots, names=replay.SPANS):
        seen.append(roots)
        return real(roots, names)

    replay._span_seconds = keep
    try:
        out = replay.run(blocks=12, window=8, device="cpu", kes_depth=3)
    finally:
        replay._span_seconds = real
    (roots,) = seen
    return out["runs"][0], roots


def _named(roots, name):
    return [s for r in roots for s in r.walk() if s.name == name]


def test_a_replay_records_the_seam_where_its_work_happens(replayed):
    run, roots = replayed
    assert run["result"].all_valid and run["state_hash_match"]
    submits = [r for r in roots if r.name == "window.submit"]
    assert len(submits) == 2
    for sub in submits:
        names = [c.name for c in sub.children]
        # split, then the packers and the cache, launches; the fold's
        # host side closes before the fold opens, as siblings
        assert names[0] == "submit.split"
        assert {"submit.pack", "precompute.assemble", "submit.launch",
                "submit.attach", "window.fold"} <= set(names)
        assert names.index("submit.attach") + 1 == names.index("window.fold")
        (attach,) = [c for c in sub.children if c.name == "submit.attach"]
        (fold,) = [c for c in sub.children if c.name == "window.fold"]
        assert attach.t1 <= fold.t0 and not fold.children
        for asm in _named([sub], "precompute.assemble"):
            assert all(c.name == "precompute.fill" for c in asm.children)
            for fill in asm.children:
                assert [c.name for c in fill.children] \
                    == ["precompute.fill_wait"]
    # the first window fills every key it meets
    first = _named([submits[0]], "precompute.fill")
    assert first and first[0].children[0].duration > 0
    for name in SEAM + ("precompute.fill_wait",):
        assert _named(roots, name), name
    # each parent's children take no more than the parent
    for r in roots:
        for sp in r.walk():
            assert sum(c.duration for c in sp.children) <= sp.duration + 1e-9
            assert sp.cpu is not None and sp.cpu <= sp.duration + EPS
    # the existing spans keep one a window; the fill one at most an
    # assemble (the Ed25519 keys' and the VRF keys')
    for name in EXISTING:
        if name != "precompute.fill":
            assert len(_named(roots, name)) == 2, name
    for sub in submits:
        assert len(_named([sub], "precompute.fill")) \
            <= len(_named([sub], "precompute.assemble"))
    assert 0.0 <= run["host_seq_offcpu_pct"] <= 100.0
    assert all(len(run["spans"][name]) == 2 for name in replay.SPANS)


def test_a_disabled_recorder_reads_no_clock_and_takes_no_lock(monkeypatch):
    rec = spans.RECORDER
    monkeypatch.setattr(rec, "enabled", False)
    monkeypatch.setattr(rec, "_lock", _NoLock())
    monkeypatch.setattr(spans, "time", SimpleNamespace(perf_counter=_boom,
                                                      thread_time=_boom))
    with rec.span("a", cat="dispatch"), spans.span("b", cat="device"):
        pass
    be = TorchBackend("cpu", min_bucket=16)
    ok, _betas = be.finish_window(be.submit_window(
        [Ed25519Req(b"\x01" * 32, b"m", b"\x00" * 64)], fold=True))
    assert ok.first_bad == 0
    assert rec.roots == [] and rec._stack == []


def test_cpu_time_is_the_threads_own():
    rec = SpanRecorder(enabled=True)
    with rec.span("sleep", cat="stall"):
        time.sleep(0.05)
    with rec.span("spin", cat="host-seq"):
        sum(range(200_000))
    sleep, spin = rec.drain()
    assert sleep.cpu < 0.5 * sleep.duration
    for sp in (sleep, spin):
        assert 0.0 <= sp.cpu <= sp.duration + EPS


def test_totals_count_by_name_from_the_last_enable():
    rec = SpanRecorder(enabled=True)
    for _ in range(3):
        with rec.span("x", cat="dispatch"):
            with rec.span("y", cat="dispatch"):
                pass
    rec.drain()
    rec.disable()
    t = rec.totals()
    assert t["x"][0] == 3 and t["y"][0] == 3
    assert t["x"][1] >= t["y"][1] > 0 and t["x"][2] >= 0
    with rec.span("z"):                    # disabled: not counted
        pass
    assert rec.totals() == t
    rec.enable()
    assert rec.totals() == {}
    with rec.span("z"):
        pass
    assert rec.totals()["z"][0] == 1
    rec.clear()
    assert rec.totals() == {}


def test_cpu_stays_none_under_a_runtime():
    rec = SpanRecorder(enabled=True)

    async def main():
        with rec.span("rep", cat="host-seq"):
            await sim.sleep(1.5)

    sim.run(main())
    (rep,) = rec.drain()
    assert rep.duration == 1.5 and rep.cpu is None
    assert rec.totals() == {"rep": (1, 1.5, None)}
    assert replay.offcpu_pct([rep], "rep") is None
