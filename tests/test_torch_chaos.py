"""The port's chaos ThreadNet and network observability
(`ouroboros_tpu_torch.testing.threadnet`'s chaos section,
`ouroboros_tpu_torch.simharness.faults`, `ouroboros_tpu_torch.observe.
{adapter,propagation,scrape}`): the tier-1 cases of tests/test_chaos.py,
tests/test_netobs.py and tests/test_scrape.py, run against the port's
copies; and `chaos_config(1)` and `_fleet_config()` run in both packages on
their OpensslBackends, which must give the same fault events, chains,
suspensions and fleet report.

Reference: io-sim attenuated-bearer experiments x Test/ThreadNet/General.hs
prop_general; the reference's network tracers.

Tolerance: none.  Events, points and the fleet report's JSON compare
exactly.
"""
import dataclasses
import importlib
import json
import os
import sys
from fractions import Fraction

import pytest

from ouroboros_tpu_torch import simharness as sim
from ouroboros_tpu_torch.consensus.batch import replay_blocks_pipelined
from ouroboros_tpu_torch.consensus.headers import ProtocolBlock, make_header
from ouroboros_tpu_torch.consensus.ledger import ExtLedgerRules
from ouroboros_tpu_torch.crypto.backend import OpensslBackend
from ouroboros_tpu_torch.eras.shelley import (
    TPraosConfig, forge_tpraos_fields, shelley_genesis_setup,
)
from ouroboros_tpu_torch.network.deltaq import PeerGSVTracker
from ouroboros_tpu_torch.network.mux import (
    CodecChannel, INITIATOR, Mux, RESPONDER, bearer_pair,
)
from ouroboros_tpu_torch.network.protocols import keepalive
from ouroboros_tpu_torch.network.snocket import SimSnocket
from ouroboros_tpu_torch.network.typed import CLIENT, SERVER, Session, run_peer
from ouroboros_tpu_torch.node.watchdog import KeepAliveTimeout
from ouroboros_tpu_torch.observe import export, metrics
from ouroboros_tpu_torch.observe import metrics as om
from ouroboros_tpu_torch.observe import netmetrics as net
from ouroboros_tpu_torch.observe.propagation import (
    FleetTelemetry, PropagationTracker,
)
from ouroboros_tpu_torch.observe.scrape import (
    SCRAPE_PROTOCOL_NUM, PeriodicEmitter, ScrapeServer, scrape,
)
from ouroboros_tpu_torch.simharness import FaultPlan, FaultSpec, Partition
from ouroboros_tpu_torch.testing import (
    ChaosConfig, ThreadNetConfig, run_chaos_threadnet,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# -- tests/test_chaos.py -----------------------------------------------------

TIER1_SEEDS = (1, 2, 3)
WIDE_SEEDS = tuple(range(1, 21))


def chaos_config(seed: int) -> ChaosConfig:
    """Drops + stalls + disconnects + one partition on a 3-node mesh:
    hostile for the 30 measured slots, then a clean settle window in
    which the reconnect policy must heal the net."""
    return ChaosConfig(
        net=ThreadNetConfig(n_nodes=3, n_slots=30, k=10, f=0.5, seed=seed,
                            topology="mesh"),
        spec=FaultSpec(jitter=0.05, drop_prob=0.02, stall_prob=0.01,
                       stall_for=4.0, disconnect_prob=0.01),
        partitions=(
            Partition(10.0, 16.0, (("node0",), ("node1", "node2"))),),
        settle_slots=15,
        # keep the worst escalated backoff inside the settle window, or a
        # peer suspended late in the hostile tail misses the snapshot
        error_scale=0.5,
    )


@pytest.mark.parametrize("seed", TIER1_SEEDS)
def test_chaos_net_converges_and_recovers(seed):
    r = run_chaos_threadnet(chaos_config(seed))
    assert not r.failures, f"worker failures: {r.failures}\n{r.trace_tail()}"
    assert r.common_prefix_ok(10), (
        f"no common prefix, heights="
    f"{[c.head_block_no for c in r.chains]}\n{r.trace_tail()}")
    assert min(c.head_block_no for c in r.chains) >= 3, (
        f"net made no progress under faults\n{r.trace_tail()}")
    # fault injection actually happened, visible in the trace
    assert r.fault_events, r.trace_tail()
    assert any(e.kind == "fault" for e in r.trace), r.trace_tail()
    # at least one watchdog tripped on a silent peer...
    assert r.watchdog_events(), (
        f"no watchdog fired under faults\n{r.trace_tail()}")
    # ...at least one peer was demoted (error-policy suspension)...
    assert r.suspensions(), f"no peer demoted\n{r.trace_tail()}"
    # ...and demoted peers were later re-promoted (redialled)
    assert r.demoted_then_repromoted(), (
        f"no peer re-promoted after demotion\n{r.trace_tail()}")


@pytest.mark.parametrize("seed", TIER1_SEEDS)
def test_chaos_replay_is_byte_identical(seed):
    """Fault injection must not break sim determinism: the whole point of
    seeded chaos is that any failure reproduces from its seed."""
    r1 = run_chaos_threadnet(chaos_config(seed))
    r2 = run_chaos_threadnet(chaos_config(seed))
    assert r1.fault_events == r2.fault_events
    t1 = [repr(e) for e in r1.trace]
    t2 = [repr(e) for e in r2.trace]
    assert t1 == t2, f"replay diverged at event " \
        f"{next(i for i, (a, b) in enumerate(zip(t1, t2)) if a != b)}"


@pytest.mark.slow
@pytest.mark.parametrize("seed", WIDE_SEEDS)
def test_chaos_wide_sweep(seed):
    r = run_chaos_threadnet(chaos_config(seed))
    assert not r.failures, f"worker failures: {r.failures}\n{r.trace_tail()}"
    assert r.common_prefix_ok(10), (
        f"no common prefix, heights="
        f"{[c.head_block_no for c in r.chains]}\n{r.trace_tail()}")
    assert r.demoted_then_repromoted() or not r.suspensions(), (
        f"demoted peers never re-promoted\n{r.trace_tail()}")


# ---------------------------------------------------------------------------
# KeepAlive under faults: a stalled responder trips the reply watchdog
# ---------------------------------------------------------------------------

def test_keepalive_timeout_kills_stalled_responder_cleanly():
    """A responder whose replies never arrive (100% drop on its bearer)
    must trip the keep-alive reply deadline (timeLimitsKeepAlive), the
    kill must leave the mux closed with every channel poisoned, and the
    sim must wind down with no leaked threads (every forked tid reaches a
    terminal trace event)."""
    plan = FaultPlan(seed=5, spec=FaultSpec(drop_prob=1.0))

    async def main():
        ba, bb = bearer_pair(sdu_size=1024)
        # only the responder->initiator direction is hostile: probes
        # arrive, replies vanish — the silent-stall shape
        bb = plan.wrap_bearer(bb, "srv", "cli")
        mux_a, mux_b = Mux(ba, "cli"), Mux(bb, "srv")
        ka_a = CodecChannel(mux_a.channel(8, INITIATOR), keepalive.CODEC)
        ka_b = CodecChannel(mux_b.channel(8, RESPONDER), keepalive.CODEC)
        mux_a.start()
        mux_b.start()

        server = sim.spawn(run_peer(
            keepalive.SPEC, SERVER, ka_b, keepalive.server),
            label="ka-server")
        sess = Session(keepalive.SPEC, CLIENT, ka_a)
        client = sim.spawn(
            keepalive.client_probe(sess, rounds=None, interval=0.5,
                                   response_timeout=2.0),
            label="ka-client")
        try:
            await client.wait()
        except KeepAliveTimeout as e:
            verdict = e
        else:
            raise AssertionError("stalled responder did not trip the "
                                 "keep-alive watchdog")
        # the kernel supervisor's contract: the kill tears the mux down
        mux_a.stop()
        mux_b.stop()
        server.cancel()
        await sim.yield_()
        return verdict

    verdict, trace = sim.run_trace(main(), seed=5)
    assert verdict.protocol == "keep-alive"
    assert verdict.state == "KAServer"
    # the timeout decision is visible in the trace (debuggable chaos)
    assert any(e.kind == "watchdog" for e in trace), \
        "keep-alive timeout left no watchdog trace event"
    assert any(e.kind == "fault" for e in trace), \
        "dropped replies left no fault trace events"
    # no leaked sim threads: every fork reached stop/cancelled/fail
    leaked = sim.leaked_threads(trace)
    assert not leaked, f"leaked sim threads: {leaked}"


def test_faulty_channel_wait_ready_reports_dead_link_immediately():
    """A fault-killed edge must report ready at once (the caller's recv
    then raises LinkDown) instead of parking the watchdog's wait_ready
    for the full per-state limit — the same dead-transport contract
    MuxChannel honors for a closed mux."""
    from ouroboros_tpu_torch.simharness import LinkDown
    from ouroboros_tpu_torch.simharness.faults import FaultyChannel

    class NeverReady:
        async def wait_ready(self, timeout):
            await sim.sleep(timeout)
            return False

        async def recv(self):
            raise AssertionError("recv must not reach a dead link's inner")

    plan = FaultPlan(seed=1, spec=FaultSpec())
    ch = FaultyChannel(NeverReady(), plan, "a", "b")
    plan._edge("a", "b").down = True

    async def main():
        t0 = sim.now()
        assert await ch.wait_ready(60.0) is True
        assert sim.now() == t0          # immediate, no sim-time burned
        try:
            await ch.recv()
        except LinkDown:
            return "down"
        raise AssertionError("recv on a dead link did not raise LinkDown")

    assert sim.run(main(), seed=1) == "down"


def test_plan_task_still_blocked_at_snapshot_is_a_failure():
    """A planned event the net never saw must surface: a tx_plan task
    parked past the end of the run is reported, not silently dropped."""
    from ouroboros_tpu_torch.testing import run_threadnet

    cfg = ThreadNetConfig(
        n_nodes=2, n_slots=4, k=5, f=1.0, seed=1, topology="line",
        # slot far past the run's end: the submit task sleeps through
        # the snapshot and must be flagged as still blocked
        tx_plan=((400, 0, lambda keys, ledger: None),))
    r = run_threadnet(cfg)
    assert any(kind == "plan" and "still blocked" in str(detail)
               for kind, _label, detail in r.failures), r.failures


def test_fetch_deadline_unknown_tracker_gets_full_ceiling():
    """A tracker without the `measured` attribute fails SAFE (treated as
    unmeasured -> full busy ceiling), never the tight DeltaQ deadline."""
    from ouroboros_tpu_torch.node.watchdog import NodeTimeLimits

    class BareTracker:                   # no `measured`, no GSV history
        def expected_fetch_time(self, size):
            return 0.001                 # optimistically tiny

    limits = NodeTimeLimits()
    assert limits.fetch_deadline(BareTracker(), 2048) \
        == limits.block_fetch_busy
    assert limits.fetch_deadline(None, 2048) == limits.block_fetch_busy


def test_keepalive_healthy_responder_untouched_by_watchdog():
    """With no faults the reply deadline never fires: probes complete and
    feed RTTs exactly as before the watchdog existed."""
    async def main():
        ba, bb = bearer_pair(sdu_size=1024, delay=0.01)
        mux_a, mux_b = Mux(ba, "cli"), Mux(bb, "srv")
        ka_a = CodecChannel(mux_a.channel(8, INITIATOR), keepalive.CODEC)
        ka_b = CodecChannel(mux_b.channel(8, RESPONDER), keepalive.CODEC)
        mux_a.start()
        mux_b.start()
        server = sim.spawn(run_peer(
            keepalive.SPEC, SERVER, ka_b, keepalive.server),
            label="ka-server")
        sess = Session(keepalive.SPEC, CLIENT, ka_a)
        rtts = await keepalive.client_probe(
            sess, rounds=3, interval=0.5, response_timeout=2.0)
        mux_a.stop()
        mux_b.stop()
        server.cancel()
        return rtts

    rtts = sim.run(main(), seed=1)
    assert len(rtts) == 3
    assert all(r >= 0.02 for r in rtts)      # two bearer hops per probe


# -- tests/test_netobs.py ----------------------------------------------------

@pytest.fixture(autouse=True)
def _observation_on():
    """These tests are about what ENABLED observation records; restore
    whatever state the suite was in afterwards."""
    was = om.REGISTRY.enabled
    om.REGISTRY.enable()
    yield
    om.REGISTRY.enabled = was


# ---------------------------------------------------------------------------
# bounded labels
# ---------------------------------------------------------------------------

def test_bounded_labels_cap_and_overflow():
    dom = net.BoundedLabels(cap=3)
    labels = [dom.get(f"peer{i}") for i in range(3)]
    assert labels == ["peer0", "peer1", "peer2"]
    # at capacity a NEW value collapses into the overflow bucket...
    assert dom.get("peer3") == net.OVERFLOW_LABEL
    assert dom.overflows == 1
    # ...while admitted values keep their own label forever (no
    # eviction: an evicted-then-readmitted value would mint a second
    # registry series)
    assert dom.get("peer0") == "peer0"
    assert len(dom) == 3


def test_label_values_sanitised():
    dom = net.BoundedLabels(cap=4)
    assert dom.get('a"b\\c d{e}') == "a_b_c_d_e_"


def test_labeled_series_render_as_prometheus_labels():
    reg = om.MetricsRegistry()
    c = net.labeled_counter("net.mux.ingress_bytes", reg=reg,
                            peer="node0->node1", proto="2")
    c.inc(100)
    net.labeled_counter("net.mux.ingress_bytes", reg=reg,
                        peer="node0->node2", proto="2").inc(7)
    net.labeled_gauge("net.deltaq.g_secs", reg=reg,
                      peer="node0->node1").set(0.05)
    text = export.prometheus_text(reg)
    parsed = export.parse_prometheus_text(text)
    assert parsed[
        'ouro_net_mux_ingress_bytes{peer="node0->node1",proto="2"}'] \
        == 100
    assert parsed[
        'ouro_net_mux_ingress_bytes{peer="node0->node2",proto="2"}'] == 7
    assert parsed['ouro_net_deltaq_g_secs{peer="node0->node1"}'] == 0.05
    # ONE TYPE line per base metric: a real Prometheus parser rejects a
    # duplicate TYPE line, so labeled series of one base must share it
    assert text.count(
        "# TYPE ouro_net_mux_ingress_bytes counter") == 1
    # labeled series are live-exposition data, never the deterministic
    # snapshot
    assert reg.snapshot() == {}


# ---------------------------------------------------------------------------
# mux per-peer accounting
# ---------------------------------------------------------------------------

def _pump(n_bytes=4096, sdu_size=1024, num=2):
    """One mux pair moving `n_bytes` a->b on protocol `num`; returns
    (mux_a, mux_b)."""
    out = {}

    async def main():
        ba, bb = bearer_pair(sdu_size=sdu_size)
        ma, mb = Mux(ba, "A->B.mux-i"), Mux(bb, "A->B.mux-r")
        ma.start()
        mb.start()
        cha = ma.channel(num, INITIATOR)
        chb = mb.channel(num, RESPONDER)
        await cha.send(b"x" * n_bytes)
        got = b""
        while len(got) < n_bytes:
            got += await chb.recv()
        out["muxes"] = (ma, mb)
        ma.stop()
        mb.stop()
        return len(got)

    assert sim.run(main(), seed=1) == n_bytes
    return out["muxes"]


def test_mux_accounting_matches_injected_traffic():
    """On a fault-free link the accounting is EXACT: egress payload
    bytes on the sender equal the bytes the test injected, ingress on
    the receiver equals delivery, SDU counts match the sdu_size split."""
    net.reset_run_scope()
    ma, mb = _pump(n_bytes=4096, sdu_size=1024, num=2)
    assert ma._io is not None and mb._io is not None
    assert ma._io.egress_bytes == {2: 4096}
    assert ma._io.egress_sdus == {2: 4}
    assert mb._io.ingress_bytes == {2: 4096}
    assert mb._io.ingress_sdus == {2: 4}
    # the fleet aggregation view folds the same numbers per (edge, side)
    acct = net.mux_accounting()
    assert acct["A->B|i"]["egress_bytes"] == 4096
    assert acct["A->B|r"]["ingress_bytes"] == 4096
    assert acct["A->B|r"]["by_proto"]["2"]["in_sdus"] == 4
    # and the registry carries the labeled series
    c = om.REGISTRY.get(
        'net.mux.egress_bytes{peer="A->B",proto="2",side="i"}')
    assert c is not None and c.value >= 4096


def test_mux_disabled_observation_is_free():
    """With the registry disabled the mux hot path performs zero gated
    writes, zero label formats, and never builds the accounting object
    — the tier-1 bench --smoke probe's unit form."""
    om.REGISTRY.disable()
    writes0 = om.REGISTRY.data_writes
    formats0 = net.LABEL_FORMATS.value
    ma, mb = _pump()
    assert ma._io is None and mb._io is None
    assert om.REGISTRY.data_writes == writes0
    assert net.LABEL_FORMATS.value == formats0


def test_redials_of_one_edge_aggregate():
    """Connection tags carry a #seq per redial; the accounting folds
    them into ONE edge (bounded series under churn)."""
    net.reset_run_scope()
    io1 = net.MuxIO("node0->node1#1.mux-i")
    io2 = net.MuxIO("node0->node1#2.mux-i")
    io1.egress(2, 100)
    io2.egress(2, 50)
    acct = net.mux_accounting()
    assert list(acct) == ["node0->node1|i"]
    assert acct["node0->node1|i"]["egress_bytes"] == 150


# ---------------------------------------------------------------------------
# DeltaQ gauges + RTT histogram
# ---------------------------------------------------------------------------

def test_gsv_tracker_publishes_labeled_gauges():
    tr = PeerGSVTracker(label="gsvtest->peer")
    tr.observe_rtt(0.1)
    g = om.REGISTRY.get('net.deltaq.g_secs{peer="gsvtest->peer"}')
    assert g is not None and g.value == 0.05
    tr.observe_owd(0.02, 8192)
    assert g.value == 0.02            # min-tracked inbound G updated
    v = om.REGISTRY.get('net.deltaq.v_secs{peer="gsvtest->peer"}')
    assert v is not None
    # the keepalive RTT histogram saw the probe
    h = om.REGISTRY.get("net.rtt.keepalive_secs")
    assert h is not None and h.count >= 1


def test_gsv_tracker_unlabelled_publishes_nothing():
    before = len(om.REGISTRY._instruments)
    tr = PeerGSVTracker()
    tr.observe_rtt(0.1)
    gauges = [n for n in om.REGISTRY._instruments
              if n.startswith("net.deltaq.") and "{" in n
              and "unlabelled" in n]
    assert gauges == []
    assert tr._gauges is None
    assert len(om.REGISTRY._instruments) == before


# ---------------------------------------------------------------------------
# propagation timelines
# ---------------------------------------------------------------------------

def test_propagation_tracker_records_first_stage_times():
    from ouroboros_tpu_torch.utils.tracer import collecting
    tracer, events = collecting()

    async def main():
        tr = PropagationTracker(node="n0", cap=8, tracer=tracer)
        h = b"\x01" * 32
        assert tr.mark("header_seen", h, peer="n0->n1")
        await sim.sleep(0.5)
        assert tr.mark("fetch_decided", h, peer="n0->n1")
        await sim.sleep(0.25)
        assert tr.mark("body_arrived", h, peer="n0->n1")
        await sim.sleep(0.25)
        assert tr.mark("adopted", h)
        # duplicates are ignored: header_seen is FIRST-header-seen
        assert not tr.mark("header_seen", h, peer="n0->n2")
        return tr

    tr = sim.run(main(), seed=1)
    h = b"\x01" * 32
    assert tr.stage_time(h, "header_seen") == 0.0
    assert tr.stage_time(h, "fetch_decided") == 0.5
    assert tr.stage_time(h, "adopted") == 1.0
    assert tr.stage_peer(h, "header_seen") == "n0->n1"
    hist = om.REGISTRY.get("net.propagation.header_to_adopted_secs")
    assert hist is not None and hist.count >= 1
    # every mark emitted one TYPED event (duplicates emitted none), at
    # the exact virtual time, rendering through the JSONL schema
    assert [(e.stage, e.t) for e in events] == [
        ("header_seen", 0.0), ("fetch_decided", 0.5),
        ("body_arrived", 0.75), ("adopted", 1.0)]
    line = export.events_jsonl(events[:1])
    assert line.startswith('{"type":"TraceBlockPropagation"')
    assert '"node":"n0"' in line


def test_propagation_tracker_is_bounded():
    tr = PropagationTracker(node="n0", cap=2)
    for i in range(4):
        tr.mark("header_seen", bytes([i]) * 32, t=float(i))
    assert len(tr.timeline) == 2
    assert bytes([3]) * 32 in tr.timeline      # newest kept


def test_fleet_edge_latency_and_partition_healing():
    """Synthetic two-node fleet: delivery latency is the receiver's
    first-header-seen minus the sender's adoption, and a partition
    heals at the first cross-group delivery after its window."""
    fleet = FleetTelemetry(partitions=(
        Partition(1.2, 1.4, (("A",), ("B",))),))
    h = b"\x07" * 32
    ta = fleet.tracker("A")
    tb = fleet.tracker("B")
    ta.mark("adopted", h, t=1.0)
    tb.mark("header_seen", h, peer="B->A", t=1.5)   # receiver->sender
    tb.mark("adopted", h, t=1.6)
    rep = fleet.report()
    assert rep["per_edge_delivery"]["A->B"]["p50"] == 0.5
    assert rep["partitions"][0]["healed_after_secs"] == \
        pytest.approx(0.1)
    # both nodes adopted: time_to_95 over 2 nodes = second adoption
    assert rep["adoption"]["per_block"][0]["to_95"] == \
        pytest.approx(0.6)


# ---------------------------------------------------------------------------
# a seeded 10-node chaos fleet
# ---------------------------------------------------------------------------

def _fleet_config(seed: int = 7) -> ChaosConfig:
    half = tuple(f"node{i}" for i in range(5))
    other = tuple(f"node{i}" for i in range(5, 10))
    return ChaosConfig(
        net=ThreadNetConfig(n_nodes=10, n_slots=8, k=10, f=0.5,
                            seed=seed, topology="ring"),
        spec=FaultSpec(jitter=0.04, drop_prob=0.01),
        partitions=(Partition(3.0, 5.0, (half, other)),),
        settle_slots=6, error_scale=0.5)


def test_ten_node_chaos_fleet_report_and_replay_identity():
    cfg = _fleet_config()
    r1 = run_chaos_threadnet(cfg)
    assert not r1.failures, r1.failures
    fleet = r1.fleet
    assert fleet is not None and fleet["nodes"] == \
        [f"node{i}" for i in range(10)]

    # time-to-adoption quantiles are present and sane
    ad = fleet["adoption"]
    assert ad["blocks"] > 0
    assert ad["time_to_50"]["n"] > 0
    assert ad["time_to_95"]["n"] > 0
    assert 0 < ad["time_to_95"]["p50"]
    assert ad["time_to_50"]["p50"] <= ad["time_to_95"]["p50"]

    # per-peer mux accounting exists for the ring's edges, and drops
    # can only LOSE bytes: fleet-wide ingress never exceeds egress
    mux = fleet["mux"]
    assert mux
    assert sum(m["ingress_bytes"] for m in mux.values()) <= \
        sum(m["egress_bytes"] for m in mux.values())
    assert any(m["egress_bytes"] > 0 for m in mux.values())

    # headers crossed real edges
    assert fleet["per_edge_delivery"]

    # byte-identical across a replay of the same seed
    r2 = run_chaos_threadnet(cfg)
    assert json.dumps(r1.fleet, sort_keys=True) == \
        json.dumps(r2.fleet, sort_keys=True)


# ---------------------------------------------------------------------------
# scrape endpoint under fault injection
# ---------------------------------------------------------------------------

def test_scrape_sheds_faulted_connections_without_leaks():
    """Fault-injected scrapers (drops/stalls/disconnects on the request
    direction) must not leak connection handlers or stall the
    PeriodicEmitter: stop() cancel-joins every handler parked on a
    request that never arrived, and the emitter keeps its cadence
    throughout."""
    from ouroboros_tpu_torch.network.mux import SDU
    from ouroboros_tpu_torch.network.snocket import SimSnocket
    from ouroboros_tpu_torch.observe.scrape import (
        PeriodicEmitter, SCRAPE_PROTOCOL_NUM, SCRAPE_REQUEST,
        ScrapeServer,
    )

    plan = FaultPlan(seed=3, spec=FaultSpec(
        drop_prob=0.4, stall_prob=0.2, stall_for=0.5,
        disconnect_prob=0.2))
    emitted = []

    async def scrape_over(bearer):
        await bearer.write(SDU(0, 0, SCRAPE_PROTOCOL_NUM,
                               SCRAPE_REQUEST))
        chunks = []
        while True:
            sdu = await bearer.read()
            if not sdu.payload:
                break
            chunks.append(sdu.payload)
        return b"".join(chunks).decode()

    async def main():
        sn = SimSnocket()
        srv = await ScrapeServer(sn, "metrics").start()
        em = await PeriodicEmitter(0.5, emitted.append).start()
        outcomes = []
        for i in range(6):
            bearer = await sn.connect("metrics")
            faulty = plan.wrap_bearer(bearer, f"scraper{i}", "server")
            try:
                done, text = await sim.timeout(2.0, scrape_over(faulty))
                outcomes.append(bool(done and text))
            except ConnectionError:
                outcomes.append(False)
        await sim.sleep(1.0)
        await srv.stop()
        await em.stop()
        return outcomes

    outcomes, trace = sim.run_trace(main(), seed=3)
    # the hostile run injected real faults AND the server survived them
    assert plan.events, "fault plan injected nothing"
    assert len(outcomes) == 6
    # no leaked sim threads: every connection handler the server forked
    # for a silent/dead scraper was cancel-joined by stop()
    leaked = sim.leaked_threads(trace)
    assert not leaked, f"leaked sim threads: {leaked}"
    # the emitter never stalled: >= 6 sim-seconds of hostile scraping
    # at 0.5s cadence
    assert len(emitted) >= 6


# -- tests/test_scrape.py ----------------------------------------------------

CFG = TPraosConfig(k=3, f=Fraction(1, 2), epoch_length=20,
                   slots_per_kes_period=5, kes_depth=4,
                   max_kes_evolutions=14)


class AsyncStubBackend(OpensslBackend):
    """submit/finish-capable CPU backend: the pipelined driver takes its
    threaded path (and records submit→drain latency) without a device."""

    def submit_window(self, reqs, next_beta_proofs=()):
        return {"reqs": list(reqs),
                "beta_proofs": list(dict.fromkeys(next_beta_proofs))}

    def finish_window(self, state):
        ok = self.verify_mixed(state["reqs"])
        betas = dict(zip(state["beta_proofs"],
                         self.vrf_betas_batch(state["beta_proofs"])))
        return ok, betas


@pytest.fixture(scope="module")
def chain():
    protocol, ledger, pools = shelley_genesis_setup(2, CFG, seed=b"scr")
    ext = ExtLedgerRules(protocol, ledger)
    state = ext.initial_state()
    backend = OpensslBackend()
    blocks, prev = [], None
    slot = 0
    while len(blocks) < 12:
        view = ledger.forecast_view(state.ledger, slot)
        ticked = protocol.tick_chain_dep_state(
            state.header.chain_dep_state, view, slot)
        for p in pools:
            lead = protocol.check_is_leader(p["can_be_leader"], slot,
                                            ticked, view)
            if lead is None:
                continue
            h = make_header(prev, slot, (), issuer=0)
            h = forge_tpraos_fields(protocol, p["hot_key"],
                                    p["can_be_leader"], lead, h)
            blk = ProtocolBlock(h, ())
            state = ext.tick_then_apply(state, blk, backend=backend)
            blocks.append(blk)
            prev = h
            break
        slot += 1
    return ext, blocks


_leaked = sim.leaked_threads


# ---------------------------------------------------------------------------
# a replay-populated histogram scraped over the wire
# ---------------------------------------------------------------------------

def test_scrape_quantiles_from_pipelined_replay(chain):
    """A simharness client scrapes the live endpoint
    over the project's own bearer and parses p50/p95/p99 from the
    submit→drain histogram a pipelined replay populated."""
    ext, blocks = chain
    h = metrics.REGISTRY.get("pipeline.submit_drain_secs")
    count0 = h.count if h is not None else 0
    res = replay_blocks_pipelined(ext, blocks, ext.initial_state(),
                                  backend=AsyncStubBackend(), window=4)
    assert res.all_valid
    h = metrics.REGISTRY.get("pipeline.submit_drain_secs")
    assert h.count >= count0 + 3           # one observation per window

    async def main():
        sn = SimSnocket()
        srv = await ScrapeServer(sn, "metrics").start()
        try:
            return await scrape(sn, "metrics")
        finally:
            await srv.stop()

    text, trace = sim.run_trace(main())
    assert not _leaked(trace), f"leaked sim threads: {_leaked(trace)}"
    parsed = export.parse_prometheus_text(text)
    base = "ouro_pipeline_submit_drain_secs"
    assert parsed[base + "_count"] == h.count
    q = export.prom_histogram_quantiles(parsed, base)
    assert q == h.quantiles()              # wire == local, byte for byte
    assert 0 < q["p50"] <= q["p95"] <= q["p99"]
    # replay progress gauges rode along on the same exposition
    assert parsed["ouro_replay_progress_blocks_done"] == len(blocks)
    assert parsed["ouro_replay_progress_windows_in_flight"] == 0
    # ... and obsreport --live renders the frame
    from ouroboros_tpu_torch.obsreport import render_live
    live = render_live(parsed)
    assert f"{len(blocks)}/{len(blocks)} blocks" in live
    assert base in live


def test_replay_progress_gauges_and_hidden_frac(chain):
    ext, blocks = chain
    res = replay_blocks_pipelined(ext, blocks, ext.initial_state(),
                                  backend=AsyncStubBackend(), window=4)
    assert res.all_valid
    reg = metrics.REGISTRY
    assert reg.get("replay.progress.blocks_done").value == len(blocks)
    assert reg.get("replay.progress.total_blocks").value == len(blocks)
    assert reg.get("replay.progress.windows_in_flight").value == 0
    assert reg.get("replay.progress.blocks_per_sec").value > 0
    hf = reg.get("replay.progress.hidden_frac").value
    assert 0.0 <= hf <= 1.0


# ---------------------------------------------------------------------------
# protocol edges + shutdown discipline
# ---------------------------------------------------------------------------

def test_scrape_server_rejects_garbage_and_stays_up():
    from ouroboros_tpu_torch.network.mux import SDU

    async def main():
        sn = SimSnocket()
        srv = await ScrapeServer(sn, "metrics").start()
        try:
            bearer = await sn.connect("metrics")
            await bearer.write(SDU(0, 0, SCRAPE_PROTOCOL_NUM,
                                   b"GET /wrong"))
            # server closes without replying; a fresh well-formed
            # scrape on a NEW connection still succeeds
            return await scrape(sn, "metrics")
        finally:
            await srv.stop()

    text, trace = sim.run_trace(main())
    assert not _leaked(trace)
    assert "ouro_" in text


def test_scrape_stop_cancels_blocked_connection():
    """A client that connects and then stays silent must not keep a
    handler thread alive past stop()."""
    async def main():
        sn = SimSnocket()
        srv = await ScrapeServer(sn, "metrics").start()
        await sn.connect("metrics")        # dial, never send
        await sim.sleep(1.0)
        await srv.stop()

    _, trace = sim.run_trace(main())
    assert not _leaked(trace), f"leaked sim threads: {_leaked(trace)}"


def test_periodic_emitter_exact_virtual_cadence_and_clean_stop():
    reg = metrics.MetricsRegistry()
    reg.counter("em.count").inc(4)
    emitted = []

    async def main():
        em = await PeriodicEmitter(
            2.0, lambda text: emitted.append((sim.now(), text)),
            registry=reg).start()
        await sim.sleep(7.0)
        await em.stop()

    _, trace = sim.run_trace(main())
    assert not _leaked(trace)
    assert [t for t, _ in emitted] == [2.0, 4.0, 6.0]
    assert all("ouro_em_count 4" in text for _, text in emitted)


def test_scrape_works_under_io_runtime_over_real_sockets():
    """The SAME server/client code over TcpSnocket + SocketBearer (the
    production path): one round-trip on a loopback ephemeral port."""
    from ouroboros_tpu_torch.network.snocket import TcpSnocket
    from ouroboros_tpu_torch.simharness import io_run

    reg = metrics.MetricsRegistry()
    reg.counter("tcp.probe").inc(9)

    async def main():
        srv = ScrapeServer(TcpSnocket(), ("127.0.0.1", 0), registry=reg)
        await srv.start()
        try:
            return await scrape(TcpSnocket(), srv.listener.addr)
        finally:
            await srv.stop()

    parsed = export.parse_prometheus_text(io_run(main()))
    assert parsed["ouro_tcp_probe"] == 9.0


# ---------------------------------------------------------------------------
# ouro-race: the endpoint + emitter composition explored under K schedules
# ---------------------------------------------------------------------------

def test_scrape_and_emitter_race_free_at_k8():
    """ScrapeServer + PeriodicEmitter + a metric-writing worker under
    K=8 seeded schedule perturbations: no unordered access pair, no
    failure, deterministic report — the telemetry plane must not be the
    thing that races (it runs inside every future soak)."""
    def make_program():
        async def main():
            reg = metrics.MetricsRegistry()
            c = reg.counter("race.count")
            sn = SimSnocket()
            srv = await ScrapeServer(sn, "m", registry=reg).start()
            emitted = []
            em = await PeriodicEmitter(0.5, emitted.append,
                                       registry=reg).start()

            async def worker():
                for _ in range(5):
                    c.inc()
                    await sim.sleep(0.3)

            w = sim.spawn(worker(), label="writer")
            texts = []
            for _ in range(3):
                texts.append(await scrape(sn, "m"))
                await sim.sleep(0.4)
            await w.wait()
            await em.stop()
            await srv.stop()
            # monotone visibility: later scrapes never lose counts
            counts = [export.parse_prometheus_text(t)["ouro_race_count"]
                      for t in texts]
            assert counts == sorted(counts)
        return main()

    rep = sim.explore_races(make_program, k=8, seed=3)
    assert not rep.failures, rep.render()
    assert not rep.found, rep.render()
    rep2 = sim.explore_races(make_program, k=8, seed=3)
    assert rep.render() == rep2.render()   # deterministic report


# -- the same chaos runs in both packages -------------------------------------

def _in_package(pkg: str, cfg: ChaosConfig):
    """The port's ChaosConfig `cfg` rebuilt from package `pkg`'s classes,
    field for field."""
    tn = importlib.import_module(f"{pkg}.testing")
    s = importlib.import_module(f"{pkg}.simharness")
    wd = importlib.import_module(f"{pkg}.node.watchdog")

    def copy(cls, obj):
        return cls(**{f.name: getattr(obj, f.name)
                      for f in dataclasses.fields(obj)})
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw.update(net=copy(tn.ThreadNetConfig, cfg.net),
              spec=copy(s.FaultSpec, cfg.spec),
              partitions=tuple(copy(s.Partition, p) for p in cfg.partitions),
              time_limits=copy(wd.NodeTimeLimits, cfg.time_limits))
    return tn.ChaosConfig(**kw)


def _chaos_record(pkg: str, cfg: ChaosConfig) -> dict:
    tn = importlib.import_module(f"{pkg}.testing")
    r = tn.run_chaos_threadnet(_in_package(pkg, cfg))
    return {"failures": [(n, t, repr(e)) for n, t, e in r.failures],
            "fault_events": r.fault_events,
            "chains": [[p.encode() for p in c.points()] for c in r.chains],
            "suspensions": r.suspensions(),
            "repromoted": r.demoted_then_repromoted(),
            "watchdog": [(e.time, e.payload) for e in r.watchdog_events()],
            "fleet": json.dumps(r.fleet, sort_keys=True)}


@pytest.mark.parametrize("which", ["chaos_config(1)", "_fleet_config()"])
def test_chaos_runs_equal_the_jax_packages(which):
    cfg = chaos_config(1) if which == "chaos_config(1)" else _fleet_config()
    want = _chaos_record("ouroboros_tpu", cfg)
    got = _chaos_record("ouroboros_tpu_torch", cfg)
    assert want["failures"] == [] and want["fault_events"]
    assert want["suspensions"]
    for key in want:
        assert got[key] == want[key], key
