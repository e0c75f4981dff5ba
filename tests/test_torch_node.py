"""The port's node layer (`ouroboros_tpu_torch.node`: the ChainSync client
and server, BlockFetch, the NodeKernel, BlockchainTime, the watchdogs and
`run_node`): the cases of tests/test_fetch_modes.py, tests/test_node_layer.py,
tests/test_node_run.py and tests/test_review_fixes.py, run against the
port's copies; and, in both packages over the same blocks (forged by the
JAX package and carried across as their CBOR bytes), a peer that serves a
header with a flipped KES signature, dropped with ChainSyncClientError,
and a caught-up follower whose one-header flush goes through
`validate_headers_coalesced` and a VerifyService.

Reference: ouroboros-network's BlockFetch decision tests, the
MiniProtocol/ChainSync client tests, Node.hs's run assembly.

Tolerance: none.  Points, verdicts, flush sizes and errors compare exactly.
"""
import importlib

import pytest

from ouroboros_tpu_torch import simharness as sim
from ouroboros_tpu_torch.chain import (
    AnchoredFragment, Chain, ChainProducerState, Point, make_block,
)
from ouroboros_tpu_torch.chain.block import GENESIS_HASH
from ouroboros_tpu_torch.consensus.headers import make_header
from ouroboros_tpu_torch.network import typed
from ouroboros_tpu_torch.network.channel import channel_pair
from ouroboros_tpu_torch.network.deltaq import GSV, PeerGSV, PeerGSVTracker
from ouroboros_tpu_torch.network.mux import (INITIATOR, RESPONDER, Mux,
                                             bearer_pair)
from ouroboros_tpu_torch.network.node_to_node import (
    accept_same_magic, node_to_node_versions,
)
from ouroboros_tpu_torch.network.protocols import chainsync
from ouroboros_tpu_torch.node import (
    BlockchainTime, BlockForging, RunNodeArgs, WrongNetworkError, run_node,
    was_clean_shutdown,
)
from ouroboros_tpu_torch.node.block_fetch import (
    FetchBudget, FetchRequest, PeerFetchState, fetch_decisions,
)
from ouroboros_tpu_torch.storage import MockFS
from ouroboros_tpu_torch.testing import ThreadNetConfig, run_threadnet
from ouroboros_tpu_torch.testing.threadnet import PraosNetworkFactory
from ouroboros_tpu_torch.utils import cbor



# -- tests/test_fetch_modes.py ---------------------------------------------------

def _chain(n):
    hs, prev = [], None
    for i in range(n):
        h = make_header(prev, i, (), issuer=0)
        hs.append(h)
        prev = h
    return hs


def _frag(headers):
    f = AnchoredFragment(Point.genesis(), (), anchor_block_no=-1)
    for h in headers:
        f.add_block(h)
    return f


class TestFetchModes:
    def test_bulk_mode_prefers_big_batches_few_peers(self):
        hs = _chain(64)
        frag = _frag(hs)
        peers = {f"p{i}": PeerFetchState(f"p{i}") for i in range(6)}
        reqs = fetch_decisions({p: frag for p in peers}, peers,
                               lambda f: True, lambda h: False,
                               budget=FetchBudget.bulk_sync())
        # concurrency capped at 2, requests up to 32 blocks
        assert len(reqs) <= 2
        assert max(len(r.headers) for r in reqs) > 16

    def test_deadline_mode_spreads_small_requests(self):
        hs = _chain(64)
        frag = _frag(hs)
        peers = {f"p{i}": PeerFetchState(f"p{i}") for i in range(6)}
        reqs = fetch_decisions({p: frag for p in peers}, peers,
                               lambda f: True, lambda h: False,
                               budget=FetchBudget.deadline())
        assert all(len(r.headers) <= 4 for r in reqs)
        assert len(reqs) >= 2            # more peers participate

    def test_slow_peer_loses_the_fetch_race(self):
        """With DeltaQ ordering, the cheap peer gets the request; the
        slow peer's expected duration exceeds the deadline bound and it
        gets nothing."""
        hs = _chain(8)
        frag = _frag(hs)
        fast = PeerFetchState("fast")
        slow = PeerFetchState("slow")

        class _T:
            """DeltaQ tracker shim: fixed G/S expected fetch time."""

            def __init__(self, g, s):
                self.g, self.s = g, s

            def expected_fetch_time(self, nbytes):
                return 2 * self.g + self.s * nbytes

        gsvs = {"fast": _T(0.01, 1e-7), "slow": _T(4.0, 1e-3)}
        reqs = fetch_decisions(
            {"fast": frag, "slow": frag},
            {"fast": fast, "slow": slow},
            lambda f: True, lambda h: False,
            order_key=lambda p: gsvs[p].expected_fetch_time(4096),
            budget=FetchBudget.deadline(),
            gsv=gsvs.get)
        assert reqs, "no requests at all"
        assert all(r.peer_id == "fast" for r in reqs)


    def test_decision_flips_on_gsv_change_alone(self):
        """Same candidates, same in-flight state, same everything except
        one peer's GSV estimate: the request target flips (the decision
        flips on a GSV change alone)."""
        hs = _chain(4)
        frag = _frag(hs)

        class _T:
            def __init__(self, g, s):
                self.g, self.s = g, s

            def expected_fetch_time(self, nbytes):
                return 2 * self.g + self.s * nbytes

        def decide(g_a, g_b):
            peers = {"a": PeerFetchState("a"), "b": PeerFetchState("b")}
            gsvs = {"a": _T(g_a, 1e-7), "b": _T(g_b, 1e-7)}
            reqs = fetch_decisions(
                {"a": frag, "b": frag}, peers,
                lambda f: True, lambda h: False,
                order_key=lambda p: gsvs[p].expected_fetch_time(4096),
                budget=FetchBudget.deadline(), gsv=gsvs.get)
            assert reqs
            return reqs[0].peer_id

        assert decide(0.01, 0.3) == "a"
        assert decide(0.3, 0.01) == "b"   # ONLY the GSVs swapped

    def test_deadline_mode_races_slow_in_flight_claim(self):
        """A block in flight with a slow peer is re-requested by a much
        faster newcomer in deadline mode (duplicate race), but never in
        bulk-sync mode (Decision.hs FetchMode semantics)."""
        hs = _chain(2)
        frag = _frag(hs)

        class _T:
            def __init__(self, eta):
                self.eta = eta

            def expected_fetch_time(self, nbytes):
                return self.eta

        slow = PeerFetchState("slow")
        slow.in_flight = {h.hash for h in hs}
        slow.in_flight_bytes = 4096
        fast = PeerFetchState("fast")
        gsvs = {"slow": _T(30.0), "fast": _T(0.05)}

        def decide(budget):
            return fetch_decisions(
                {"fast": frag}, {"slow": slow, "fast": fast},
                lambda f: True, lambda h: False,
                order_key=lambda p: gsvs[p].expected_fetch_time(4096),
                budget=budget, gsv=gsvs.get)

        raced = decide(FetchBudget.deadline())
        assert raced and raced[0].peer_id == "fast"
        assert {h.hash for h in raced[0].headers} == slow.in_flight
        assert decide(FetchBudget.bulk_sync()) == []

    def test_no_race_when_claimant_is_fast_enough(self):
        """The duplicate race needs a clear win: a modestly slower claim
        is NOT re-fetched (duplicate downloads are not free)."""
        hs = _chain(2)
        frag = _frag(hs)

        class _T:
            def __init__(self, eta):
                self.eta = eta

            def expected_fetch_time(self, nbytes):
                return self.eta

        claimant = PeerFetchState("claimant")
        claimant.in_flight = {h.hash for h in hs}
        other = PeerFetchState("other")
        gsvs = {"claimant": _T(0.4), "other": _T(0.3)}   # only 1.3x faster
        reqs = fetch_decisions(
            {"other": frag}, {"claimant": claimant, "other": other},
            lambda f: True, lambda h: False,
            order_key=lambda p: gsvs[p].expected_fetch_time(4096),
            budget=FetchBudget.deadline(), gsv=gsvs.get)
        assert reqs == []


class TestWatermarkPipelining:
    def test_low_high_mark_policy(self):
        """pipelineDecisionLowHighMark: fill to the high mark while
        behind; once caught up, only refill to the low mark."""
        from ouroboros_tpu_torch.node.chain_sync import pipeline_decision
        high, low = 8, 2
        # behind the tip: pipeline all the way to high
        assert [pipeline_decision(n, low, high, False) for n in range(10)] \
            == ["pipeline"] * 8 + ["collect"] * 2
        # caught up: refill only to low
        assert [pipeline_decision(n, low, high, True) for n in range(10)] \
            == ["pipeline"] * 2 + ["collect"] * 8

    def test_client_syncs_with_watermarks_active(self):
        """End-to-end smoke: a fresh node fully syncs a 12-block chain
        through the watermarked client (the policy must not starve)."""
        from ouroboros_tpu_torch.network.channel import channel_pair
        from ouroboros_tpu_torch.network.protocols import chainsync as cs
        from ouroboros_tpu_torch.network.typed import CLIENT, PipelinedSession
        from ouroboros_tpu_torch.node.chain_sync import (
            CandidateState, chain_sync_client, chain_sync_server,
        )
        from ouroboros_tpu_torch.testing.threadnet import (
            PraosNetworkFactory, ThreadNetConfig,
        )
        cfg = ThreadNetConfig(n_nodes=1, n_slots=1, k=8, f=1.0)
        factory = PraosNetworkFactory(cfg)
        window = 8

        async def main():
            kern = factory.make_node(0)
            ext = kern.chain_db.current_ledger
            for slot in range(12):
                blk = factory.forge_at(0, slot, ext)
                kern.chain_db.add_block(blk)
                ext = kern.chain_db.current_ledger
            peer = factory.make_node(0)      # fresh empty node syncs
            ca, cb = channel_pair(capacity=256)
            session = PipelinedSession(cs.SPEC, CLIENT, ca,
                                       max_outstanding=window)
            cand = CandidateState("srv")
            srv = sim.spawn(chain_sync_server(
                _ServerSession(cb), kern.chain_db), label="srv")
            cli = sim.spawn(chain_sync_client(session, peer, cand,
                                              window=window),
                            label="cli")
            await sim.sleep(5.0)
            out = len(cand.fragment)
            cli.cancel()
            srv.cancel()
            kern.stop()
            peer.stop()
            return out

        assert sim.run(main(), seed=4) == 12


class _ServerSession:
    """Minimal Session shim over a raw channel for the example server."""

    def __init__(self, ch):
        self.channel = ch

    async def send(self, msg):
        await self.channel.send(msg)

    async def recv(self):
        return await self.channel.recv()

def test_queued_requests_claim_blocks_too():
    """A FetchRequest sitting in a peer's queue (not yet in flight)
    claims its blocks: bulk-sync mode never hands them to another peer
    (regression: queued claims were keyed by header object, not hash)."""
    from ouroboros_tpu_torch import simharness as sim
    from ouroboros_tpu_torch.node.block_fetch import FetchRequest

    hs = _chain(4)
    frag = _frag(hs)

    async def main():
        a = PeerFetchState("a")
        b = PeerFetchState("b")
        req = FetchRequest("a", frag.anchor, tuple(hs))
        await sim.atomically(lambda tx: a.queue.put(tx, req))
        return fetch_decisions(
            {"b": frag}, {"a": a, "b": b},
            lambda f: True, lambda h: False,
            budget=FetchBudget.bulk_sync())

    assert sim.run(main()) == []


# -- tests/test_node_layer.py ----------------------------------------------------

def _header_chain(n, start_slot=0):
    hs, prev = [], None
    for i in range(n):
        h = make_header(prev, start_slot + i, (), issuer=0)
        hs.append(h)
        prev = h
    return hs


class TestFetchDecisions:
    def test_assigns_first_needed_run(self):
        hs = _header_chain(5)
        frag = _frag(hs)
        ps = {"p": PeerFetchState("p")}
        have = {hs[0].hash}
        reqs = fetch_decisions({"p": frag}, ps, lambda f: True,
                               lambda h: h in have)
        assert len(reqs) == 1
        req = reqs[0]
        assert [h.slot for h in req.headers] == [1, 2, 3, 4]
        # start is exclusive: the last stored block's point
        assert req.start.hash == hs[0].hash

    def test_skips_busy_peer_and_claimed_blocks(self):
        hs = _header_chain(4)
        frag = _frag(hs)
        busy = PeerFetchState("busy")
        busy.in_flight = {hs[0].hash, hs[1].hash}
        idle = PeerFetchState("idle")
        reqs = fetch_decisions({"busy": frag, "idle": frag},
                               {"busy": busy, "idle": idle},
                               lambda f: True, lambda h: False)
        # busy peer gets nothing; idle peer gets the unclaimed suffix
        assert len(reqs) == 1
        assert reqs[0].peer_id == "idle"
        assert [h.slot for h in reqs[0].headers] == [2, 3]

    def test_not_plausible_not_fetched(self):
        frag = _frag(_header_chain(3))
        ps = {"p": PeerFetchState("p")}
        assert fetch_decisions({"p": frag}, ps, lambda f: False,
                               lambda h: False) == []

    def test_order_key_prefers_cheaper_peer(self):
        hs = _header_chain(3)
        fa, fb = _frag(hs), _frag(hs)
        ps = {"a": PeerFetchState("a"), "b": PeerFetchState("b")}
        reqs = fetch_decisions({"a": fa, "b": fb}, ps, lambda f: True,
                               lambda h: False,
                               order_key={"a": 5.0, "b": 0.1}.get)
        # same candidate quality: the cheaper peer (b) gets the run
        assert reqs[0].peer_id == "b"

    def test_frontier_advances_over_stored_prefix(self):
        hs = _header_chain(6)
        frag = _frag(hs)
        ps = PeerFetchState("p")
        have = {h.hash for h in hs[:3]}
        reqs = fetch_decisions({"p": frag}, {"p": ps}, lambda f: True,
                               lambda h: h in have)
        assert [h.slot for h in reqs[0].headers] == [3, 4, 5]
        assert ps.done_through is not None
        assert ps.done_through.hash == hs[2].hash
        # fetch_logic_loop records the claims; then no new work is assigned
        ps.in_flight = {h.hash for h in reqs[0].headers}
        assert fetch_decisions({"p": frag}, {"p": ps}, lambda f: True,
                               lambda h: h in have) == []


class TestDeltaQ:
    def test_rtt_min_tracking(self):
        t = PeerGSVTracker()
        for rtt in (0.10, 0.30, 0.08, 0.25):
            t.observe_rtt(rtt)
        assert t.gsv.outbound.g == pytest.approx(0.04)
        assert t.gsv.inbound.g == pytest.approx(0.04)
        assert t.gsv.outbound.v > 0          # jitter observed

    def test_transfer_refines_s(self):
        t = PeerGSVTracker()
        t.observe_rtt(0.1)
        t.observe_transfer(100_000, 0.05 + 100_000 * 1e-6)
        assert t.gsv.inbound.s == pytest.approx(1e-6, rel=0.01)
        small = t.expected_fetch_time(1_000)
        big = t.expected_fetch_time(1_000_000)
        assert big > small

    def test_request_response_duration(self):
        g = PeerGSV(GSV(0.01, 1e-6, 0.0), GSV(0.02, 2e-6, 0.005))
        d = g.request_response_duration(100, 10_000)
        assert d == pytest.approx(0.01 + 1e-7 * 1000 + 0.02 + 0.02 + 0.005,
                                  rel=0.5)


class TestHandshakePolicy:
    def test_same_magic_highest_common(self):
        local = node_to_node_versions(7)
        proposed = tuple((v, {"magic": 7})
                         for v in node_to_node_versions(7).numbers())
        assert accept_same_magic(local, proposed) == \
            max(local.numbers())

    def test_magic_mismatch_refused(self):
        local = node_to_node_versions(7)
        proposed = tuple((v, {"magic": 8}) for v in local.numbers())
        assert accept_same_magic(local, proposed) is None


def test_threadnet_magic_mismatch_no_sync():
    """A node on a different network magic is handshake-refused and never
    exchanges blocks: its chain holds only its own forged blocks."""
    cfg = ThreadNetConfig(n_nodes=3, n_slots=25, k=20, f=0.5, seed=11,
                          network_magics=[0, 0, 9])
    res = run_threadnet(cfg)
    assert not res.failures, res.failures
    outsider = res.chains[2]
    assert all(b.header.issuer == 2 for b in outsider.blocks), \
        "outsider absorbed foreign blocks despite magic mismatch"
    # the two same-magic nodes still sync with each other
    a, b = res.chains[0], res.chains[1]
    isect = a.intersect(b)
    assert isect is not None and not isect.is_genesis


def test_threadnet_background_copy_to_immutable():
    """With small k, deep blocks migrate to the ImmutableDB while the net
    stays convergent (Background.hs copyAndSnapshotRunner)."""
    cfg = ThreadNetConfig(n_nodes=3, n_slots=40, k=3, f=0.5, seed=6)
    res = run_threadnet(cfg)
    assert not res.failures, res.failures
    assert res.common_prefix_ok(cfg.k)
    # chains got long enough that copying must have happened
    assert res.min_length() > cfg.k
    for c in res.chains:
        assert len(c) <= cfg.k             # fragment trimmed to k
        assert c.anchor_block_no >= 0      # anchor advanced past genesis


def test_future_block_buffered_until_its_slot():
    """A block from the future (clock skew beyond tolerance) is buffered,
    not adopted; at its slot it is re-triaged and adopted
    (cdbFutureBlocks + Fragment/InFuture.hs)."""
    from ouroboros_tpu_torch import simharness as sim
    from ouroboros_tpu_torch.testing.threadnet import (
        PraosNetworkFactory, ThreadNetConfig,
    )
    cfg = ThreadNetConfig(n_nodes=1, n_slots=30, k=5, f=1.0, seed=9)
    factory = PraosNetworkFactory(cfg)

    async def main():
        kern = factory.make_node(0)
        kern.start()
        await sim.sleep(3.1)              # a few slots of local forging
        tip = kern.chain_db.current_ledger
        # forge a block 10 slots in the future on the current tip
        future_slot = kern.btime.current.value + 10
        blk = factory.forge_at(0, future_slot, tip)
        res = kern.chain_db.add_block(blk)
        assert res.kind == "from_future", res.kind
        assert blk.hash in kern.chain_db.future_blocks
        assert kern.chain_db.volatile.block_info(blk.hash) is None
        # run until just before its slot: still buffered
        await sim.sleep(8.0)
        assert blk.hash in kern.chain_db.future_blocks
        # at/after its slot the tick loop re-triages it
        await sim.sleep(3.0)
        assert blk.hash not in kern.chain_db.future_blocks
        assert kern.chain_db.volatile.block_info(blk.hash) is not None
        kern.stop()
        return True

    assert sim.run(main(), seed=9)


def test_add_block_async_serialized_on_writer_thread():
    """add_block_async enqueues; the runner adopts in order."""
    from ouroboros_tpu_torch import simharness as sim
    from ouroboros_tpu_torch.testing.threadnet import (
        PraosNetworkFactory, ThreadNetConfig,
    )
    cfg = ThreadNetConfig(n_nodes=1, n_slots=30, k=5, f=1.0, seed=10)
    factory = PraosNetworkFactory(cfg)

    async def main():
        kern = factory.make_node(0)
        kern.btime.start(label="bt")
        runner = sim.spawn(kern.chain_db.add_block_runner(), label="runner")
        # forge 3 connected blocks by hand and enqueue them
        state = kern.chain_db.current_ledger
        blocks = factory.forge_chain_from(0, state, n=3)
        for b in blocks:
            kern.chain_db.add_block_async(b)
        await sim.sleep(1.0)
        assert kern.chain_db.tip_point().hash == blocks[-1].hash
        runner.cancel()
        return True

    assert sim.run(main(), seed=10)


class TestFetchBudgets:
    """Decision.hs:526 fetchRequestDecisions budgets: bytes, concurrency,
    DeltaQ request sizing."""

    def _tracker(self, g, s):
        from dataclasses import replace
        from ouroboros_tpu_torch.network.deltaq import PeerGSV, PeerGSVTracker
        t = PeerGSVTracker()
        t.gsv = PeerGSV(replace(t.gsv.outbound, g=g, s=0.0),
                        replace(t.gsv.inbound, g=g, s=s))
        return t

    def test_slow_peer_gets_small_requests_fast_peer_saturates(self):
        from ouroboros_tpu_torch.node.block_fetch import (
            FetchBudget, PeerFetchState, fetch_decisions,
        )
        hs = _header_chain(40)
        # two peers advertise the same long candidate
        frag = _frag(hs)
        states = {"fast": PeerFetchState("fast"),
                  "slow": PeerFetchState("slow")}
        trackers = {"fast": self._tracker(0.01, 1e-6),   # ~2ms per block
                    "slow": self._tracker(1.0, 1e-3)}    # ~2s per block
        budget = FetchBudget(max_blocks_per_request=16,
                             max_request_expected_secs=5.0,
                             max_concurrent_peers=4)
        reqs = fetch_decisions(
            {"fast": frag, "slow": frag}, states,
            lambda f: True, lambda h: False, budget=budget,
            order_key=lambda p: trackers[p].expected_fetch_time(16 * 2048),
            gsv=trackers.get)
        by_peer = {r.peer_id: r for r in reqs}
        # fast peer claims the first full-size run
        assert len(by_peer["fast"].headers) == 16
        # slow peer gets a DeltaQ-bounded (small) follow-on run
        assert len(by_peer["slow"].headers) <= 2
        # runs are disjoint
        fast_h = {h.hash for h in by_peer["fast"].headers}
        slow_h = {h.hash for h in by_peer["slow"].headers}
        assert not (fast_h & slow_h)

    def test_concurrency_budget_limits_peers(self):
        from ouroboros_tpu_torch.node.block_fetch import (
            FetchBudget, PeerFetchState, fetch_decisions,
        )
        hs = _header_chain(64)
        frag = _frag(hs)
        states = {f"p{i}": PeerFetchState(f"p{i}") for i in range(6)}
        budget = FetchBudget(max_blocks_per_request=4,
                             max_concurrent_peers=2)
        reqs = fetch_decisions({p: frag for p in states}, states,
                               lambda f: True, lambda h: False,
                               budget=budget)
        assert len(reqs) == 2

    def test_byte_budget_blocks_saturated_peer(self):
        from ouroboros_tpu_torch.node.block_fetch import (
            FetchBudget, PeerFetchState, fetch_decisions,
        )
        hs = _header_chain(8)
        frag = _frag(hs)
        ps = PeerFetchState("p")
        ps.in_flight_bytes = 300 * 1024      # over the 256 KiB cap
        ps.in_flight = set()                 # not "busy" — just saturated
        reqs = fetch_decisions({"p": frag}, {"p": ps},
                               lambda f: True, lambda h: False,
                               budget=FetchBudget())
        assert reqs == []

    def test_byte_budget_shrinks_request(self):
        from ouroboros_tpu_torch.node.block_fetch import (
            FetchBudget, PeerFetchState, fetch_decisions,
        )
        hs = _header_chain(32)
        frag = _frag(hs)
        ps = PeerFetchState("p")
        ps.avg_block_bytes = 2048
        budget = FetchBudget(max_blocks_per_request=16,
                             max_in_flight_bytes_per_peer=5 * 2048)
        reqs = fetch_decisions({"p": frag}, {"p": ps},
                               lambda f: True, lambda h: False,
                               budget=budget)
        assert len(reqs) == 1 and len(reqs[0].headers) == 5
        assert reqs[0].est_bytes == 5 * 2048


# -- tests/test_node_run.py ------------------------------------------------------

def _args(factory, fs, i=0, magic=0):
    from ouroboros_tpu_torch.consensus.ledger import ExtLedgerRules
    from ouroboros_tpu_torch.consensus.protocols.praos import (
        HotKey, Praos, praos_forge_fields,
    )
    from ouroboros_tpu_torch.crypto import kes as kes_mod
    from ouroboros_tpu_torch.ledgers.mock import MockLedger, Tx

    cfg = factory.cfg
    protocol = Praos(factory.protocol_cfg)
    ledger = MockLedger(factory.genesis)
    hot_key = HotKey(kes_mod.KesSignKey(cfg.kes_depth,
                                        factory.keys[i].kes_seed))
    forging = BlockForging(
        issuer=i, can_be_leader=(i, factory.keys[i].vrf_sk),
        forge=lambda protocol, proof, hdr, hk=hot_key:
            praos_forge_fields(protocol, hk, proof, hdr))
    return RunNodeArgs(
        fs=fs, ext_rules=ExtLedgerRules(protocol, ledger),
        encode_state=factory.enc_state, decode_state=factory.dec_state,
        block_decode=factory.block_decode,
        btime=BlockchainTime(cfg.slot_length), forgings=[forging],
        label=f"run{i}", network_magic=magic, backend=factory.backend,
        header_decode=factory.header_decode_obj,
        block_decode_obj=factory.block_decode_obj, tx_decode=Tx.decode,
        chunk_size=5)


def test_clean_shutdown_then_fast_reopen():
    cfg = ThreadNetConfig(n_nodes=1, n_slots=20, k=3, f=1.0, seed=31)
    factory = PraosNetworkFactory(cfg)
    fs = MockFS()

    async def main():
        h = run_node(_args(factory, fs))
        assert h.deep_validated          # first open: no marker yet
        await sim.sleep(10.0)
        bn = h.kernel.chain_db.current_chain.head_block_no
        assert bn >= 5
        h.stop()
        assert was_clean_shutdown(fs)
        # clean reopen: fast path (no chunk revalidation)
        h2 = run_node(_args(factory, fs))
        assert not h2.deep_validated
        assert h2.kernel.chain_db.current_chain.head_block_no >= bn
        h2.stop()
        return True

    assert sim.run(main(), seed=31)


def test_crash_triggers_deep_validation_and_truncates_corruption():
    cfg = ThreadNetConfig(n_nodes=1, n_slots=20, k=3, f=1.0, seed=32)
    factory = PraosNetworkFactory(cfg)
    fs = MockFS()

    async def main():
        h = run_node(_args(factory, fs))
        await sim.sleep(12.0)
        bn = h.kernel.chain_db.current_chain.head_block_no
        # CRASH: kill threads without writing the marker
        h.kernel.stop()
        assert not was_clean_shutdown(fs)
        # corrupt the immutable store mid-chunk (what a torn write leaves)
        chunk = ("immutable", "00000.chunk")
        raw = bytearray(fs.read_file(chunk))
        raw[len(raw) // 2] ^= 0xFF
        fs.write_file(chunk, bytes(raw))
        # reopen: crash => deep validation => corruption truncated, the
        # node still comes up on the valid prefix
        h2 = run_node(_args(factory, fs))
        assert h2.deep_validated
        assert h2.kernel.chain_db.current_chain.head_block_no <= bn
        h2.stop()
        return True

    assert sim.run(main(), seed=32)


def test_db_marker_rejects_wrong_network():
    cfg = ThreadNetConfig(n_nodes=1, n_slots=10, k=3, f=1.0, seed=33)
    factory = PraosNetworkFactory(cfg)
    fs = MockFS()

    async def main():
        h = run_node(_args(factory, fs, magic=7))
        h.stop()
        with pytest.raises(WrongNetworkError):
            run_node(_args(factory, fs, magic=8))
        return True

    assert sim.run(main(), seed=33)


# -- tests/test_review_fixes.py --------------------------------------------------

def test_mux_send_larger_than_egress_cap():
    """A payload bigger than the egress cap must be chunked, not deadlock."""
    big = bytes(range(256)) * 1030   # 263,680 bytes > 0xFFFF*4

    async def main():
        ba, bb = bearer_pair(sdu_size=4096)
        mux_a, mux_b = Mux(ba, "A"), Mux(bb, "B")
        cha = mux_a.channel(2, INITIATOR)
        chb = mux_b.channel(2, RESPONDER)
        mux_a.start()
        mux_b.start()

        async def sender():
            await cha.send(big)

        async def receiver():
            got = b""
            while len(got) < len(big):
                got += await chb.recv()
            return got

        s = sim.spawn(sender(), label="sender")
        r = sim.spawn(receiver(), label="receiver")
        await s.wait()
        return await r.wait()

    assert sim.run(main()) == big


def test_chainsync_block_added_during_await_reply():
    """A block added while the server sends MsgAwaitReply must not be lost
    (confirmed lost-wakeup: 44/200 schedules pre-fix)."""
    b0 = make_block(None, 0)
    b1 = make_block(b0, 1)

    async def scenario():
        ps = ChainProducerState()
        ps.add_block(b0)
        fid = ps.new_follower()

        ca, cb = channel_pair(label="cs")
        sess_c = typed.Session(chainsync.SPEC, typed.CLIENT, ca)
        sess_s = typed.Session(chainsync.SPEC, typed.SERVER, cb)

        srv = sim.spawn(
            chainsync.server_from_producer(sess_s, ps, fid,
                                           header_of=lambda b: b),
            label="server")

        async def client():
            # drain to tip (first instruction is rollback-to-intersection)
            await sess_c.send(chainsync.MsgRequestNext())
            msg = await sess_c.recv()
            assert isinstance(msg, chainsync.MsgRollBackward)
            await sess_c.send(chainsync.MsgRequestNext())
            msg = await sess_c.recv()
            assert isinstance(msg, chainsync.MsgRollForward)
            # now at tip: next request makes the server send MsgAwaitReply
            await sess_c.send(chainsync.MsgRequestNext())
            msg = await sess_c.recv()
            assert isinstance(msg, chainsync.MsgAwaitReply)
            # the eventual reply must be b1 — without waiting for a THIRD
            # block to bump the version again
            msg = await sess_c.recv()
            assert isinstance(msg, chainsync.MsgRollForward)
            assert msg.header.hash == b1.hash
            await sess_c.send(chainsync.MsgDone())

        cl = sim.spawn(client(), label="client")
        # add b1 exactly while the server is inside its MsgAwaitReply send
        await sim.sleep(0)
        ps.add_block(b1)
        ok, _ = await sim.timeout(5.0, cl.wait())
        assert ok, "client timed out: lost wakeup"
        await srv.wait()

    # exercise many schedules: the pre-fix bug was schedule-dependent
    for seed in range(30):
        sim.run(scenario(), seed=seed)


def test_pipelined_multi_message_reply():
    """MsgAwaitReply + MsgRollForward is ONE pipelined reply in two
    messages; collect() must keep consuming until client agency returns."""
    b0 = make_block(None, 0)
    b1 = make_block(b0, 1)

    async def scenario():
        ps = ChainProducerState()
        ps.add_block(b0)
        fid = ps.new_follower()
        ca, cb = channel_pair(label="cs")
        sess_c = typed.PipelinedSession(chainsync.SPEC, typed.CLIENT, ca)
        sess_s = typed.Session(chainsync.SPEC, typed.SERVER, cb)
        srv = sim.spawn(
            chainsync.server_from_producer(sess_s, ps, fid,
                                           header_of=lambda b: b),
            label="server")

        async def client():
            # pipeline two RequestNexts; the second reply starts with
            # MsgAwaitReply (server at tip) and continues with RollForward
            for _ in range(3):
                await sess_c.send_pipelined(chainsync.MsgRequestNext(),
                                            "StIdle")
            replies = []
            while sess_c.outstanding:
                replies.append(await sess_c.collect())
            kinds = [type(m).__name__ for m in replies]
            assert kinds == ["MsgRollBackward", "MsgRollForward",
                             "MsgAwaitReply", "MsgRollForward"], kinds
            assert replies[-1].header.hash == b1.hash
            await sess_c.send(chainsync.MsgDone())

        cl = sim.spawn(client(), label="client")
        await sim.sleep(1.0)
        ps.add_block(b1)
        ok, _ = await sim.timeout(10.0, cl.wait())
        assert ok
        await srv.wait()

    sim.run(scenario())


def test_fragment_subclass_preserved():
    b0 = make_block(None, 0)
    b1 = make_block(b0, 1)
    ch = Chain([b0, b1])
    rolled = ch.rollback(Point(b0.slot, b0.hash))
    assert isinstance(rolled, Chain)
    assert isinstance(ch.copy(), Chain)
    frag = AnchoredFragment.from_genesis()
    frag.add_block(b0)
    frag.add_block(b1)
    assert frag.truncate_to(Point(b0.slot, b0.hash))
    assert frag.head_point == Point(b0.slot, b0.hash)
    assert not frag.truncate_to(Point(99, b"\x01" * 32))


def test_cbor_truncated_type():
    raw = cbor.dumps([1, 2, b"abc"])
    with pytest.raises(cbor.CBORTruncated):
        cbor.loads(raw[:-2])
    # corrupt (not truncated) input raises plain CBORError
    with pytest.raises(cbor.CBORError):
        cbor.loads(raw + b"\x00")


# -- a bad peer and a caught-up follower, in both packages --------------------

_BAD_AT = 12                # the block whose KES signature is flipped
_CAUGHT_UP = 10             # blocks the server holds before the one it adds


def _jax_blocks() -> tuple:
    """_BAD_AT + 1 connected empty mock-Praos blocks (f = 1: node 0 leads every
    slot) forged by the JAX package's ThreadNet factory, as bytes, and
    block _BAD_AT's bytes with its KES signature flipped."""
    from ouroboros_tpu.consensus.ledger import ExtLedgerRules
    from ouroboros_tpu.consensus.protocols.praos import KES_FIELD, Praos
    from ouroboros_tpu.consensus.headers import ProtocolBlock
    from ouroboros_tpu.ledgers.mock import MockLedger
    from ouroboros_tpu.testing.threadnet import (
        PraosNetworkFactory as JFactory)
    fac = JFactory(_net_cfg("ouroboros_tpu"))
    st = ExtLedgerRules(Praos(fac.protocol_cfg),
                        MockLedger(fac.genesis)).initial_state()
    blocks = fac.forge_chain_from(0, st, _BAD_AT + 1)
    hdr = blocks[_BAD_AT].header
    sig = bytearray(hdr.get(KES_FIELD))
    sig[8] ^= 1
    bad = ProtocolBlock(hdr.with_fields(**{KES_FIELD: bytes(sig)}),
                        blocks[_BAD_AT].body)
    return [b.bytes for b in blocks], bad.bytes


def _net_cfg(pkg: str):
    tn = importlib.import_module(f"{pkg}.testing.threadnet")
    return tn.ThreadNetConfig(n_nodes=2, f=1.0, k=50, chain_sync_window=4)


def _node_pair(pkg: str, raws: list, backend=None, service=None,
               add: bytes = None) -> dict:
    """In package `pkg`: a server whose ImmutableDB holds the blocks
    `raws` (ChainDB.open replays them without crypto) and a fresh
    follower, both from the ThreadNet factory with their forging off,
    wired by connect_nodes once the clock stands a slot past the last
    block.  The follower validates on `backend` (the factory's
    OpensslBackend by default).  With `service` (a callable building a
    VerifyService over the follower's backend) the follower first syncs,
    then gets the service and the server adds block `add`.  Runs until
    the follower's connection ends or its tip is the server's; returns
    what both packages must agree on."""
    sim_ = importlib.import_module(f"{pkg}.simharness")
    tn = importlib.import_module(f"{pkg}.testing.threadnet")
    storage = importlib.import_module(f"{pkg}.storage")
    cs = importlib.import_module(f"{pkg}.node.chain_sync")
    batching = importlib.import_module(f"{pkg}.crypto.batching")
    node = importlib.import_module(f"{pkg}.node")
    fac = tn.PraosNetworkFactory(_net_cfg(pkg))
    blocks = [fac.block_decode(r) for r in raws]
    fs = storage.MockFS()
    imm = storage.ImmutableDB.open(fs, 100)
    for b in blocks:
        imm.append_block(b.slot, b.block_no, b.hash, b.prev_hash, b.bytes)
    flushes, coalesced, out = [], [], {}
    real_batched = cs.validate_headers_batched
    real_coalesced = batching.validate_headers_coalesced

    def batched(protocol, headers, *a, **kw):
        flushes.append(len(headers))
        return real_batched(protocol, headers, *a, **kw)

    async def coalesce(protocol, headers, *a, **kw):
        coalesced.append(len(headers))
        return await real_coalesced(protocol, headers, *a, **kw)

    async def main():
        last = add is not None and fac.block_decode(add) or blocks[-1]
        await sim_.sleep(last.slot + 1)
        server = fac.make_node(0, fs=fs, label="server")
        if backend is not None:
            fac.backend = backend
        follower = fac.make_node(1, label="follower")
        for k in (server, follower):
            k.forgings = []
            k.start()
        node.connect_nodes(follower, server, delay=0.05)

        def conn():
            return next(t for t in follower._threads
                        if t.label == "follower->server.connect-i")

        def synced():
            return follower.chain_db.tip_point() == \
                server.chain_db.tip_point()
        while not (conn().done or synced()):
            await sim_.sleep(0.05)
        if service is not None:
            svc = service(follower.backend)
            await svc.start()
            follower.verify_service = svc
            assert server.chain_db.add_block(
                fac.block_decode(add)).kind == "extended"
            while not synced():
                await sim_.sleep(0.05)
            await svc.stop()
            out["service_flushes"] = svc.stats["flushes"]
        await sim_.sleep(1.0)
        kill = None
        if conn().done:
            try:
                conn().poll()
            except cs.ChainSyncClientError as e:
                kill = str(e)
        out.update(kill=kill, tip=follower.chain_db.tip_point().encode(),
                   chain=[p.encode() for p in
                          follower.chain_db.current_chain.points()],
                   invalid=sorted(follower.chain_db.invalid))
        server.stop()
        follower.stop()

    cs.validate_headers_batched = batched
    batching.validate_headers_coalesced = coalesce
    try:
        sim_.run(main(), seed=3)
    finally:
        cs.validate_headers_batched = real_batched
        batching.validate_headers_coalesced = real_coalesced
    out.update(flushes=flushes, coalesced=coalesced)
    return out


def _backends():
    from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend
    return {"openssl": None, "torch-cpu": lambda: TorchBackend(device="cpu")}


@pytest.mark.parametrize("which", ["openssl", "torch-cpu"])
def test_peer_with_a_flipped_kes_signature_is_dropped_in_both_packages(
        which):
    raws, bad = _jax_blocks()
    served = raws[:_BAD_AT] + [bad]
    want = _node_pair("ouroboros_tpu", served)
    make = _backends()[which]
    got = _node_pair("ouroboros_tpu_torch", served,
                     backend=make() if make else None)
    assert want["kill"] is not None and "invalid header" in want["kill"]
    assert got == want
    assert len(got["chain"]) <= _BAD_AT


@pytest.mark.parametrize("which", ["openssl", "torch-cpu"])
def test_caught_up_flush_goes_through_the_verify_service(which):
    raws, _bad = _jax_blocks()

    def service(pkg):
        batching = importlib.import_module(f"{pkg}.crypto.batching")
        backend_mod = importlib.import_module(f"{pkg}.crypto.backend")
        return lambda be: batching.VerifyService(
            be, cpu_ref=backend_mod.CpuRefBackend())

    want = _node_pair("ouroboros_tpu", raws[:_CAUGHT_UP],
                      service=service("ouroboros_tpu"), add=raws[_CAUGHT_UP])
    make = _backends()[which]
    got = _node_pair("ouroboros_tpu_torch", raws[:_CAUGHT_UP],
                     backend=make() if make else None,
                     service=service("ouroboros_tpu_torch"),
                     add=raws[_CAUGHT_UP])
    assert got == want
    assert got["kill"] is None and got["coalesced"] == [1]
    assert got["service_flushes"] >= 1
    assert got["tip"][0] == _CAUGHT_UP          # the added block's slot


def test_a_tpraos_node_at_genesis_judges_a_candidate():
    """ROADMAP queue 3 item 6.  `NodeKernel.plausible_candidate` with an
    empty current fragment: the reference hands the fragment's bare
    block number to `prefer_candidate` as our select view, which TPraos
    (a `TPraosSelectView`) cannot compare, so a fresh Shelley node's
    fetch logic raises AttributeError and never fetches; the port judges
    an empty fragment by block number (longest chain first, as every
    protocol does).  Once the fragment holds a block both packages
    answer alike."""
    from ouroboros_tpu import storage as j_storage
    from ouroboros_tpu.chain.block import Point as JPoint
    from ouroboros_tpu.chain.fragment import AnchoredFragment as JFragment
    from ouroboros_tpu.consensus.headers import ProtocolBlock as JBlock
    from ouroboros_tpu.consensus.ledger import ExtLedgerRules as JRules
    from ouroboros_tpu.crypto.backend import CpuRefBackend as JCpuRef
    from ouroboros_tpu.eras import shelley as j_shelley
    from ouroboros_tpu.node import BlockchainTime as JTime
    from ouroboros_tpu.node import NodeKernel as JKernel
    from ouroboros_tpu.storage.chaindb import ChainDB as JChainDB
    from ouroboros_tpu.storage.stream import (pickle_decode as j_dec,
                                              pickle_encode as j_enc)
    from ouroboros_tpu_torch import chainsynth
    from ouroboros_tpu_torch.crypto.backend import CpuRefBackend
    from ouroboros_tpu_torch.node import NodeKernel

    ext, blocks, _st = chainsynth.forge_shelley(4, epoch_length=10,
                                                kes_depth=3)
    cfg = ext.protocol.config
    j_cfg = j_shelley.TPraosConfig(
        k=cfg.k, f=cfg.f, epoch_length=cfg.epoch_length,
        slots_per_kes_period=cfg.slots_per_kes_period,
        kes_depth=cfg.kes_depth, max_kes_evolutions=cfg.max_kes_evolutions)
    protocol, ledger, _pools = j_shelley.shelley_genesis_setup(
        2, j_cfg, stake_per_pool=100_000, seed=b"db-synth")
    j_ext = JRules(protocol, ledger)

    def j_decode(raw):
        return JBlock.from_bytes(raw, tx_decode=j_shelley.ShelleyTx.decode,
                                 tx_body_elems=6)

    j_blocks = [j_decode(b.bytes) for b in blocks]
    p_db = chainsynth.open_chaindb(MockFS(), ext, CpuRefBackend())
    j_db = JChainDB.open(j_storage.MockFS(), j_ext, j_enc, j_dec, j_decode,
                         backend=JCpuRef())
    p_kern = NodeKernel(p_db, ext.ledger, None, BlockchainTime(1.0))
    j_kern = JKernel(j_db, j_ext.ledger, None, JTime(1.0))
    p_frag = AnchoredFragment(Point.genesis(), (), anchor_block_no=-1)
    j_frag = JFragment(JPoint.genesis(), (), anchor_block_no=-1)
    for pb, jb in zip(blocks, j_blocks):
        p_frag.add_block(pb.header)
        j_frag.add_block(jb.header)
    assert p_kern.plausible_candidate(p_frag) is True
    with pytest.raises(AttributeError):
        j_kern.plausible_candidate(j_frag)
    # with a block adopted, the two agree
    assert p_db.add_block(blocks[0]).kind == "extended"
    assert j_db.add_block(j_blocks[0]).kind == "extended"
    assert p_kern.plausible_candidate(p_frag) == \
        j_kern.plausible_candidate(j_frag) is True
