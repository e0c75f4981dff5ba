"""The port's network layer (`ouroboros_tpu_torch.network`: channels, typed
sessions, the mux, DeltaQ, and the ChainSync, BlockFetch, TxSubmission,
KeepAlive and Handshake mini-protocols) and the node's TxSubmission loops:
the cases of tests/test_mux.py, tests/test_tx_submission.py and
tests/test_protocols.py (its node-to-node protocols) and
tests/test_golden_wire.py's pinned digests for the five protocols, run
against the port's copies; every message of each protocol, seeded with
numpy, encoded by both packages to the same bytes; and the keep-alive
watchdog under schedule exploration.

Reference: network-mux/test/Test/Mux.hs, the protocol-tests' codec and
Direct.hs properties, ouroboros-network/test-cddl.

Tolerance: none.  Bytes, verdicts and traces compare exactly.
"""
import hashlib
import importlib
from dataclasses import dataclass

import numpy as np
import pytest

from ouroboros_tpu_torch import simharness as sim
from ouroboros_tpu_torch.chain import (AnchoredFragment, Chain,
                                       ChainProducerState, Point, Tip,
                                       make_block, point_of)
from ouroboros_tpu_torch.network import typed
from ouroboros_tpu_torch.network.channel import channel_pair
from ouroboros_tpu_torch.network.mux import (
    INITIATOR, RESPONDER, SDU, CodecChannel, Mux, MuxError, QueueBearer,
    bearer_pair,
)
from ouroboros_tpu_torch.network.protocols import (
    blockfetch, chainsync, handshake, keepalive, txsubmission,
)
from ouroboros_tpu_torch.network.protocols.codec import roundtrip_property
from ouroboros_tpu_torch.network.protocols.txsubmission import (
    MsgDone, MsgReplyTxIds, MsgReplyTxs, MsgRequestTxIds, MsgRequestTxs,
)
from ouroboros_tpu_torch.network.typed import (CLIENT, SERVER, ProtocolError,
                                               run_peer)
from ouroboros_tpu_torch.node.tx_submission import (
    TxInboundPolicy, TxInboundProtocolError, tx_inbound_loop,
    tx_outbound_loop,
)
from ouroboros_tpu_torch.utils import cbor

# -- tests/test_mux.py ------------------------------------------------------

def test_sdu_header_roundtrip():
    sdu = SDU(timestamp=0xDEADBEEF, mode=RESPONDER, num=0x1234,
              payload=b"hello")
    raw = sdu.encode()
    assert len(raw) == 8 + 5
    ts, mode, num, ln = SDU.decode_header(raw)
    assert (ts, mode, num, ln) == (0xDEADBEEF, RESPONDER, 0x1234, 5)


def test_sdu_field_limits():
    with pytest.raises(MuxError):
        SDU(0, INITIATOR, 1 << 15, b"").encode()


def mk_chain(n):
    out, prev = [], None
    for i in range(n):
        # large bodies force multi-SDU messages with a small sdu_size
        prev = make_block(prev, i, body=[b"x" * 500])
        out.append(prev)
    return out


def test_two_protocols_over_one_bearer():
    """ChainSync + KeepAlive concurrently through one mux pair, with an
    SDU size small enough that headers split across SDUs."""
    blocks = mk_chain(10)

    async def main():
        ba, bb = bearer_pair(sdu_size=64)
        mux_a, mux_b = Mux(ba, "A"), Mux(bb, "B")

        # protocol numbers as NodeToNode.hs: chainsync=2, keepalive=8
        cs_a = CodecChannel(mux_a.channel(2, INITIATOR), chainsync.CODEC)
        cs_b = CodecChannel(mux_b.channel(2, RESPONDER), chainsync.CODEC)
        ka_a = CodecChannel(mux_a.channel(8, INITIATOR), keepalive.CODEC)
        ka_b = CodecChannel(mux_b.channel(8, RESPONDER), keepalive.CODEC)
        mux_a.start()
        mux_b.start()

        ps = ChainProducerState()
        for b in blocks:
            ps.add_block(b)
        fid = ps.new_follower()
        frag = AnchoredFragment.from_genesis()

        cs_client = sim.spawn(run_peer(
            chainsync.SPEC, CLIENT, cs_a,
            lambda s: chainsync.client_sync_to_tip(s, [Point.genesis()], frag)),
            label="cs-client")
        cs_server = sim.spawn(run_peer(
            chainsync.SPEC, SERVER, cs_b,
            lambda s: chainsync.server_from_producer(s, ps, fid)),
            label="cs-server")
        ka_client = sim.spawn(run_peer(
            keepalive.SPEC, CLIENT, ka_a,
            lambda s: keepalive.client_probe(s, rounds=3, interval=0.5)),
            label="ka-client")
        ka_server = sim.spawn(run_peer(
            keepalive.SPEC, SERVER, ka_b, keepalive.server),
            label="ka-server")

        await cs_client.wait()
        await cs_server.wait()
        rtts = await ka_client.wait()
        await ka_server.wait()
        mux_a.stop()
        mux_b.stop()
        return [h.hash for h in frag], rtts

    hashes, rtts = sim.run(main())
    assert hashes == [b.header.hash for b in mk_chain(10)]
    assert len(rtts) == 3


def test_ingress_overflow_raises():
    async def main():
        ba, bb = bearer_pair(sdu_size=4096)
        mux_a, mux_b = Mux(ba, "A"), Mux(bb, "B")
        ch_a = mux_a.channel(2, INITIATOR)
        ch_b = mux_b.channel(2, RESPONDER)
        ch_b.ingress_limit = 100     # tiny limit; nobody drains
        mux_a.start()
        mux_b.start()
        for _ in range(10):
            await ch_a.send(b"y" * 64)
        # let the demuxer hit the limit
        await sim.sleep(1.0)
        try:
            mux_b._jobs[1].poll()
        except MuxError as e:
            return str(e)
        return None

    err = sim.run(main())
    assert err is not None and "overflow" in err


def test_egress_round_robin_fairness():
    """Two bulk senders share the bearer: SDUs interleave per cycle
    (Egress.hs:77-105 single-writer fairness) — neither protocol starves
    the other."""
    order = []

    class SpyBearer(QueueBearer):
        async def write(self, sdu):
            order.append(sdu.num)
            await super().write(sdu)

    async def main():
        from ouroboros_tpu_torch.simharness import TBQueue
        a2b = TBQueue(512, label="a2b")
        b2a = TBQueue(512, label="b2a")
        ba = SpyBearer(a2b, b2a, sdu_size=1024)
        bb = QueueBearer(b2a, a2b, sdu_size=1024)
        mux_a, mux_b = Mux(ba, "A"), Mux(bb, "B")
        ch2 = mux_a.channel(2, INITIATOR)
        ch3 = mux_a.channel(3, INITIATOR)
        mux_b.channel(2, RESPONDER)
        mux_b.channel(3, RESPONDER)
        mux_a.start()
        mux_b.start()
        payload = b"\xab" * (1024 * 8)

        s1 = sim.spawn(ch2.send(payload), label="s2")
        s2 = sim.spawn(ch3.send(payload), label="s3")
        await s1.wait()
        await s2.wait()
        await sim.sleep(1.0)
        return True

    assert sim.run(main())
    # both protocols sent 8 SDUs; in any window of consecutive SDUs after
    # both started, neither gets more than one SDU ahead per cycle
    assert order.count(2) == 8 and order.count(3) == 8
    # strict alternation once both are active
    both = [n for n in order]
    first3 = both.index(3)
    tail = both[max(first3 - 1, 0):]
    assert len(tail) >= 8
    for i in range(len(tail) - 1):
        assert tail[i] != tail[i + 1], f"unfair egress: {order}"


def test_owd_estimator_updates_gsv_without_keepalive():
    """SDU timestamps feed the receiver's GSV (TraceStats.hs): after plain
    data transfer over a delayed bearer, G reflects the one-way delay with
    no KeepAlive probes."""
    from ouroboros_tpu_torch.network.deltaq import PeerGSVTracker

    tracker = PeerGSVTracker()

    async def main():
        ba, bb = bearer_pair(sdu_size=1024, delay=0.05)
        mux_a = Mux(ba, "A")
        mux_b = Mux(bb, "B", owd_observer=tracker.observe_owd)
        cha = mux_a.channel(2, INITIATOR)
        chb = mux_b.channel(2, RESPONDER)
        mux_a.start()
        mux_b.start()
        await cha.send(b"\x01" * 4000)
        got = b""
        while len(got) < 4000:
            got += await chb.recv()
        return True

    assert sim.run(main())
    g = tracker.gsv.inbound.g
    assert 0.04 <= g <= 0.06, f"G not learned from SDU timestamps: {g}"


# -- tests/test_tx_submission.py ---------------------------------------------

@dataclass(frozen=True)
class StubTx:
    txid: bytes

    def encode(self):
        return self.txid


class StubMempool:
    """Just enough mempool for the inbound loop: id set + add sink."""

    def __init__(self, have=()):
        self.ids = set(have)
        self.added = []

    def get_snapshot(self):
        outer = self

        class Snap:
            tx_ids = list(outer.ids)
        return Snap()

    def try_add_txs(self, txs):
        for t in txs:
            self.ids.add(t.txid)
            self.added.append(t.txid)
        return list(txs), []


def _decode(obj):
    return StubTx(bytes(obj))


def _raw(txid: bytes) -> bytes:
    return cbor.dumps(txid)


def _run_inbound_vs(peer, mempool=None, policy=None):
    mp = mempool if mempool is not None else StubMempool()

    async def main():
        async def inbound(s):
            return await tx_inbound_loop(s, mp, _decode, policy=policy)

        return await typed.connect(txsubmission.SPEC, peer, inbound)

    return sim.run(main()), mp


def test_inbound_honest_flow_fetches_and_acks():
    ids = [b"tx%02d" % i for i in range(17)]
    acked = []

    async def peer(s):
        queue = list(ids)
        unacked: list = []
        while True:
            msg = await s.recv()
            if isinstance(msg, MsgRequestTxIds):
                acked.append(msg.ack)
                del unacked[:msg.ack]
                if not queue and msg.blocking:
                    await s.send(MsgDone())
                    return len(unacked)
                new = queue[:msg.req]
                del queue[:msg.req]
                unacked.extend(new)
                # memory-bound assertion: the inbound never lets our
                # unacked queue exceed its max_unacked policy
                assert len(unacked) <= TxInboundPolicy().max_unacked
                await s.send(MsgReplyTxIds(
                    tuple((i, len(i)) for i in new)))
            elif isinstance(msg, MsgRequestTxs):
                await s.send(MsgReplyTxs(
                    tuple(_raw(i) for i in msg.ids)))

    (peer_res, _inb_res), mp = _run_inbound_vs(peer)
    assert sorted(mp.added) == sorted(ids)
    assert peer_res == 0                    # everything acked in the end
    assert sum(acked) == len(ids)


def test_inbound_dedups_known_ids_without_fetching():
    known = [b"known-%d" % i for i in range(4)]
    fresh = [b"fresh-%d" % i for i in range(4)]
    fetched = []

    async def peer(s):
        queue = known + fresh
        while True:
            msg = await s.recv()
            if isinstance(msg, MsgRequestTxIds):
                if not queue and msg.blocking:
                    await s.send(MsgDone())
                    return
                new = queue[:msg.req]
                del queue[:msg.req]
                await s.send(MsgReplyTxIds(
                    tuple((i, len(i)) for i in new)))
            elif isinstance(msg, MsgRequestTxs):
                fetched.extend(msg.ids)
                await s.send(MsgReplyTxs(
                    tuple(_raw(i) for i in msg.ids)))

    _res, mp = _run_inbound_vs(peer, mempool=StubMempool(have=known))
    assert sorted(mp.added) == sorted(fresh)
    assert sorted(fetched) == sorted(fresh)   # known ids never fetched


def test_inbound_over_announce_disconnects():
    async def peer(s):
        msg = await s.recv()
        assert isinstance(msg, MsgRequestTxIds)
        flood = tuple((b"id%04d" % i, 4) for i in range(msg.req + 50))
        await s.send(MsgReplyTxIds(flood))
        return "flooded"

    with pytest.raises(TxInboundProtocolError):
        _run_inbound_vs(peer)


def test_inbound_reannounce_unacked_disconnects():
    async def peer(s):
        msg = await s.recv()
        assert msg.req >= 2, "default policy window must allow 2 ids"
        await s.send(MsgReplyTxIds(((b"dup", 4), (b"dup", 4))))
        return "poisoned"

    with pytest.raises(TxInboundProtocolError):
        _run_inbound_vs(peer)


def test_inbound_unrequested_body_disconnects():
    async def peer(s):
        msg = await s.recv()
        assert isinstance(msg, MsgRequestTxIds)
        await s.send(MsgReplyTxIds(((b"legit", 5),)))
        msg = await s.recv()
        assert isinstance(msg, MsgRequestTxs)
        await s.send(MsgReplyTxs((_raw(b"evil!"),)))
        return "poisoned"

    with pytest.raises(TxInboundProtocolError):
        _run_inbound_vs(peer)


def test_inbound_oversize_advertisement_disconnects():
    async def peer(s):
        msg = await s.recv()
        await s.send(MsgReplyTxIds(((b"big", 10**9),)))

    with pytest.raises(TxInboundProtocolError):
        _run_inbound_vs(peer)


def test_inbound_respects_body_budget():
    """Bodies are requested in budgeted batches, never more than
    max_txs_per_req at a time."""
    policy = TxInboundPolicy(max_txs_per_req=2)
    batches = []

    async def peer(s):
        queue = [b"b%02d" % i for i in range(9)]
        while True:
            msg = await s.recv()
            if isinstance(msg, MsgRequestTxIds):
                if not queue and msg.blocking:
                    await s.send(MsgDone())
                    return
                new = queue[:msg.req]
                del queue[:msg.req]
                await s.send(MsgReplyTxIds(
                    tuple((i, len(i)) for i in new)))
            else:
                batches.append(len(msg.ids))
                await s.send(MsgReplyTxs(
                    tuple(_raw(i) for i in msg.ids)))

    _res, mp = _run_inbound_vs(peer, policy=policy)
    assert len(mp.added) == 9
    assert batches and max(batches) <= 2


def test_outbound_bad_ack_disconnects():
    """The outbound side rejects acks covering ids it never sent."""
    class Reader:
        def next_ids(self, n):
            return []

        def lookup(self, txid):
            return None

    class MP:
        version = None

        def reader(self):
            return Reader()

    async def evil_inbound(s):
        await s.send(MsgRequestTxIds(False, 5, 3))   # ack 5 ids of 0 sent
        return "poisoned"

    async def main():
        async def outbound(s):
            return await tx_outbound_loop(s, MP())

        return await typed.connect(txsubmission.SPEC, outbound,
                                   evil_inbound)

    with pytest.raises(TxInboundProtocolError):
        sim.run(main())


# -- tests/test_protocols.py (the node-to-node protocols) --------------------


def mk_blocks(n, seed=b""):
    out, prev = [], None
    for i in range(n):
        prev = make_block(prev, i * 2 + 1, body=[seed + b"tx%d" % i])
        out.append(prev)
    return out


def test_codec_roundtrips_all_protocols():
    blocks = mk_blocks(2)
    tip = Tip(point_of(blocks[-1]), blocks[-1].block_no)
    p = point_of(blocks[0])
    cases = [
        (chainsync.CODEC, [
            chainsync.MsgRequestNext(), chainsync.MsgAwaitReply(),
            chainsync.MsgRollForward(blocks[0].header, tip),
            chainsync.MsgRollBackward(p, tip),
            chainsync.MsgFindIntersect((p, Point.genesis())),
            chainsync.MsgIntersectFound(p, tip),
            chainsync.MsgIntersectNotFound(tip), chainsync.MsgDone()]),
        (blockfetch.CODEC, [
            blockfetch.MsgRequestRange(p, point_of(blocks[1])),
            blockfetch.MsgClientDone(), blockfetch.MsgStartBatch(),
            blockfetch.MsgNoBlocks(), blockfetch.MsgBlock(blocks[0]),
            blockfetch.MsgBatchDone()]),
        (txsubmission.CODEC, [
            txsubmission.MsgRequestTxIds(True, 3, 5),
            txsubmission.MsgReplyTxIds(((b"id1", 100), (b"id2", 200))),
            txsubmission.MsgRequestTxs((b"id1",)),
            txsubmission.MsgReplyTxs((b"txbytes",)),
            txsubmission.MsgDone()]),
        (keepalive.CODEC, [
            keepalive.MsgKeepAlive(77), keepalive.MsgKeepAliveResponse(77),
            keepalive.MsgDone()]),
        (handshake.CODEC, [
            handshake.MsgProposeVersions(((7, {"net": 42}), (8, None))),
            handshake.MsgAcceptVersion(8, {"net": 42}),
            handshake.MsgRefuse(handshake.RefuseRefused(8, "nope"))]),
    ]
    for codec, msgs in cases:
        assert roundtrip_property(codec, msgs)


def test_chainsync_direct_sync():
    blocks = mk_blocks(12)

    async def main():
        ps = ChainProducerState()
        for b in blocks:
            ps.add_block(b)
        fid = ps.new_follower()
        frag = AnchoredFragment.from_genesis()

        async def client(s):
            return await chainsync.client_sync_to_tip(
                s, [Point.genesis()], frag)

        async def server(s):
            return await chainsync.server_from_producer(s, ps, fid)

        return await typed.connect(chainsync.SPEC, client, server)

    sim.run(main())
    # client fragment should now hold all headers


def test_chainsync_client_follows_headers():
    blocks = mk_blocks(12)

    async def main():
        ps = ChainProducerState()
        for b in blocks:
            ps.add_block(b)
        fid = ps.new_follower()
        frag = AnchoredFragment.from_genesis()

        async def client(s):
            return await chainsync.client_sync_to_tip(
                s, [Point.genesis()], frag)

        await typed.connect(chainsync.SPEC, client,
                            lambda s: chainsync.server_from_producer(s, ps, fid))
        return [h.hash for h in frag]

    got = sim.run(main())
    assert got == [b.header.hash for b in blocks]


def test_blockfetch_direct():
    blocks = mk_blocks(8)
    index = {b.hash: i for i, b in enumerate(blocks)}

    def lookup_range(start, end):
        i, j = index.get(start.hash), index.get(end.hash)
        if i is None or j is None or j < i:
            return None
        return blocks[i:j + 1]

    async def main():
        async def client(s):
            got = await blockfetch.fetch_range(
                s, point_of(blocks[2]), point_of(blocks[5]))
            missing = await blockfetch.fetch_range(
                s, Point(999, b"\x42" * 32), point_of(blocks[5]))
            await s.send(blockfetch.MsgClientDone())
            return got, missing

        return (await typed.connect(
            blockfetch.SPEC, client,
            lambda s: blockfetch.server_from_blocks(s, lookup_range)))[0]

    got, missing = sim.run(main())
    assert got == blocks[2:6]
    assert missing is None


def test_txsubmission_relay():
    class Reader:
        def __init__(self, txs):
            self.txs = list(txs)          # [(id, bytes)]
            self.cursor = 0

        def next_ids(self, n):
            out = [(i, len(t)) for i, t in
                   self.txs[self.cursor:self.cursor + n]]
            self.cursor += len(out)
            return out

        def lookup(self, txid):
            return dict(self.txs).get(txid)

    txs = [(b"id%d" % i, b"tx-payload-%d" % i) for i in range(25)]
    got = {}

    async def main():
        reader = Reader(txs)

        async def outbound(s):   # CLIENT role (the mempool holder)
            return await txsubmission.outbound_from_mempool(s, reader)

        async def inbound(s):    # SERVER role (the requester)
            return await txsubmission.inbound_collect(
                s, lambda t: got.__setitem__(t.split(b"-")[-1], t), window=7)

        return await typed.connect(txsubmission.SPEC, outbound, inbound)

    sim.run(main())
    assert sorted(got.values()) == sorted(t for _, t in txs)


def test_keepalive_rtt_measured():
    async def main():
        async def client(s):
            return await keepalive.client_probe(s, rounds=5, interval=1.0)

        (rtts, _) = await typed.connect(keepalive.SPEC, client,
                                        keepalive.server, delay=0.25)
        return rtts

    rtts = sim.run(main())
    assert len(rtts) == 5
    assert all(abs(r - 0.5) < 1e-9 for r in rtts)   # 2 x 0.25s channel delay


def test_handshake_negotiation():
    async def main():
        client_vs = handshake.Versions().add(6, {"m": 1}).add(7, {"m": 1})
        server_vs = handshake.Versions().add(5, {"m": 1}).add(7, {"m": 1}) \
                                        .add(9, {"m": 1})
        return await typed.connect(
            handshake.SPEC,
            lambda s: handshake.client_propose(s, client_vs),
            lambda s: handshake.server_accept(s, server_vs))

    cres, sres = sim.run(main())
    assert cres[0] == "accepted" and cres[1] == 7
    assert sres[0] == "accepted" and sres[1] == 7


def test_handshake_no_common_version():
    async def main():
        return await typed.connect(
            handshake.SPEC,
            lambda s: handshake.client_propose(
                s, handshake.Versions().add(1, None)),
            lambda s: handshake.server_accept(
                s, handshake.Versions().add(2, None)))

    cres, sres = sim.run(main())
    assert cres == ("refused", handshake.RefuseVersionMismatch((2,)))




def test_agency_violation_detected():
    async def main():
        ca, cb = channel_pair(label="bad")

        async def bad_client(s):
            # server-only message sent by client
            await s.send(chainsync.MsgRollForward(
                mk_blocks(1)[0].header, Tip.genesis()))

        h = sim.spawn(run_peer(chainsync.SPEC, CLIENT, ca, bad_client))
        try:
            await h.wait()
        except ProtocolError as e:
            return str(e)
        return None

    err = sim.run(main())
    assert err is not None and "not allowed" in err


def test_pipelined_chainsync_requests():
    """Pipelined client: issue several MsgRequestNext before collecting."""
    blocks = mk_blocks(6)

    async def main():
        ps = ChainProducerState()
        for b in blocks:
            ps.add_block(b)
        fid = ps.new_follower()
        ca, cb = channel_pair(label="pcs")

        async def client(s):
            # consume initial rollback instruction via pipeline too
            for _ in range(4):
                await s.send_pipelined(chainsync.MsgRequestNext(),
                                       reply_state="StIdle")
            got = []
            for _ in range(4):
                got.append(await s.collect())
            await s.send(chainsync.MsgDone())
            return got

        ch = sim.spawn(run_peer(chainsync.SPEC, CLIENT, ca, client,
                                pipelined=True))
        sh = sim.spawn(run_peer(
            chainsync.SPEC, SERVER, cb,
            lambda s: chainsync.server_from_producer(s, ps, fid)))
        got = await ch.wait()
        await sh.wait()
        return got

    got = sim.run(main())
    assert isinstance(got[0], chainsync.MsgRollBackward)
    assert [m.header.hash for m in got[1:]] == \
        [b.header.hash for b in blocks[:3]]


# -- tests/test_golden_wire.py (the five ported protocols) -------------------

def _h(tag: bytes) -> bytes:
    return hashlib.blake2b(tag, digest_size=32).digest()


def _golden_corpus(pkg: str) -> dict:
    """tests/test_golden_wire.py's sample messages for the node-to-node
    protocols, built from package `pkg`'s classes."""
    m = {n: importlib.import_module(f"{pkg}.network.protocols.{n}")
         for n in _PROTOCOLS}
    blk = importlib.import_module(f"{pkg}.chain.block")
    hd = importlib.import_module(f"{pkg}.consensus.headers")
    cs, bf, txs, ka, hs = (m[n] for n in _PROTOCOLS)
    p1 = blk.Point(slot=7, hash=_h(b"p1"))
    p2 = blk.Point(slot=9, hash=_h(b"p2"))
    tip = blk.Tip(p2, 4)
    hdr = hd.make_header(None, 7, (), issuer=1).with_fields(demo=b"\x01\x02")
    return {
        "chainsync": [
            cs.MsgRequestNext(), cs.MsgAwaitReply(),
            cs.MsgRollForward(hdr, tip), cs.MsgRollBackward(p1, tip),
            cs.MsgFindIntersect((p1, p2)), cs.MsgIntersectFound(p1, tip),
            cs.MsgIntersectNotFound(tip), cs.MsgDone()],
        "blockfetch": [
            bf.MsgRequestRange(p1, p2), bf.MsgClientDone(),
            bf.MsgStartBatch(), bf.MsgNoBlocks(),
            bf.MsgBlock(hd.ProtocolBlock(
                hd.make_header(None, 1, (), issuer=0), ())),
            bf.MsgBatchDone()],
        "txsubmission": [
            txs.MsgRequestTxIds(True, 2, 5),
            txs.MsgReplyTxIds(((_h(b"tx1"), 123), (_h(b"tx2"), 456))),
            txs.MsgRequestTxs((_h(b"tx1"),)),
            txs.MsgReplyTxs((b"\x01\x02\x03",)), txs.MsgDone()],
        "keepalive": [
            ka.MsgKeepAlive(0xBEEF), ka.MsgKeepAliveResponse(0xBEEF),
            ka.MsgDone()],
        "handshake": [
            hs.MsgProposeVersions(((7, b"\x0a"), (8, b"\x0b"))),
            hs.MsgAcceptVersion(8, b"\x0b"),
            hs.MsgRefuse(hs.RefuseVersionMismatch((7, 8)))],
    }


_PROTOCOLS = ("chainsync", "blockfetch", "txsubmission", "keepalive",
              "handshake")
# tests/test_golden_wire.py's pinned digests of these five corpora
_GOLDEN = {
    "chainsync": "b0cf10f03c1f43635c0ed2d8d0510768a132ba1ac40d237de0fa6dc0ec354d14",
    "blockfetch": "370c4a8249dada8f4e1a6877c508b2761ca5fe5fe3c127632f7667417007eb30",
    "txsubmission": "2f2649fb830cdd6d607d0b97fdec021456fd314d21091b953481ef610da7d9ad",
    "keepalive": "07785ca61706e8b8978e443757c8932e5c157b8452480f3c4fbdf18ae98e4240",
    "handshake": "12b0b8b28748f681b43bcb1b1c47edc37317903e9abf5f8aadb7dec888cfe8aa",
}


def _codec(name: str):
    return {"chainsync": chainsync, "blockfetch": blockfetch,
            "txsubmission": txsubmission, "keepalive": keepalive,
            "handshake": handshake}[name].CODEC


def test_small_messages_exact_bytes():
    assert chainsync.CODEC.encode(chainsync.MsgRequestNext()).hex() == "8100"
    assert keepalive.CODEC.encode(
        keepalive.MsgKeepAlive(0xBEEF)).hex() == "820019beef"
    assert txsubmission.CODEC.encode(
        txsubmission.MsgRequestTxIds(True, 2, 5)).hex() == "8400f50205"


@pytest.mark.parametrize("name", _PROTOCOLS)
def test_corpus_digest_pinned(name):
    msgs = _golden_corpus("ouroboros_tpu_torch")[name]
    blob = b"".join(_codec(name).encode(m) for m in msgs)
    assert hashlib.sha256(blob).hexdigest() == _GOLDEN[name]


# -- the same bytes in both packages ------------------------------------------

def _seeded_corpus(pkg: str, seed: int) -> dict:
    """Messages of every ported protocol with fields drawn from one numpy
    generator, built from package `pkg`'s classes: the same seed gives
    the same field values in both packages."""
    rng = np.random.default_rng(seed)
    m = {n: importlib.import_module(f"{pkg}.network.protocols.{n}")
         for n in _PROTOCOLS}
    blk = importlib.import_module(f"{pkg}.chain.block")
    hd = importlib.import_module(f"{pkg}.consensus.headers")
    cs, bf, txs, ka, hs = (m[n] for n in _PROTOCOLS)

    def h32():
        return rng.integers(0, 256, 32, dtype=np.uint8).tobytes()

    def num(hi=2 ** 32):
        return int(rng.integers(0, hi))

    def point():
        return blk.Point(slot=num(), hash=h32())

    def tip():
        return blk.Tip(point(), num())

    prev = None
    blocks = []
    for i in range(3):
        body = tuple(rng.integers(0, 256, num(40), dtype=np.uint8).tobytes()
                     for _ in range(num(3)))
        hdr = hd.make_header(prev, num(), body, issuer=num(8)) \
            .with_fields(vrf=h32(), sig=h32() + h32())
        blocks.append(hd.ProtocolBlock(hdr, body))
        prev = hdr
    ids = [(h32(), num(65536)) for _ in range(num(6) + 1)]
    versions = tuple((v, {"magic": num()}) for v in sorted(
        {int(x) for x in rng.integers(1, 20, 4)}))
    return {
        "chainsync": [
            cs.MsgRequestNext(), cs.MsgAwaitReply(),
            *(cs.MsgRollForward(b.header, tip()) for b in blocks),
            cs.MsgRollBackward(point(), tip()),
            cs.MsgFindIntersect(tuple(point() for _ in range(num(5) + 1))
                                + (blk.Point.genesis(),)),
            cs.MsgIntersectFound(point(), tip()),
            cs.MsgIntersectNotFound(tip()), cs.MsgDone()],
        "blockfetch": [
            bf.MsgRequestRange(point(), point()), bf.MsgClientDone(),
            bf.MsgStartBatch(), bf.MsgNoBlocks(),
            *(bf.MsgBlock(b) for b in blocks), bf.MsgBatchDone()],
        "txsubmission": [
            txs.MsgRequestTxIds(bool(num(2)), num(10), num(10) + 1),
            txs.MsgReplyTxIds(tuple(ids)),
            txs.MsgRequestTxs(tuple(i for i, _ in ids)),
            txs.MsgReplyTxs(tuple(h32() for _ in ids)), txs.MsgDone()],
        "keepalive": [
            ka.MsgKeepAlive(num(65536)), ka.MsgKeepAliveResponse(num(65536)),
            ka.MsgDone()],
        "handshake": [
            hs.MsgProposeVersions(versions),
            hs.MsgAcceptVersion(versions[-1][0], versions[-1][1]),
            hs.MsgRefuse(hs.RefuseVersionMismatch(
                tuple(v for v, _p in versions))),
            hs.MsgRefuse(hs.RefuseRefused(versions[0][0], "refused")),
            hs.MsgRefuse(hs.RefuseHandshakeDecodeError(versions[0][0],
                                                       "bad params"))],
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", _PROTOCOLS)
def test_messages_encode_to_the_jax_packages_bytes(name, seed):
    port = _seeded_corpus("ouroboros_tpu_torch", seed)[name]
    ref = _seeded_corpus("ouroboros_tpu", seed)[name]
    ref_codec = importlib.import_module(
        f"ouroboros_tpu.network.protocols.{name}").CODEC
    got = [_codec(name).encode(m) for m in port]
    want = [ref_codec.encode(m) for m in ref]
    assert got == want
    # and the JAX package's bytes decode in the port to the same messages
    # (through the node's codecs: headers and blocks keep every field)
    from ouroboros_tpu_torch.consensus.headers import (ProtocolBlock,
                                                       ProtocolHeader)
    codec = {"chainsync": lambda: chainsync.make_codec(ProtocolHeader.decode),
             "blockfetch": lambda: blockfetch.make_codec(ProtocolBlock.decode),
             }.get(name, lambda: _codec(name))()
    assert [codec.encode(codec.decode(b)) for b in want] == want


# -- tests/test_races.py: the keep-alive watchdog under exploration ----------

def test_keepalive_watchdog_sim_exploration_race_clean():
    """The keepalive-stall kill path under perturbed schedules: the
    timeout fires on every schedule and the mux teardown exposes no
    race."""
    from ouroboros_tpu_torch.node.watchdog import KeepAliveTimeout
    from ouroboros_tpu_torch.simharness import FaultPlan, FaultSpec
    from ouroboros_tpu_torch.testing.threadnet import CHAOS_RACE_TOLERATED

    def make():
        plan = FaultPlan(seed=5, spec=FaultSpec(drop_prob=1.0))

        async def main():
            ba, bb = bearer_pair(sdu_size=1024)
            bb = plan.wrap_bearer(bb, "srv", "cli")
            mux_a, mux_b = Mux(ba, "cli"), Mux(bb, "srv")
            ka_a = CodecChannel(mux_a.channel(8, INITIATOR), keepalive.CODEC)
            ka_b = CodecChannel(mux_b.channel(8, RESPONDER), keepalive.CODEC)
            mux_a.start()
            mux_b.start()
            server = sim.spawn(run_peer(
                keepalive.SPEC, SERVER, ka_b, keepalive.server),
                label="ka-server")
            sess = typed.Session(keepalive.SPEC, CLIENT, ka_a)
            client = sim.spawn(
                keepalive.client_probe(sess, rounds=None, interval=0.5,
                                       response_timeout=2.0),
                label="ka-client")
            try:
                await client.wait()
            except KeepAliveTimeout:
                pass
            else:
                raise AssertionError("stalled responder did not trip "
                                     "the keep-alive watchdog")
            mux_a.stop()
            mux_b.stop()
            server.cancel()
            await sim.yield_()
        return main()

    rep = sim.explore_races(make, k=4, seed=5,
                            tolerate=tuple(CHAOS_RACE_TOLERATED))
    assert rep.failures == [], rep.render()
    assert rep.races == [], rep.render()
