"""The port's remaining mini-protocols (`ouroboros_tpu_torch.network.
protocols.{hello,txsubmission2,tipsample,localtxmonitor,examples}`) and
its protocol instantiations: the cases of tests/test_protocols_extra.py,
tests/test_protocol_examples.py and tests/test_protocol_instances.py
(its codec sweep over the specs the port's analyser discovers), run
against the port's copies; tests/test_golden_wire.py's pinned digests
that the other port tests do not pin (TxSubmission2, LocalTxMonitor,
TipSample and the per-era transaction and block encodings); every message of the five
protocols with numpy-seeded fields, encoded by both packages to the same
bytes and decoded back; and a seeded TxSubmission2 relay and TipSample
run in both packages' simulators with the same results and end times.

Reference: Protocol/{TipSample,LocalTxMonitor,Trans/Hello,TxSubmission2},
typed-protocols-examples, ouroboros-consensus's BFT/PBFT/Praos tests.

Tolerance: none.  Bytes, results and virtual times compare exactly.
"""
import hashlib
import importlib

import numpy as np
import pytest

from ouroboros_tpu_torch import simharness as sim
from ouroboros_tpu_torch.chain import Point, Tip, make_block, point_of
from ouroboros_tpu_torch.consensus import (
    HeaderError, HeaderState, validate_header, validate_headers_batched,
)
from ouroboros_tpu_torch.consensus.headers import make_header
from ouroboros_tpu_torch.consensus.protocols import (
    Bft, HotKey, PBft, Praos, PraosConfig, PraosNode, bft_sign_header,
    pbft_sign_header, praos_forge_fields,
)
from ouroboros_tpu_torch.crypto import ed25519_ref, kes as kes_mod
from ouroboros_tpu_torch.crypto.backend import OpensslBackend
from ouroboros_tpu_torch.network import typed
from ouroboros_tpu_torch.network.channel import channel_pair
from ouroboros_tpu_torch.network.protocols import (
    examples as ex, localtxmonitor, tipsample, txsubmission2,
)
from ouroboros_tpu_torch.network.protocols.codec import roundtrip_property
from ouroboros_tpu_torch.network.typed import (CLIENT, SERVER, ProtocolError,
                                               run_peer)


# -- tests/test_protocols_extra.py -------------------------------------------

def mk_tips(n):
    out, prev = [], None
    for i in range(n):
        prev = make_block(prev, i * 2 + 1, body=[b"tx%d" % i])
        out.append(Tip(point_of(prev), prev.block_no))
    return out


def test_tipsample_codec_roundtrip():
    t = mk_tips(1)[0]
    assert roundtrip_property(tipsample.CODEC, [
        tipsample.MsgFollowTip(3, 17), tipsample.MsgNextTip(t),
        tipsample.MsgNextTipDone(t), tipsample.MsgDone()])


def test_localtxmonitor_codec_roundtrip():
    assert roundtrip_property(localtxmonitor.CODEC, [
        localtxmonitor.MsgRequestTx(), localtxmonitor.MsgReplyTx(b"tx"),
        localtxmonitor.MsgDone()])


def test_txsubmission2_codec_has_hello():
    assert roundtrip_property(txsubmission2.CODEC, [
        txsubmission2.MsgHello(),
        txsubmission2.MsgRequestTxIds(False, 0, 4)])
    # hello tag is 6 on the wire (TxSubmission2/Codec.hs:62-63)
    raw = txsubmission2.CODEC.encode(txsubmission2.MsgHello())
    assert txsubmission2.CODEC.decode(raw) == txsubmission2.MsgHello()
    assert txsubmission2.MsgHello.TAG == 6


def test_tipsample_direct():
    tips = mk_tips(6)

    async def main():
        cursor = [0]

        async def source(slot, after):
            t = tips[cursor[0] % len(tips)]
            cursor[0] += 1
            return t

        async def client(s):
            return await tipsample.client_sample(s, [(2, 0), (3, 10)])

        async def server(s):
            return await tipsample.server_from_tip_source(s, source)

        return await typed.connect(tipsample.SPEC, client, server)

    (rounds, _) = sim.run(main())
    assert [len(r) for r in rounds] == [2, 3]
    assert rounds[0] == tips[:2] and rounds[1] == tips[2:5]


def test_tipsample_server_miscount_detected():
    async def main():
        async def bad_server(s):
            msg = await s.recv()                 # MsgFollowTip(n>=2, _)
            t = mk_tips(1)[0]
            await s.send(tipsample.MsgNextTipDone(t))   # ends after 1 of n
            await s.recv()

        async def client(s):
            return await tipsample.client_sample(s, [(3, 0)])

        return await typed.connect(tipsample.SPEC, client, bad_server)

    with pytest.raises(RuntimeError, match="ended after 1 tips"):
        sim.run(main())


def test_localtxmonitor_streams_mempool():
    class FakeMempool:
        def __init__(self, txs):
            self.txs = list(txs)
            self.waiters = sim.TQueue() if hasattr(sim, "TQueue") else None

        def snapshot_txs(self):
            return list(self.txs)

        async def wait_for_new(self, seen):
            while len(self.txs) <= seen:
                await sim.sleep(0.1)

    mp = FakeMempool([b"tx-a", b"tx-b"])

    async def main():
        async def feeder():
            await sim.sleep(1.0)
            mp.txs.append(b"tx-c")

        sim.spawn(feeder(), label="feeder")

        async def client(s):
            return await localtxmonitor.client_collect(s, 3)

        async def server(s):
            return await localtxmonitor.server_from_mempool(s, mp)

        return await typed.connect(localtxmonitor.SPEC, client, server)

    (got, _) = sim.run(main())
    assert got == [b"tx-a", b"tx-b", b"tx-c"]


def test_txsubmission2_relay_with_hello():
    class Reader:
        def __init__(self, txs):
            self.txs = list(txs)
            self.cursor = 0

        def next_ids(self, n):
            out = [(i, len(t)) for i, t in
                   self.txs[self.cursor:self.cursor + n]]
            self.cursor += len(out)
            return out

        def lookup(self, txid):
            return dict(self.txs).get(txid)

    txs = [(b"id%d" % i, b"payload-%d" % i) for i in range(12)]
    got = []

    async def main():
        reader = Reader(txs)
        return await typed.connect(
            txsubmission2.SPEC,
            lambda s: txsubmission2.outbound_from_mempool(s, reader),
            lambda s: txsubmission2.inbound_collect(
                s, got.append, window=5))

    sim.run(main())
    assert sorted(got) == sorted(t for _, t in txs)


def test_txsubmission2_requires_hello_first():
    async def main():
        async def outbound_skips_hello(s):
            # still in state "Hello" (client agency) — sending a reply
            # is an agency/transition violation
            await s.send(txsubmission2.MsgReplyTxIds(()))

        async def inbound(s):
            await s.recv()

        return await typed.connect(
            txsubmission2.SPEC, outbound_skips_hello, inbound)

    with pytest.raises(ProtocolError):
        sim.run(main())

# -- tests/test_protocol_examples.py -----------------------------------------

def test_example_codecs_roundtrip():
    assert roundtrip_property(ex.PING_PONG_CODEC, [
        ex.MsgPing(), ex.MsgPong(), ex.MsgPingDone()])
    assert roundtrip_property(ex.REQ_RESP_CODEC, [
        ex.MsgReq([1, "x"]), ex.MsgResp(42), ex.MsgReqDone()])


def test_ping_pong_direct():
    async def main():
        return await typed.connect(
            ex.PING_PONG_SPEC,
            lambda s: ex.ping_pong_client(s, rounds=7),
            ex.ping_pong_server)

    pongs, served = sim.run(main())
    assert pongs == 7 and served == 7


def test_req_resp_direct():
    async def main():
        return await typed.connect(
            ex.REQ_RESP_SPEC,
            lambda s: ex.req_resp_client(s, list(range(5))),
            lambda s: ex.req_resp_server(s, lambda x: x * x))

    out, served = sim.run(main())
    assert out == [0, 1, 4, 9, 16] and served == 5


def test_req_resp_pipelined_equals_unpipelined():
    reqs = list(range(9))

    def run_variant(pipelined):
        async def main():
            ca, cb = channel_pair(capacity=32, delay=0.01, label="rr")
            client_fn = (ex.req_resp_client_pipelined if pipelined
                         else ex.req_resp_client)
            ch = sim.spawn(run_peer(ex.REQ_RESP_SPEC, CLIENT, ca,
                                    lambda s: client_fn(s, reqs),
                                    pipelined=pipelined),
                           label="rr.client")
            sh = sim.spawn(run_peer(ex.REQ_RESP_SPEC, SERVER, cb,
                                    lambda s: ex.req_resp_server(
                                        s, lambda x: x + 100)),
                           label="rr.server")
            return await ch.wait(), await sh.wait()

        return sim.run(main())

    out_plain, _ = run_variant(False)
    out_pipe, _ = run_variant(True)
    assert out_plain == out_pipe == [x + 100 for x in reqs]


def test_ping_pong_agency_enforced():
    async def main():
        async def bad_server(s):
            await s.send(ex.MsgPong())   # server has no agency in PPIdle

        async def client(s):
            await s.recv()

        return await typed.connect(ex.PING_PONG_SPEC, client, bad_server)

    with pytest.raises(ProtocolError):
        sim.run(main())

# -- tests/test_protocol_instances.py -----------------------------------------

BACKEND = OpensslBackend()


def _keys(n, tag=b"node"):
    sks = [hashlib.sha256(tag + b"-%d" % i).digest() for i in range(n)]
    return sks, [ed25519_ref.public_key(sk) for sk in sks]


class TestBftLeadership:
    def test_round_robin(self):
        _, vks = _keys(3)
        p = Bft(vks)
        for slot in range(9):
            for idx in range(3):
                lead = p.check_is_leader(idx, slot, (), None)
                assert (lead is not None) == (slot % 3 == idx)


class TestPBft:
    def _chain(self, p, sks, issuers, start_slot=0):
        headers, prev = [], None
        for j, issuer in enumerate(issuers):
            h = make_header(prev, start_slot + j, (), issuer=issuer)
            h = pbft_sign_header(sks[issuer], h)
            headers.append(h)
            prev = h
        return headers

    def test_threshold_violation(self):
        sks, vks = _keys(4)
        # window 10, threshold 0.25 -> limit = 2 sigs per signer per window
        p = PBft(vks, threshold=0.25, window=10, k=5)
        ok_headers = self._chain(p, sks, [0, 1, 0, 2, 0])  # node0 signs 3 > 2
        st = HeaderState.genesis(p)
        st = validate_header(p, None, ok_headers[0], st, backend=BACKEND)
        st = validate_header(p, None, ok_headers[1], st, backend=BACKEND)
        st = validate_header(p, None, ok_headers[2], st, backend=BACKEND)
        st = validate_header(p, None, ok_headers[3], st, backend=BACKEND)
        with pytest.raises(HeaderError):
            validate_header(p, None, ok_headers[4], st, backend=BACKEND)

    def test_window_slides(self):
        sks, vks = _keys(2)
        p = PBft(vks, threshold=0.5, window=4, k=5)
        # alternating signers never violate a 0.5 threshold
        headers = self._chain(p, sks, [0, 1, 0, 1, 0, 1, 0, 1])
        res = validate_headers_batched(
            p, headers, HeaderState.genesis(p), lambda i, h: None,
            backend=BACKEND)
        assert res.all_valid

    def test_non_delegate_rejected(self):
        sks, vks = _keys(2)
        p = PBft(vks, k=5)
        h = make_header(None, 0, (), issuer=7)
        h = pbft_sign_header(sks[0], h)
        with pytest.raises(HeaderError):
            validate_header(p, None, h, HeaderState.genesis(p),
                            backend=BACKEND)


def _praos_setup(n=3, **cfg_kw):
    vrf_sks = [hashlib.sha256(b"vrf-%d" % i).digest() for i in range(n)]
    # ECVRF-ed25519 keys share ed25519's vk derivation (vk = [x]B)
    vrf_vks = [ed25519_ref.public_key(sk) for sk in vrf_sks]
    kes_keys = [kes_mod.KesSignKey(cfg_kw.get("kes_depth", 3),
                                   hashlib.sha256(b"kes-%d" % i).digest())
                for i in range(n)]
    cfg = PraosConfig(
        nodes=tuple(PraosNode(vrf_vk=vrf_vks[i],
                              kes_vk=kes_keys[i].verification_key, stake=1)
                    for i in range(n)),
        k=5, f=0.9, epoch_length=10, kes_depth=cfg_kw.get("kes_depth", 3),
        slots_per_kes_period=cfg_kw.get("slots_per_kes_period", 5))
    return cfg, vrf_sks, [HotKey(k) for k in kes_keys]


def _praos_forge_chain(protocol, vrf_sks, hot_keys, n_slots):
    """Forge a chain by letting every node try each slot (mock ThreadNet)."""
    headers, prev = [], None
    st = protocol.initial_chain_dep_state()
    for slot in range(n_slots):
        ticked = protocol.tick_chain_dep_state(st, None, slot)
        for idx in range(len(protocol.config.nodes)):
            pi = protocol.check_is_leader((idx, vrf_sks[idx]), slot, ticked,
                                          None)
            if pi is None:
                continue
            h = make_header(prev, slot, (), issuer=idx)
            h = praos_forge_fields(protocol, hot_keys[idx], pi, h)
            headers.append(h)
            prev = h
            st = protocol.reupdate_chain_dep_state(ticked, h, None)
            break
    return headers


class TestPraos:
    def test_forge_and_validate_chain(self):
        cfg, vrf_sks, hot_keys = _praos_setup()
        p = Praos(cfg)
        headers = _praos_forge_chain(p, vrf_sks, hot_keys, 25)
        assert len(headers) >= 5     # f=0.9, 3 nodes: most slots have a leader
        st = HeaderState.genesis(p)
        for h in headers:
            st = validate_header(p, None, h, st, backend=BACKEND)
        assert st.tip.block_no == len(headers) - 1
        # crossed at least one epoch boundary and evolved the nonce
        assert st.chain_dep_state.epoch >= 1

    def test_batched_matches_sequential(self):
        cfg, vrf_sks, hot_keys = _praos_setup()
        p = Praos(cfg)
        headers = _praos_forge_chain(p, vrf_sks, hot_keys, 25)
        res = validate_headers_batched(
            p, headers, HeaderState.genesis(p), lambda i, h: None,
            backend=BACKEND)
        assert res.all_valid and res.n_valid == len(headers)
        st = HeaderState.genesis(p)
        for h in headers:
            st = validate_header(p, None, h, st, backend=BACKEND)
        assert res.final_state == st

    def test_tampered_vrf_rejected(self):
        cfg, vrf_sks, hot_keys = _praos_setup()
        p = Praos(cfg)
        headers = _praos_forge_chain(p, vrf_sks, hot_keys, 10)
        h = headers[0]
        pi = bytearray(h.get("praos_rho"))
        pi[5] ^= 0x01
        bad = h.with_fields(praos_rho=bytes(pi))
        with pytest.raises(HeaderError):
            validate_header(p, None, bad, HeaderState.genesis(p),
                            backend=BACKEND)

    def test_tampered_kes_rejected(self):
        cfg, vrf_sks, hot_keys = _praos_setup()
        p = Praos(cfg)
        headers = _praos_forge_chain(p, vrf_sks, hot_keys, 10)
        h = headers[0]
        sig = bytearray(h.get("praos_kes_sig"))
        sig[3] ^= 0x01
        bad = h.with_fields(praos_kes_sig=bytes(sig))
        with pytest.raises(HeaderError):
            validate_header(p, None, bad, HeaderState.genesis(p),
                            backend=BACKEND)

    def test_non_leader_rejected(self):
        """A header whose VRF output is above the issuer's threshold must be
        rejected even if the proof itself verifies."""
        cfg, vrf_sks, hot_keys = _praos_setup()
        low = PraosConfig(nodes=cfg.nodes, k=cfg.k, f=1e-9,
                          epoch_length=cfg.epoch_length,
                          kes_depth=cfg.kes_depth,
                          slots_per_kes_period=cfg.slots_per_kes_period)
        p_forge = Praos(cfg)          # easy threshold to forge with
        p_strict = Praos(low)         # near-zero threshold to validate with
        headers = _praos_forge_chain(p_forge, vrf_sks, hot_keys, 10)
        with pytest.raises(HeaderError):
            validate_header(p_strict, None, headers[0],
                            HeaderState.genesis(p_strict), backend=BACKEND)

    def test_kes_period_evolution(self):
        """Forging far enough ahead forces KES key evolution; validation
        still passes because verification recomputes the Merkle root."""
        cfg, vrf_sks, hot_keys = _praos_setup()
        p = Praos(cfg)
        # slots 0..39 span 8 KES periods of length 5 (depth 3 = exactly 8)
        headers = _praos_forge_chain(p, vrf_sks, hot_keys, 40)
        assert max(h.slot for h in headers) >= 20
        res = validate_headers_batched(
            p, headers, HeaderState.genesis(p), lambda i, h: None,
            backend=BACKEND)
        assert res.all_valid
        assert any(k.period > 0 for k in hot_keys)


# -- tests/test_golden_wire.py: the digests no other port test pins -----------

def _h(tag: bytes) -> bytes:
    return hashlib.blake2b(tag, digest_size=32).digest()


def _golden_corpus() -> dict:
    """tests/test_golden_wire.py's sample messages of the three protocols
    and its per-era encodings, built from the port's classes."""
    from ouroboros_tpu_torch.consensus.headers import ProtocolBlock
    from ouroboros_tpu_torch.eras.byron import make_byron_tx
    from ouroboros_tpu_torch.eras.shelley import make_shelley_tx
    from ouroboros_tpu_torch.ledgers.mock import Tx, TxIn, TxOut
    from ouroboros_tpu_torch.network.protocols import txsubmission as txs
    from ouroboros_tpu_torch.utils import cbor

    tip = Tip(Point(slot=9, hash=_h(b"p2")), 4)
    txsub = [
        txs.MsgRequestTxIds(True, 2, 5),
        txs.MsgReplyTxIds(((_h(b"tx1"), 123), (_h(b"tx2"), 456))),
        txs.MsgRequestTxs((_h(b"tx1"),)),
        txs.MsgReplyTxs((b"\x01\x02\x03",)), txs.MsgDone()]
    codecs = {"txsubmission2": txsubmission2.CODEC,
              "localtxmonitor": localtxmonitor.CODEC,
              "tipsample": tipsample.CODEC}
    msgs = {
        "txsubmission2": [txsubmission2.MsgHello()] + txsub,
        "localtxmonitor": [
            localtxmonitor.MsgRequestTx(),
            localtxmonitor.MsgReplyTx(b"\x05\x06"), localtxmonitor.MsgDone()],
        "tipsample": [
            tipsample.MsgFollowTip(3, 11), tipsample.MsgNextTip(tip),
            tipsample.MsgNextTipDone(tip), tipsample.MsgDone()],
    }
    out = {k: b"".join(codecs[k].encode(m) for m in v)
           for k, v in msgs.items()}
    sk = _h(b"golden-sk")
    gen = b"\x00" * 32
    stx = make_shelley_tx(
        inputs=[(gen, 0)], outputs=[(_h(b"addr"), 1000)],
        certs=[], signing_keys=[sk])
    mtx = make_shelley_tx(
        inputs=[(gen, 1)],
        outputs=[(_h(b"addr2"), 500, ((_h(b"pol")[:28], 3),))],
        certs=[], signing_keys=[sk], validity=(2, 99),
        mint=[(_h(b"pol")[:28], 3)])
    btx = make_byron_tx(inputs=[(gen, 0)], outputs=[(_h(b"baddr"), 77)],
                        certs=[], signing_keys=[sk])
    mock = Tx((TxIn(gen, 0),), (TxOut(_h(b"maddr"), 9),))
    blk = ProtocolBlock(make_header(None, 3, (stx,), issuer=0), (stx,))
    out.update({
        "shelley_tx": cbor.dumps(stx.encode()),
        "mary_tx": cbor.dumps(mtx.encode()),
        "byron_tx": cbor.dumps(btx.encode()),
        "mock_tx": cbor.dumps(mock.encode()),
        "protocol_block": blk.bytes})
    return out


# tests/test_golden_wire.py's pinned digests of these corpora
_GOLDEN = {
    "txsubmission2": "c7f87045c404e722fd543aab69f2c4872cfdefca018e0b228be475b31c3c799e",
    "localtxmonitor": "e71b38f3e981217c9bda46ba8e8adb38ce9604a2a31e9c7ce86b14c1a8081d1a",
    "tipsample": "da67183f7d2501fc3c13a500e7f34409e97264f9ab36529d5c2c3dffd5d7a700",
    "shelley_tx": "10840410cfbeb6b63c8fc9edf40f5b70683768428ee98c6f1cec528df63ce918",
    "mary_tx": "4d03b31be3370a2d4599e1d3de392be78d0ad578c821c3cd504f36456932f52b",
    "byron_tx": "93a6e559799eaa7d4fe22efb70e72048fc53b2f4c666a00dec67bd50dd10025f",
    "mock_tx": "711d5d0203ff4ebf55b092627e8e293ca9d4bedd9968661c76275d8320aa11f5",
    "protocol_block": "dd0569b97051d06d5b3c1da851d56d4a6634fc8d73cb32761a28edc8acc86e8b",
}


@pytest.mark.parametrize("name", sorted(_GOLDEN))
def test_corpus_digest_pinned(name):
    assert hashlib.sha256(_golden_corpus()[name]).hexdigest() \
        == _GOLDEN[name]


# -- the same bytes in both packages ------------------------------------------

_NEW = ("txsubmission2", "tipsample", "localtxmonitor", "ping-pong",
        "req-resp")


def _codecs(pkg: str) -> dict:
    m = {n: importlib.import_module(f"{pkg}.network.protocols.{n}")
         for n in ("txsubmission2", "tipsample", "localtxmonitor",
                   "examples")}
    return {"txsubmission2": m["txsubmission2"].CODEC,
            "tipsample": m["tipsample"].CODEC,
            "localtxmonitor": m["localtxmonitor"].CODEC,
            "ping-pong": m["examples"].PING_PONG_CODEC,
            "req-resp": m["examples"].REQ_RESP_CODEC}


def _seeded_corpus(pkg: str, seed: int) -> dict:
    """Every message of the five protocols with fields drawn from one
    numpy generator, built from package `pkg`'s classes."""
    rng = np.random.default_rng(seed)
    t2 = importlib.import_module(f"{pkg}.network.protocols.txsubmission2")
    ts = importlib.import_module(f"{pkg}.network.protocols.tipsample")
    tm = importlib.import_module(f"{pkg}.network.protocols.localtxmonitor")
    e = importlib.import_module(f"{pkg}.network.protocols.examples")
    blk = importlib.import_module(f"{pkg}.chain.block")

    def num(hi=2 ** 32):
        return int(rng.integers(0, hi))

    def raw(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    def tip():
        return blk.Tip(blk.Point(slot=num(), hash=raw(32)), num())

    def text():
        return "".join(chr(97 + int(c)) for c in rng.integers(0, 26, num(20)))

    value = [text(), num(), raw(num(40)), [num(), raw(8)], None, True,
             {num(100): raw(4)}]
    return {
        "txsubmission2": [
            t2.MsgHello(), t2.MsgRequestTxIds(bool(num(2)), num(100),
                                              num(100)),
            t2.MsgReplyTxIds(tuple((raw(32), num()) for _ in range(num(5)))),
            t2.MsgRequestTxs(tuple(raw(32) for _ in range(num(5)))),
            t2.MsgReplyTxs(tuple(raw(num(300) + 1) for _ in range(num(4)))),
            t2.MsgDone()],
        "tipsample": [
            ts.MsgFollowTip(num(100) + 1, num()), ts.MsgNextTip(tip()),
            ts.MsgNextTipDone(tip()), ts.MsgDone()],
        "localtxmonitor": [
            tm.MsgRequestTx(), tm.MsgReplyTx(raw(num(300) + 1)),
            tm.MsgDone()],
        "ping-pong": [e.MsgPing(), e.MsgPong(), e.MsgPingDone()],
        "req-resp": [e.MsgReq(value), e.MsgResp(num()),
                     e.MsgResp(value[2:]), e.MsgReqDone()],
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", _NEW)
def test_messages_encode_to_the_jax_packages_bytes(name, seed):
    codec = _codecs("ouroboros_tpu_torch")[name]
    ref_codec = _codecs("ouroboros_tpu")[name]
    got = [codec.encode(m)
           for m in _seeded_corpus("ouroboros_tpu_torch", seed)[name]]
    want = [ref_codec.encode(m)
            for m in _seeded_corpus("ouroboros_tpu", seed)[name]]
    assert got == want
    # the JAX package's bytes decode in the port to the same messages
    assert [codec.encode(codec.decode(b)) for b in want] == want


def _relay_and_sample(pkg: str, seed: int):
    """A TxSubmission2 relay of seeded transactions over a delayed channel
    pair, then TipSample rounds over a seeded tip source, in package
    `pkg`'s simulator: (collected txs, tip rounds, end time)."""
    rng = np.random.default_rng(seed)
    psim = importlib.import_module(f"{pkg}.simharness")
    ptyped = importlib.import_module(f"{pkg}.network.typed")
    chan = importlib.import_module(f"{pkg}.network.channel")
    t2 = importlib.import_module(f"{pkg}.network.protocols.txsubmission2")
    ts = importlib.import_module(f"{pkg}.network.protocols.tipsample")
    blk = importlib.import_module(f"{pkg}.chain.block")
    txs = [(rng.integers(0, 256, 32, dtype=np.uint8).tobytes(),
            rng.integers(0, 256, int(rng.integers(1, 200)),
                         dtype=np.uint8).tobytes()) for _ in range(23)]
    tips = [blk.Tip(blk.Point(slot=int(s), hash=bytes([i]) * 32), i)
            for i, s in enumerate(np.sort(rng.integers(0, 10_000, 12)))]
    requests = [(int(rng.integers(1, 4)), int(rng.integers(0, 100)))
                for _ in range(3)]
    window = int(rng.integers(2, 7))

    class Reader:
        def __init__(self):
            self.cursor = 0

        def next_ids(self, n):
            out = [(i, len(t)) for i, t in txs[self.cursor:self.cursor + n]]
            self.cursor += len(out)
            return out

        def lookup(self, txid):
            return dict(txs).get(txid)

    got = []

    async def main():
        ca, cb = chan.channel_pair(capacity=8, delay=0.013, label="tx2")
        out = psim.spawn(ptyped.run_peer(
            t2.SPEC, ptyped.CLIENT, ca,
            lambda s: t2.outbound_from_mempool(s, Reader())), label="out")
        inb = psim.spawn(ptyped.run_peer(
            t2.SPEC, ptyped.SERVER, cb,
            lambda s: t2.inbound_collect(s, got.append, window=window)),
            label="in")
        await out.wait()
        await inb.wait()
        cursor = [0]

        async def source(slot, after):
            await psim.sleep(0.25)
            t = tips[cursor[0] % len(tips)]
            cursor[0] += 1
            return t

        rounds, _ = await ptyped.connect(
            ts.SPEC, lambda s: ts.client_sample(s, requests),
            lambda s: ts.server_from_tip_source(s, source))
        return [[t.encode() for t in r] for r in rounds], psim.now()

    rounds, end = psim.run(main(), seed=seed)
    return got, rounds, end


@pytest.mark.parametrize("seed", [0, 1])
def test_relay_and_tip_sample_equal_the_jax_packages(seed):
    port = _relay_and_sample("ouroboros_tpu_torch", seed)
    ref = _relay_and_sample("ouroboros_tpu", seed)
    assert port == ref
    assert len(port[0]) == 23


# -- tests/test_protocol_instances.py's message inventory sweep ------------
# Driven by ouro-lint's registry discovery (the port's analysis/protocol_pass):
# every message named in ANY ProtocolSpec's transition relation must have a
# sample here that round-trips through the spec's paired codec.  Adding a
# message without a codec registration fails the analyzer (PROTO005); adding
# one without a roundtrip sample fails this sweep — so new messages can't
# ship untested.

from ouroboros_tpu_torch.chain import Point, Tip, make_block, point_of
from ouroboros_tpu_torch.network.protocols import (
    blockfetch, chainsync, examples, handshake, keepalive, localstatequery,
    localtxmonitor, localtxsubmission, tipsample, txsubmission,
    txsubmission2,
)


def _sweep_samples():
    """(spec name, message name) -> non-empty list of sample instances."""
    b0 = make_block(None, 1, body=[b"tx0"])
    b1 = make_block(b0, 3, body=[b"tx1"])
    p, p1 = point_of(b0), point_of(b1)
    tip = Tip(p1, b1.block_no)
    cs, bf, tx, tx2 = chainsync, blockfetch, txsubmission, txsubmission2
    hs, ka, ts = handshake, keepalive, tipsample
    lsq, ltm, lts, ex = (localstatequery, localtxmonitor,
                         localtxsubmission, examples)
    return {
        ("ping-pong", "MsgPing"): [ex.MsgPing()],
        ("ping-pong", "MsgPong"): [ex.MsgPong()],
        ("ping-pong", "MsgPingDone"): [ex.MsgPingDone()],
        ("req-resp", "MsgReq"): [ex.MsgReq([1, "two"])],
        ("req-resp", "MsgResp"): [ex.MsgResp({"n": 3})],
        ("req-resp", "MsgReqDone"): [ex.MsgReqDone()],
        ("chain-sync", "MsgRequestNext"): [cs.MsgRequestNext()],
        ("chain-sync", "MsgAwaitReply"): [cs.MsgAwaitReply()],
        ("chain-sync", "MsgRollForward"): [cs.MsgRollForward(b0.header, tip)],
        ("chain-sync", "MsgRollBackward"): [cs.MsgRollBackward(p, tip)],
        ("chain-sync", "MsgFindIntersect"):
            [cs.MsgFindIntersect((p, Point.genesis()))],
        ("chain-sync", "MsgIntersectFound"): [cs.MsgIntersectFound(p, tip)],
        ("chain-sync", "MsgIntersectNotFound"):
            [cs.MsgIntersectNotFound(tip)],
        ("chain-sync", "MsgDone"): [cs.MsgDone()],
        ("block-fetch", "MsgRequestRange"): [bf.MsgRequestRange(p, p1)],
        ("block-fetch", "MsgClientDone"): [bf.MsgClientDone()],
        ("block-fetch", "MsgStartBatch"): [bf.MsgStartBatch()],
        ("block-fetch", "MsgNoBlocks"): [bf.MsgNoBlocks()],
        ("block-fetch", "MsgBlock"): [bf.MsgBlock(b0)],
        ("block-fetch", "MsgBatchDone"): [bf.MsgBatchDone()],
        ("tx-submission", "MsgRequestTxIds"):
            [tx.MsgRequestTxIds(True, 0, 5),   # both branch arms
             tx.MsgRequestTxIds(False, 2, 3)],
        ("tx-submission", "MsgReplyTxIds"):
            [tx.MsgReplyTxIds(((b"id1", 100), (b"id2", 200)))],
        ("tx-submission", "MsgRequestTxs"): [tx.MsgRequestTxs((b"id1",))],
        ("tx-submission", "MsgReplyTxs"): [tx.MsgReplyTxs((b"txbytes",))],
        ("tx-submission", "MsgDone"): [tx.MsgDone()],
        ("tx-submission-2", "MsgHello"): [tx2.MsgHello()],
        ("tx-submission-2", "MsgRequestTxIds"):
            [tx2.MsgRequestTxIds(True, 0, 5)],
        ("tx-submission-2", "MsgReplyTxIds"):
            [tx2.MsgReplyTxIds(((b"id1", 100),))],
        ("tx-submission-2", "MsgRequestTxs"): [tx2.MsgRequestTxs((b"id1",))],
        ("tx-submission-2", "MsgReplyTxs"): [tx2.MsgReplyTxs((b"t",))],
        ("tx-submission-2", "MsgDone"): [tx2.MsgDone()],
        ("handshake", "MsgProposeVersions"):
            [hs.MsgProposeVersions(((7, {"net": 42}), (8, None)))],
        ("handshake", "MsgAcceptVersion"):
            [hs.MsgAcceptVersion(8, {"net": 42})],
        ("handshake", "MsgRefuse"):
            [hs.MsgRefuse(hs.RefuseVersionMismatch((7, 8))),
             hs.MsgRefuse(hs.RefuseHandshakeDecodeError(8, "bad")),
             hs.MsgRefuse(hs.RefuseRefused(8, "nope"))],
        ("keep-alive", "MsgKeepAlive"): [ka.MsgKeepAlive(77)],
        ("keep-alive", "MsgKeepAliveResponse"):
            [ka.MsgKeepAliveResponse(77)],
        ("keep-alive", "MsgDone"): [ka.MsgDone()],
        ("tip-sample", "MsgFollowTip"): [ts.MsgFollowTip(2, 9)],
        ("tip-sample", "MsgNextTip"): [ts.MsgNextTip(tip)],
        ("tip-sample", "MsgNextTipDone"): [ts.MsgNextTipDone(tip)],
        ("tip-sample", "MsgDone"): [ts.MsgDone()],
        ("local-state-query", "MsgAcquire"):
            [lsq.MsgAcquire(p), lsq.MsgAcquire(None)],
        ("local-state-query", "MsgAcquired"): [lsq.MsgAcquired()],
        ("local-state-query", "MsgFailure"): [lsq.MsgFailure("behind")],
        ("local-state-query", "MsgQuery"): [lsq.MsgQuery(["get", "tip"])],
        ("local-state-query", "MsgResult"): [lsq.MsgResult({"slot": 9})],
        ("local-state-query", "MsgReAcquire"): [lsq.MsgReAcquire(None)],
        ("local-state-query", "MsgRelease"): [lsq.MsgRelease()],
        ("local-state-query", "MsgDone"): [lsq.MsgDone()],
        ("local-tx-monitor", "MsgRequestTx"): [ltm.MsgRequestTx()],
        ("local-tx-monitor", "MsgReplyTx"): [ltm.MsgReplyTx(b"tx")],
        ("local-tx-monitor", "MsgDone"): [ltm.MsgDone()],
        ("local-tx-submission", "MsgSubmitTx"): [lts.MsgSubmitTx(b"tx")],
        ("local-tx-submission", "MsgAcceptTx"): [lts.MsgAcceptTx()],
        ("local-tx-submission", "MsgRejectTx"): [lts.MsgRejectTx("bad")],
        ("local-tx-submission", "MsgDone"): [lts.MsgDone()],
    }


def test_codec_roundtrip_sweep_covers_full_message_inventory():
    from ouroboros_tpu_torch.analysis.protocol_pass import (
        discover, message_inventory)
    samples = _sweep_samples()
    specs = discover()
    assert len(specs) >= 10
    for spec, codec, _file, _line, symbol in specs:
        assert codec is not None, f"{symbol}: no paired codec"
        missing = sorted(m for m in message_inventory(spec)
                         if not samples.get((spec.name, m)))
        assert not missing, (
            f"{spec.name}: no roundtrip sample for {missing} — a new "
            f"message can't ship without a codec sample here")
        for m in sorted(message_inventory(spec)):
            for inst in samples[(spec.name, m)]:
                assert codec.decode(codec.encode(inst)) == inst, \
                    f"{spec.name}.{m} failed codec roundtrip"


def test_sweep_samples_have_no_unknown_inventory_entries():
    """The sample table can't silently rot: every key must correspond to a
    live (spec, message) pair."""
    from ouroboros_tpu_torch.analysis.protocol_pass import (
        discover, message_inventory)
    live = {(spec.name, m) for spec, *_ in discover()
            for m in message_inventory(spec)}
    stale = sorted(set(_sweep_samples()) - live)
    assert not stale, f"samples for retired messages: {stale}"
