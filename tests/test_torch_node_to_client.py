"""The port's node-to-client surface (`ouroboros_tpu_torch.node.
node_to_client`, `ouroboros_tpu_torch.network.protocols.{localstatequery,
localtxsubmission}`, the local server of `node.diffusion`): the cases of
tests/test_node_to_client.py, run against the port's copies;
tests/test_golden_wire.py's pinned digests of the two protocols' sample
messages; every message of both protocols with numpy-seeded fields,
encoded to the JAX package's bytes; and a 40-block Shelley chain
(`chainsynth.forge_shelley`) synced over `run_data_diffusion` on
SimSnocket from two peers, then a wallet on the follower's local address
that queries the tip and the ledger's state hash and submits valid and
flipped-witness transactions: on `TorchBackend(device="cpu")` in the port
and on `CpuRefBackend` in the JAX package, with the same tip, state hash,
chain and verdicts.

Reference: MiniProtocol/LocalStateQuery/Server.hs tests, the
LocalTxSubmission server, cardano-client Subscription.subscribe.

Tolerance: none.  Bytes, points, hashes and verdicts compare exactly.
"""
import hashlib
import importlib

import numpy as np
import pytest

from ouroboros_tpu_torch import simharness as sim
from ouroboros_tpu_torch.chain.block import Point, Tip
from ouroboros_tpu_torch.ledgers import TxIn, TxOut, make_tx
from ouroboros_tpu_torch.ledgers.mock import MockLedger
from ouroboros_tpu_torch.network.protocols import (
    localstatequery as lsq, localtxsubmission as lts,
)
from ouroboros_tpu_torch.node.node_to_client import (
    connect_local_client, subscribe,
)
from ouroboros_tpu_torch.testing import PraosNetworkFactory, ThreadNetConfig


# -- tests/test_node_to_client.py --------------------------------------------

def _solo_kernel(factory):
    kern = factory.make_node(0)
    kern.start()
    return kern


def _cfg(**kw):
    kw.setdefault("n_nodes", 1)
    kw.setdefault("f", 0.9)          # solo node: lead most slots
    kw.setdefault("k", 10)
    return ThreadNetConfig(**kw)


def test_state_query_tip_and_utxo():
    factory = PraosNetworkFactory(_cfg())

    async def main():
        kern = _solo_kernel(factory)
        await sim.sleep(6.0)             # a few slots of forging
        client = await connect_local_client(kern)
        assert client is not None
        tip = await client.query(["tip"])
        assert Point.decode(tip) == kern.chain_db.tip_point()
        kern.stop()
        return True

    assert sim.run(main(), seed=0)


def test_acquire_past_point_and_state_hash():
    factory = PraosNetworkFactory(_cfg())

    async def main():
        kern = _solo_kernel(factory)
        await sim.sleep(8.0)
        client = await connect_local_client(kern)
        past = kern.chain_db.ledger_db.past_points()[-2]
        h = await client.query(["state-hash"], point=past)
        expect = kern.chain_db.ledger_db.state_at(past).ledger.state_hash()
        assert h == expect
        # unknown point: acquire failure -> None result
        bogus = Point(999, b"\x07" * 32)
        assert await client.query(["tip"], point=bogus) is None
        kern.stop()
        return True

    assert sim.run(main(), seed=1)


def test_local_tx_submission_accept_and_reject():
    factory = PraosNetworkFactory(_cfg())
    keys = factory.keys

    async def main():
        kern = _solo_kernel(factory)
        await sim.sleep(3.0)
        client = await connect_local_client(kern)
        utxo = kern.chain_db.current_ledger.ledger.utxo_dict()
        (txid, ix), (addr, amount) = sorted(utxo.items())[0]
        tx = make_tx([TxIn(txid, ix)], [TxOut(keys[0].payment_vk, amount)],
                     [keys[0].payment_sk])
        err = await client.submit_tx(tx)
        assert err is None
        assert kern.mempool.get_snapshot().has_tx(tx.txid) or \
            kern.mempool.get_snapshot().tx_ids == []   # may already be forged
        # unsigned double spend: rejected with a reason
        bad = make_tx([TxIn(txid, ix)], [TxOut(keys[0].payment_vk, amount)],
                      [])
        err2 = await client.submit_tx(bad)
        assert err2 is not None
        kern.stop()
        return True

    assert sim.run(main(), seed=2)


def test_subscribe_streams_blocks():
    factory = PraosNetworkFactory(_cfg())

    async def main():
        kern = _solo_kernel(factory)
        client = await connect_local_client(kern)
        got = []
        await subscribe(client, got.append, until_blocks=5)
        assert len(got) == 5
        # local chainsync rolls FULL blocks (they have bodies)
        assert all(hasattr(b, "body") for b in got)
        slots = [b.slot for b in got]
        assert slots == sorted(slots)
        kern.stop()
        return True

    assert sim.run(main(), seed=3)


def test_local_handshake_magic_mismatch():
    factory = PraosNetworkFactory(_cfg())

    async def main():
        kern = _solo_kernel(factory)
        client = await connect_local_client(kern, network_magic=99)
        assert client is None
        kern.stop()
        return True

    assert sim.run(main(), seed=4)


# -- tests/test_golden_wire.py (the two node-to-client protocols) ------------

def _h(tag: bytes) -> bytes:
    return hashlib.blake2b(tag, digest_size=32).digest()


def _golden_corpus() -> dict:
    """tests/test_golden_wire.py's sample messages of the two protocols."""
    p1 = Point(slot=7, hash=_h(b"p1"))
    p2 = Point(slot=9, hash=_h(b"p2"))
    return {
        "localstatequery": [
            lsq.MsgAcquire(p1), lsq.MsgAcquired(),
            lsq.MsgFailure("pointTooOld"),
            lsq.MsgQuery(["get-balance", _h(b"addr")]),
            lsq.MsgResult(12345), lsq.MsgReAcquire(p2), lsq.MsgRelease(),
            lsq.MsgDone()],
        "localtxsubmission": [
            lts.MsgSubmitTx(b"\x01\x02"), lts.MsgAcceptTx(),
            lts.MsgRejectTx("bad witness"), lts.MsgDone()],
    }


_CODECS = {"localstatequery": lsq.CODEC, "localtxsubmission": lts.CODEC}
# tests/test_golden_wire.py's pinned digests of these two corpora
_GOLDEN = {
    "localstatequery": "b7fc8bc8a88b9e3e0f64ccf7562bfe0d49f35ce9e6eba6318838d0444137c7b5",
    "localtxsubmission": "2f7ef01c240b2671ab4043d2a0812d747538f26237d4fae48e875c0dbd292e34",
}


@pytest.mark.parametrize("name", sorted(_GOLDEN))
def test_corpus_digest_pinned(name):
    blob = b"".join(_CODECS[name].encode(m)
                    for m in _golden_corpus()[name])
    assert hashlib.sha256(blob).hexdigest() == _GOLDEN[name]


def _seeded_corpus(pkg: str, seed: int) -> dict:
    """Every message of both protocols with fields drawn from one numpy
    generator, built from package `pkg`'s classes."""
    rng = np.random.default_rng(seed)
    q = importlib.import_module(f"{pkg}.network.protocols.localstatequery")
    t = importlib.import_module(f"{pkg}.network.protocols.localtxsubmission")
    blk = importlib.import_module(f"{pkg}.chain.block")

    def num(hi=2 ** 32):
        return int(rng.integers(0, hi))

    def raw(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    def point():
        return blk.Point(slot=num(), hash=raw(32))

    def text():
        return "".join(chr(97 + int(c)) for c in rng.integers(0, 26, num(20)))

    value = [text(), num(), raw(num(40)), [num(), raw(8)], None, True]
    return {
        "localstatequery": [
            q.MsgAcquire(point()), q.MsgAcquire(None), q.MsgAcquired(),
            q.MsgFailure(text()), q.MsgQuery(["utxo"]),
            q.MsgQuery([text(), raw(32)]), q.MsgResult(value),
            q.MsgResult(num()), q.MsgResult(raw(32)),
            q.MsgReAcquire(point()), q.MsgReAcquire(None), q.MsgRelease(),
            q.MsgDone()],
        "localtxsubmission": [
            t.MsgSubmitTx(raw(num(300) + 1)), t.MsgAcceptTx(),
            t.MsgRejectTx(text()), t.MsgDone()],
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(_CODECS))
def test_messages_encode_to_the_jax_packages_bytes(name, seed):
    port = _seeded_corpus("ouroboros_tpu_torch", seed)[name]
    ref = _seeded_corpus("ouroboros_tpu", seed)[name]
    ref_codec = importlib.import_module(
        f"ouroboros_tpu.network.protocols.{name}").CODEC
    got = [_CODECS[name].encode(m) for m in port]
    want = [ref_codec.encode(m) for m in ref]
    assert got == want
    # and the JAX package's bytes decode in the port to the same messages
    assert [_CODECS[name].encode(_CODECS[name].decode(b))
            for b in want] == want


# -- a Shelley sync over run_data_diffusion, then a wallet --------------------

_BLOCKS = 40
_WALLET_VALID, _WALLET_FLIPPED = 6, 2


@pytest.fixture(scope="module")
def shelley():
    """A 40-block Shelley chain (KES depth 3, epoch length 10), its
    forger's final state, and the wallet's transactions at its tip."""
    from ouroboros_tpu_torch import chainsynth
    kw = dict(epoch_length=10, kes_depth=3)
    ext, blocks, state = chainsynth.forge_shelley(_BLOCKS, **kw)
    _ext, pools = chainsynth.shelley_setup(_BLOCKS, **kw)
    txs = chainsynth.wallet_txs(pools, state.ledger, _WALLET_VALID,
                                _WALLET_FLIPPED)
    return ext, [b.bytes for b in blocks], state, \
        [tx.encode() for tx in txs]


def _shelley_sync(pkg: str, ext, raws, tx_objs, backend,
                  preload: int = 0) -> dict:
    """In package `pkg`: two servers whose ImmutableDBs hold the blocks
    `raws`, each behind `run_data_diffusion` on one SimSnocket address; a
    follower with a mempool on `backend` (and `preload` blocks already
    in its ChainDB) that subscribes to both by IP and serves a local
    address; run until the follower's tip is the chain's, then a wallet
    on the local address queries the tip and the state hash and submits
    the transactions `tx_objs` (each encoded transaction's CBOR object)
    one at a time.  Returns what both packages must agree on."""
    s = importlib.import_module(f"{pkg}.simharness")
    storage = importlib.import_module(f"{pkg}.storage")
    chaindb = importlib.import_module(f"{pkg}.storage.chaindb")
    stream = importlib.import_module(f"{pkg}.storage.stream")
    shelley = importlib.import_module(f"{pkg}.eras.shelley")
    headers = importlib.import_module(f"{pkg}.consensus.headers")
    ledger_mod = importlib.import_module(f"{pkg}.consensus.ledger")
    mempool_mod = importlib.import_module(f"{pkg}.consensus.mempool")
    node = importlib.import_module(f"{pkg}.node")
    dif = importlib.import_module(f"{pkg}.node.diffusion")
    sn = importlib.import_module(f"{pkg}.network.snocket")
    cfg = ext.protocol.config
    protocol, ledger, _pools = shelley.shelley_genesis_setup(
        2, shelley.TPraosConfig(
            k=cfg.k, f=cfg.f, epoch_length=cfg.epoch_length,
            slots_per_kes_period=cfg.slots_per_kes_period,
            kes_depth=cfg.kes_depth,
            max_kes_evolutions=cfg.max_kes_evolutions),
        stake_per_pool=100_000, seed=b"db-synth")
    rules = ledger_mod.ExtLedgerRules(protocol, ledger)

    def decode(raw):
        return headers.ProtocolBlock.from_bytes(
            raw, tx_decode=shelley.ShelleyTx.decode, tx_body_elems=6)

    def block_obj(obj):
        return headers.ProtocolBlock.decode(
            obj, tx_decode=shelley.ShelleyTx.decode)

    blocks = [decode(r) for r in raws]
    txs = [shelley.ShelleyTx.decode(o) for o in tx_objs]

    def open_db(fs, db_backend):
        return chaindb.ChainDB.open(fs, rules, stream.pickle_encode,
                                    stream.pickle_decode, decode,
                                    backend=db_backend)

    def kernel(db, label, k_backend, mempool=None):
        return node.NodeKernel(
            db, ledger, mempool, node.BlockchainTime(1.0), label=label,
            backend=k_backend, header_decode=headers.ProtocolHeader.decode,
            block_decode_obj=block_obj, tx_decode=shelley.ShelleyTx.decode)

    out = {}

    async def main():
        await s.sleep(blocks[-1].slot + 1)
        snk = sn.SimSnocket(delay=0.02)
        local = sn.SimSnocket()
        servers = []
        for i in range(2):
            fs = storage.MockFS()
            imm = storage.ImmutableDB.open(fs, 100)
            for b in blocks:
                imm.append_block(b.slot, b.block_no, b.hash, b.prev_hash,
                                 b.bytes)
            k = kernel(open_db(fs, backend), f"server{i}", backend)
            k.start()
            await dif.run_data_diffusion(
                k, dif.DiffusionArguments(addresses=[f"srv{i}"]), snk)
            servers.append(k)
        fdb = open_db(storage.MockFS(), backend)
        for b in blocks[:preload]:
            assert fdb.add_block(b).kind == "extended"
        mempool = mempool_mod.Mempool(
            ledger, lambda: (fdb.current_ledger.ledger, fdb.tip_point()),
            backend=backend)
        follower = kernel(fdb, "follower", backend, mempool)
        follower.start()
        d = await dif.run_data_diffusion(
            follower, dif.DiffusionArguments(
                ip_producers=["srv0", "srv1"], ip_valency=2,
                mode=dif.INITIATOR_ONLY, local_address="wallet.sock"),
            snk, local_snocket=local)
        t0 = s.now()
        while fdb.tip_point() != servers[0].chain_db.tip_point():
            assert s.now() - t0 < 600, fdb.tip_point()
            await s.sleep(0.05)
        client = await dif.connect_local_client_via(
            local, "wallet.sock", (follower.network_magic, block_obj))
        out["tip"] = await client.query(["tip"])
        out["state_hash"] = await client.query(["state-hash"])
        out["verdicts"] = [await client.submit_tx(tx) for tx in txs]
        out["mempool"] = [e.tx.txid for e in mempool.get_snapshot().entries]
        out["chain"] = [p.encode() for p in fdb.current_chain.points()]
        out["invalid"] = sorted(fdb.invalid)
        out["workers"] = [list(w.trace) for w in d.workers]
        for k in servers + [follower]:
            k.stop()
        d.stop()

    s.run(main(), seed=1)
    return out


@pytest.fixture
def one_torch_thread():
    """The plain forms' many small torch ops on one thread: as fast here
    alone, and they do not fight another worker's torch threads for the
    cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_shelley_sync_and_wallet_equal_the_jax_packages(shelley,
                                                        monkeypatch,
                                                        one_torch_thread):
    """The port's follower syncs from genesis on `TorchBackend(device=
    "cpu")`; the JAX package's holds block 0 first, since its fetch logic
    cannot judge a TPraos candidate from an empty chain (ROADMAP queue 3
    item 6).  Both end on the forger's tip and state hash and give the
    wallet the same verdicts."""
    from ouroboros_tpu.crypto.backend import CpuRefBackend as JCpuRef
    from ouroboros_tpu_torch.crypto import torch_backend
    ext, raws, state, tx_objs = shelley
    # the plain forms on the CPU cost a lane each: pad a call to 16 lanes,
    # not the card's 128 (padding lanes' verdicts are dropped)
    monkeypatch.setattr(torch_backend, "MIN_BUCKET", 16)
    want = _shelley_sync("ouroboros_tpu", ext, raws, tx_objs, JCpuRef(),
                         preload=1)
    got = _shelley_sync("ouroboros_tpu_torch", ext, raws, tx_objs,
                        torch_backend.TorchBackend(device="cpu"))
    assert Point.decode(want["tip"]).slot == state.header.tip_point.slot
    assert want["state_hash"] == state.ledger.state_hash()
    assert want["verdicts"][:_WALLET_VALID] == [None] * _WALLET_VALID
    assert all("bad witness" in v for v in want["verdicts"][_WALLET_VALID:])
    assert len(want["chain"]) == _BLOCKS + 1 and want["invalid"] == []
    for key in ("tip", "state_hash", "verdicts", "mempool", "chain",
                "invalid", "workers"):
        assert got[key] == want[key], key
