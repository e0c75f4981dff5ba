"""The port's mempool (`ouroboros_tpu_torch.consensus.mempool`) against the
JAX package's.

- The cases of tests/test_mempool.py (admission, chained spends and
  double spends, duplicates, the capacity bound, revalidation on a tip
  change, removal, the snapshot for a ticked state, the reader's cursor)
  on the port's `Mempool` over its `MockLedger`.
- The same transactions through both packages' mempools give the same
  admissions, rejections and snapshot.
- `try_add_txs_async` through the port's VerifyService (over
  `TorchBackend(device="cpu")`, every flush on the device path) on the
  first blocks of a small forged Shelley chain, one call a block with a
  witness flipped in one transaction: the admitted and rejected txids and
  the snapshot equal the JAX package's `Mempool.try_add_txs` on its
  `CpuRefBackend`.

Tolerance: none.  Transaction ids compare exactly.
"""
import dataclasses
import hashlib
from fractions import Fraction

import ouroboros_tpu.chain.block as j_block
import ouroboros_tpu.consensus as j_consensus
import ouroboros_tpu.crypto.backend as j_backend
import ouroboros_tpu.crypto.kes as j_kes
import ouroboros_tpu.eras.shelley as j_shelley
import ouroboros_tpu.ledgers as j_ledgers
import ouroboros_tpu_torch.chain.block as p_block
import ouroboros_tpu_torch.ledgers as p_ledgers
from ouroboros_tpu_torch import chainsynth
from ouroboros_tpu_torch import simharness as sim
from ouroboros_tpu_torch.chain.block import Point
from ouroboros_tpu_torch.consensus import Mempool
from ouroboros_tpu_torch.crypto import ed25519_ref
from ouroboros_tpu_torch.crypto.backend import CpuRefBackend, OpensslBackend
from ouroboros_tpu_torch.crypto.batching import (
    BreakEvenTable, ServiceConfig, VerifyService,
)
from ouroboros_tpu_torch.crypto.torch_backend import TorchBackend
from ouroboros_tpu_torch.ledgers import MockLedger, TxIn, TxOut, make_tx

BACKEND = OpensslBackend()


def _setup(n_keys=3, coin=100):
    sks = [hashlib.sha256(b"mp-%d" % i).digest() for i in range(n_keys)]
    vks = [ed25519_ref.public_key(sk) for sk in sks]
    ledger = MockLedger({vk: coin for vk in vks})
    state = ledger.initial_state()
    holder = {"state": state, "tip": Point.genesis()}
    mp = Mempool(ledger, lambda: (holder["state"], holder["tip"]),
                 backend=BACKEND)
    return sks, vks, ledger, holder, mp


def _genesis_in(ledger, vks, vk):
    """TxIn spending vk's genesis output."""
    ix = sorted(vks_amounts(ledger)).index(vk)
    return TxIn(MockLedger.GENESIS_TXID, ix)


def vks_amounts(ledger):
    return list(ledger.genesis.keys())


def test_add_valid_and_invalid():
    sks, vks, ledger, holder, mp = _setup()
    tx_ok = make_tx([_genesis_in(ledger, vks, vks[0])],
                    [TxOut(vks[1], 100)], [sks[0]])
    # unsigned spend of key 1's output
    tx_bad = make_tx([_genesis_in(ledger, vks, vks[1])],
                     [TxOut(vks[2], 100)], [])
    added, rejected = mp.try_add_txs([tx_ok, tx_bad])
    assert added == [tx_ok.txid]
    assert len(rejected) == 1 and rejected[0][0] is tx_bad
    snap = mp.get_snapshot()
    assert snap.tx_ids == [tx_ok.txid]


def test_chained_txs_and_double_spend():
    sks, vks, ledger, holder, mp = _setup()
    tx1 = make_tx([_genesis_in(ledger, vks, vks[0])],
                  [TxOut(vks[1], 100)], [sks[0]])
    # tx2 spends tx1's output — valid only with tx1 in the pool
    tx2 = make_tx([TxIn(tx1.txid, 0)], [TxOut(vks[2], 60),
                                        TxOut(vks[1], 40)], [sks[1]])
    # tx3 double-spends the same genesis output as tx1
    tx3 = make_tx([_genesis_in(ledger, vks, vks[0])],
                  [TxOut(vks[2], 100)], [sks[0]])
    added, rejected = mp.try_add_txs([tx1, tx2, tx3])
    assert added == [tx1.txid, tx2.txid]
    assert rejected[0][0] is tx3
    assert "missing input" in str(rejected[0][1])


def test_duplicate_rejected():
    sks, vks, ledger, holder, mp = _setup()
    tx = make_tx([_genesis_in(ledger, vks, vks[0])],
                 [TxOut(vks[1], 100)], [sks[0]])
    mp.try_add_txs([tx])
    added, rejected = mp.try_add_txs([tx])
    assert not added and "duplicate" in str(rejected[0][1])


def test_capacity_bound():
    sks, vks, ledger, holder, mp = _setup()
    mp.capacity_bytes = 200          # roomy enough for ~1 tx only (~178 B)
    tx1 = make_tx([_genesis_in(ledger, vks, vks[0])],
                  [TxOut(vks[1], 100)], [sks[0]])
    tx2 = make_tx([_genesis_in(ledger, vks, vks[1])],
                  [TxOut(vks[2], 100)], [sks[1]])
    added, rejected = mp.try_add_txs([tx1, tx2])
    assert added == [tx1.txid]
    assert "full" in str(rejected[0][1])


def test_sync_with_ledger_drops_included():
    """Txs included in a new tip block vanish on syncWithLedger."""
    sks, vks, ledger, holder, mp = _setup()
    tx1 = make_tx([_genesis_in(ledger, vks, vks[0])],
                  [TxOut(vks[1], 100)], [sks[0]])
    tx2 = make_tx([_genesis_in(ledger, vks, vks[1])],
                  [TxOut(vks[2], 100)], [sks[1]])
    mp.try_add_txs([tx1, tx2])

    # "adopt a block" containing tx1: advance the ledger by hand
    class _B:
        body = (tx1,)
        slot = 1
        hash = b"\x01" * 32
    new_state = ledger._apply_txs(ledger.tick(holder["state"], 1), _B())
    holder["state"] = new_state
    holder["tip"] = Point(1, _B.hash)

    dropped = mp.sync_with_ledger()
    assert dropped == [tx1.txid]
    assert mp.get_snapshot().tx_ids == [tx2.txid]
    # tx2 revalidated against the new base
    assert mp.get_snapshot().ledger_state.utxo_dict() != new_state.utxo_dict()


def test_remove_txs():
    sks, vks, ledger, holder, mp = _setup()
    tx1 = make_tx([_genesis_in(ledger, vks, vks[0])],
                  [TxOut(vks[1], 100)], [sks[0]])
    tx2 = make_tx([TxIn(tx1.txid, 0)], [TxOut(vks[2], 100)], [sks[1]])
    mp.try_add_txs([tx1, tx2])
    # removing tx1 invalidates tx2 (chained) during revalidation
    mp.remove_txs([tx1.txid])
    assert mp.get_snapshot().tx_ids == []


def test_snapshot_for_ticked_state():
    sks, vks, ledger, holder, mp = _setup()
    tx = make_tx([_genesis_in(ledger, vks, vks[0])],
                 [TxOut(vks[1], 100)], [sks[0]])
    mp.try_add_txs([tx])
    ticked = ledger.tick(holder["state"], 5)
    snap = mp.get_snapshot_for(5, ticked)
    assert snap.tx_ids == [tx.txid]
    assert snap.slot == 5
    # the snapshot state has the tx applied
    assert (tx.txid, 0) in snap.ledger_state.utxo_dict()


def test_reader_cursor():
    sks, vks, ledger, holder, mp = _setup()
    r = mp.reader()
    assert r.next_ids(5) == []
    tx1 = make_tx([_genesis_in(ledger, vks, vks[0])],
                  [TxOut(vks[1], 100)], [sks[0]])
    tx2 = make_tx([_genesis_in(ledger, vks, vks[1])],
                  [TxOut(vks[2], 100)], [sks[1]])
    mp.try_add_txs([tx1])
    ids = r.next_ids(5)
    assert [i for i, _ in ids] == [tx1.txid]
    mp.try_add_txs([tx2])
    ids = r.next_ids(5)
    assert [i for i, _ in ids] == [tx2.txid]      # cursor advanced past tx1
    assert r.next_ids(5) == []
    assert r.lookup(tx1.txid) is tx1
    assert r.lookup(b"\x00" * 32) is None


# --- both packages' mempools on the same transactions ------------------------

def _mock_run(ledgers, point_mod, mempool_cls, backend):
    """tests/test_mempool.py's shapes in one sequence (a chained spend,
    a double spend, an unsigned spend, a duplicate), in one package's
    types.  Returns each call's (added, rejected txids) and the
    snapshot."""
    sks = [hashlib.sha256(b"mp-%d" % i).digest() for i in range(3)]
    vks = [ed25519_ref.public_key(sk) for sk in sks]
    ledger = ledgers.MockLedger({vk: 100 for vk in vks})
    mp = mempool_cls(ledger, lambda: (ledger.initial_state(),
                                      point_mod.Point.genesis()),
                     backend=backend)

    def gin(vk):
        return ledgers.TxIn(ledgers.MockLedger.GENESIS_TXID,
                            sorted(ledger.genesis.keys()).index(vk))
    tx1 = ledgers.make_tx([gin(vks[0])], [ledgers.TxOut(vks[1], 100)],
                          [sks[0]])
    tx2 = ledgers.make_tx([ledgers.TxIn(tx1.txid, 0)],
                          [ledgers.TxOut(vks[2], 60),
                           ledgers.TxOut(vks[1], 40)], [sks[1]])
    tx3 = ledgers.make_tx([gin(vks[0])], [ledgers.TxOut(vks[2], 100)],
                          [sks[0]])
    tx4 = ledgers.make_tx([gin(vks[1])], [ledgers.TxOut(vks[2], 100)], [])
    calls = [mp.try_add_txs(batch) for batch in ([tx1, tx2, tx3], [tx4],
                                                 [tx1])]
    return ([(added, [t.txid for t, _e in rej]) for added, rej in calls],
            mp.get_snapshot().tx_ids)


def test_mock_mempool_same_in_both_packages():
    want = _mock_run(j_ledgers, j_block, j_consensus.Mempool,
                     j_backend.OpensslBackend())
    got = _mock_run(p_ledgers, p_block, Mempool, OpensslBackend())
    assert got == want
    assert [len(a) for a, _r in got[0]] == [2, 0, 0]


# --- try_add_txs_async through the service on a forged Shelley chain ---------

SH_BLOCKS, SH_EPOCH, SH_DEPTH = 6, 10, 3
TAMPERED_TX = 3            # the 4th transaction's witness is flipped


def _jax_shelley_ledger():
    """The JAX package's genesis for chainsynth.forge_shelley(SH_BLOCKS,
    epoch_length=SH_EPOCH, kes_depth=SH_DEPTH): the same configuration
    formula and seed."""
    f = Fraction(4, 5)
    spp = max(1, int(SH_BLOCKS * 2 / f)
              // j_kes.total_periods(SH_DEPTH) + 1)
    cfg = j_shelley.TPraosConfig(
        k=2160, f=f, epoch_length=SH_EPOCH, slots_per_kes_period=spp,
        kes_depth=SH_DEPTH,
        max_kes_evolutions=j_kes.total_periods(SH_DEPTH) - 2)
    _protocol, ledger, _pools = j_shelley.shelley_genesis_setup(
        2, cfg, stake_per_pool=100_000, seed=b"db-synth")
    return ledger


def _flip_witness(tx):
    (vk, sig), *rest = tx.witnesses
    bad = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
    return dataclasses.replace(tx, witnesses=((vk, bad), *rest))


def test_async_admission_through_the_service_equals_the_jax_mempool():
    ext, chain, _state = chainsynth.forge_shelley(
        SH_BLOCKS, epoch_length=SH_EPOCH, kes_depth=SH_DEPTH)
    per_block, j = [], 0
    for blk in chain:
        txs = []
        for tx in blk.body:
            txs.append(_flip_witness(tx) if j == TAMPERED_TX else tx)
            j += 1
        per_block.append(txs)

    j_ledger = _jax_shelley_ledger()
    j_genesis = j_ledger.initial_state()
    ref = j_consensus.Mempool(
        j_ledger, lambda: (j_genesis, j_block.Point.genesis()),
        backend=j_backend.CpuRefBackend())
    want = []
    for txs in per_block:
        j_txs = [j_shelley.ShelleyTx(**{f.name: getattr(tx, f.name)
                                        for f in dataclasses.fields(tx)})
                 for tx in txs]
        added, rej = ref.try_add_txs(j_txs)
        want.append((added, [t.txid for t, _e in rej]))

    genesis = ext.initial_state().ledger
    mp = Mempool(ext.ledger, lambda: (genesis, Point.genesis()),
                 backend=CpuRefBackend())
    device = TorchBackend(device="cpu")
    table = BreakEvenTable({p: {"n_star": 1} for p in
                            ("ed25519", "vrf", "kes")}, "cpu")

    async def main():
        svc = await VerifyService(device, cpu_ref=CpuRefBackend(),
                                  config=ServiceConfig(
                                      default_deadline=0.01),
                                  break_even=table).start()
        mp.verify_service = svc
        got = []
        for txs in per_block:
            added, rej = await mp.try_add_txs_async(txs)
            got.append((added, [t.txid for t, _e in rej]))
        await svc.stop()
        return got, dict(svc.stats)

    (got, stats), trace = sim.run_trace(main())
    assert got == want
    assert mp.get_snapshot().tx_ids == ref.get_snapshot().tx_ids
    n_txs = sum(len(txs) for txs in per_block)
    assert sum(len(r) for _a, r in got) >= 1           # the flipped one
    assert stats["device_requests"] == stats["submitted"] == n_txs
    assert stats["fallback_requests"] == 0
    assert not sim.leaked_threads(trace)
