"""The port's dual ledger (`ouroboros_tpu_torch.testing.dual`): the
production era ledgers against naive executable specs over random tx
streams (valid and invalid), lockstep after every block; the cases of
tests/test_dual_ledger.py, run against the port's copies.

Reference: Ledger/Dual.hs + ouroboros-consensus-byronspec.
"""
import hashlib
import random
from fractions import Fraction

import pytest

from ouroboros_tpu_torch.crypto import ed25519_ref
from ouroboros_tpu_torch.crypto.backend import CpuRefBackend
from ouroboros_tpu_torch.eras.byron import CERT_DLG, make_byron_tx
from ouroboros_tpu_torch.eras.shelley import (
    CERT_DELEG, CERT_POOL, TPraosConfig, make_shelley_tx, pool_id_of,
)
from ouroboros_tpu_torch.testing.dual import (
    DualLedgerMismatch, dual_byron, dual_shelley,
)

GEN = b"\x00" * 32
# the port's default backend is the card, so the host reference is named
BACKEND = CpuRefBackend()


class FakeBlock:
    """Body + slot + hash carrier (the ledger rules' HasHeader surface)."""

    def __init__(self, body, slot):
        self.body = tuple(body)
        self.slot = slot
        self.hash = hashlib.blake2b(
            b"%d" % slot + b"".join(tx.txid for tx in body),
            digest_size=32).digest()
        self.header = self


def _keys(n, tag):
    sks = [hashlib.blake2b(b"dual-%s-%d" % (tag, i),
                           digest_size=32).digest() for i in range(n)]
    return sks, [ed25519_ref.public_key(sk) for sk in sks]


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_byron_dual_random_streams(seed):
    rng = random.Random(seed)
    sks, vks = _keys(4, b"by")
    gsks, gvks = _keys(2, b"bygen")
    genesis = {vks[i]: 1000 for i in range(4)}
    dual = dual_byron(genesis, gvks, gvks)
    # spendable outputs per owner index
    owned = {i: [(GEN, sorted(vks).index(vks[i]), 1000)] for i in range(4)}
    slot = 1
    for step in range(60):
        kind = rng.random()
        body = []
        if kind < 0.6:
            # valid transfer
            o = rng.randrange(4)
            if owned[o]:
                txid, ix, amt = owned[o].pop(0)
                dest = rng.randrange(4)
                give = rng.randrange(amt + 1)
                tx = make_byron_tx(
                    [(txid, ix)],
                    [(vks[dest], give), (vks[o], amt - give)],
                    [], [sks[o]])
                owned[dest].append((tx.txid, 0, give))
                owned[o].append((tx.txid, 1, amt - give))
                body = [tx]
        elif kind < 0.75:
            # delegation cert
            gix = rng.randrange(2)
            tx = make_byron_tx(
                [], [], [(CERT_DLG, gix.to_bytes(8, "big"),
                          vks[rng.randrange(4)])], [gsks[gix]])
            body = [tx]
        elif kind < 0.9:
            # invalid: overspend — both sides must reject identically
            o = rng.randrange(4)
            if owned[o]:
                txid, ix, amt = owned[o][0]
                body = [make_byron_tx([(txid, ix)],
                                      [(vks[o], amt + 1)], [], [sks[o]])]
        else:
            # invalid: duplicate inputs
            o = rng.randrange(4)
            if owned[o]:
                txid, ix, amt = owned[o][0]
                body = [make_byron_tx([(txid, ix), (txid, ix)],
                                      [(vks[o], amt)], [], [sks[o]])]
        res = dual.apply_block(FakeBlock(body, slot), backend=BACKEND)    # raises on skew
        if res.impl_error is not None and body:
            # rejected tx: restore generator bookkeeping is unnecessary
            # (owned was only mutated on the valid paths)
            pass
        slot += 1


@pytest.mark.parametrize("seed", [21, 22])
def test_shelley_dual_random_streams(seed):
    rng = random.Random(seed)
    cfg = TPraosConfig(k=3, f=Fraction(1, 2), epoch_length=15,
                       slots_per_kes_period=5, kes_depth=3)
    sks, vks = _keys(4, b"sh")
    cold_sks, cold_vks = _keys(2, b"shcold")
    pool_ids = [pool_id_of(v) for v in cold_vks]
    genesis = {vks[i]: 1000 for i in range(4)}
    dual = dual_shelley(genesis, cfg,
                        {pool_ids[0]: b"\x01" * 32},
                        {vks[0]: pool_ids[0]})
    owned = {i: [(GEN, sorted(vks).index(vks[i]), 1000)] for i in range(4)}
    slot = 1
    for step in range(80):
        kind = rng.random()
        body = []
        if kind < 0.55:
            o = rng.randrange(4)
            if owned[o]:
                txid, ix, amt = owned[o].pop(0)
                dest = rng.randrange(4)
                give = rng.randrange(amt + 1)
                tx = make_shelley_tx(
                    [(txid, ix)],
                    [(vks[dest], give), (vks[o], amt - give)],
                    [], [sks[o]])
                owned[dest].append((tx.txid, 0, give))
                owned[o].append((tx.txid, 1, amt - give))
                body = [tx]
        elif kind < 0.7:
            # register the second pool / re-delegate someone
            which = rng.random()
            o = rng.randrange(4)
            if which < 0.5:
                body = [make_shelley_tx(
                    [], [], [(CERT_POOL, cold_vks[1], b"\x02" * 32)],
                    [cold_sks[1]])]
            else:
                pid = pool_ids[rng.randrange(2)]
                tx = make_shelley_tx(
                    [], [], [(CERT_DELEG, vks[o], pid)], [sks[o]])
                body = [tx]
        elif kind < 0.85:
            o = rng.randrange(4)
            if owned[o]:
                txid, ix, amt = owned[o][0]
                body = [make_shelley_tx([(txid, ix)],
                                        [(vks[o], amt + 5)], [], [sks[o]])]
        else:
            o = rng.randrange(4)
            if owned[o]:
                txid, ix, amt = owned[o][0]
                body = [make_shelley_tx([(txid, ix), (txid, ix)],
                                        [(vks[o], amt)], [], [sks[o]])]
        res = dual.apply_block(FakeBlock(body, slot), backend=BACKEND)
        # delegation to the unregistered pool must fail on BOTH sides —
        # apply_block already asserts error agreement
        slot += rng.randrange(1, 4)     # cross epoch boundaries sometimes


def test_bad_witness_rejected_by_both_sides():
    """A structurally-fine tx with an INVALID signature: the impl rejects
    via the crypto backend, the spec via ed25519_ref — agreement holds."""
    sks, vks = _keys(2, b"bw")
    gsks, gvks = _keys(1, b"bwgen")
    dual = dual_byron({vks[0]: 100}, gvks, gvks)
    tx = make_byron_tx([(GEN, 0)], [(vks[1], 100)], [], [sks[0]])
    bad_sig = bytes(64)
    from dataclasses import replace as _rep
    tx = _rep(tx, witnesses=((vks[0], bad_sig),))
    res = dual.apply_block(FakeBlock([tx], 1), backend=BACKEND)
    assert res.impl_error is not None and res.spec_error is not None
    # and the states stayed in lockstep: a clean spend still works
    good = make_byron_tx([(GEN, 0)], [(vks[1], 100)], [], [sks[0]])
    res2 = dual.apply_block(FakeBlock([good], 2), backend=BACKEND)
    assert res2.impl_error is None


def test_dual_catches_injected_divergence():
    """Sanity: a deliberate impl/spec divergence trips the oracle."""
    sks, vks = _keys(2, b"dv")
    gsks, gvks = _keys(1, b"dvgen")
    dual = dual_byron({vks[0]: 100}, gvks, gvks)
    # corrupt the spec state directly
    dual.spec.utxo[(b"\xff" * 32, 0)] = (vks[1], 5)
    tx = make_byron_tx([(GEN, 0)], [(vks[0], 100)], [], [sks[0]])
    with pytest.raises(DualLedgerMismatch):
        dual.apply_block(FakeBlock([tx], 1), backend=BACKEND)
