"""Mock UTxO ledger — the SimpleBlock ledger analog.

Reference: ouroboros-consensus-mock/src/Ouroboros/Consensus/Mock/Ledger/
{UTxO,State}.hs — transactions spend (txid, ix) inputs into (addr, amount)
outputs; applying a block updates the UTxO set.  We add Ed25519 witnesses
(one per spending address, signature over the tx id) so the mock exercises
the same body-crypto seam the reference's Shelley BBODY does
(Shelley/Ledger/Ledger.hs:279 witness multi-verify) — these are the
batchable body proofs.

Ported from `ouroboros_tpu/ledgers/mock.py` (the port imports nothing of the
JAX package). Copied whole.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..chain.block import Point, point_of
from ..consensus.ledger import LedgerError, LedgerRules
from ..crypto import ed25519_ref
from ..crypto.backend import Ed25519Req
from ..utils import cbor


@dataclass(frozen=True)
class TxIn:
    txid: bytes
    ix: int

    def encode(self):
        return [self.txid, self.ix]

    @classmethod
    def decode(cls, obj):
        return cls(bytes(obj[0]), int(obj[1]))


@dataclass(frozen=True)
class TxOut:
    addr: bytes                       # = Ed25519 vk of the owner
    amount: int

    def encode(self):
        return [self.addr, self.amount]

    @classmethod
    def decode(cls, obj):
        return cls(bytes(obj[0]), int(obj[1]))


@dataclass(frozen=True)
class Tx:
    inputs: tuple                     # TxIn
    outputs: tuple                    # TxOut
    witnesses: tuple = ()             # (vk, sig-over-txid) pairs

    _cache: dict = field(default_factory=dict, repr=False, hash=False,
                         compare=False)

    @property
    def txid(self) -> bytes:
        c = self._cache
        if "id" not in c:
            body = cbor.dumps([[i.encode() for i in self.inputs],
                               [o.encode() for o in self.outputs]])
            c["id"] = hashlib.blake2b(body, digest_size=32).digest()
        return c["id"]

    def encode(self):
        return [[i.encode() for i in self.inputs],
                [o.encode() for o in self.outputs],
                [[vk, sig] for vk, sig in self.witnesses]]

    @classmethod
    def decode(cls, obj):
        return cls(tuple(TxIn.decode(i) for i in obj[0]),
                   tuple(TxOut.decode(o) for o in obj[1]),
                   tuple((bytes(vk), bytes(sig)) for vk, sig in obj[2]))


def make_tx(inputs: Sequence[TxIn], outputs: Sequence[TxOut],
            signing_keys: Sequence[bytes]) -> Tx:
    """Build and witness a tx: one signature over the txid per signing key."""
    tx = Tx(tuple(inputs), tuple(outputs))
    wits = tuple((ed25519_ref.public_key(sk), ed25519_ref.sign(sk, tx.txid))
                 for sk in signing_keys)
    return Tx(tx.inputs, tx.outputs, wits)


@dataclass(frozen=True)
class MockLedgerState:
    utxo: tuple                       # sorted ((txid, ix, addr, amount), ...)
    slot: int                         # last applied slot (tick clock)
    tip: Point

    def utxo_dict(self) -> dict:
        return {(t, i): (a, m) for t, i, a, m in self.utxo}

    def state_hash(self) -> bytes:
        """Deterministic digest for replay-parity checks (BASELINE.md
        'byte-identical ChainDB state')."""
        enc = cbor.dumps([[t, i, a, m] for t, i, a, m in self.utxo]
                         + [self.slot, self.tip.encode()])
        return hashlib.blake2b(enc, digest_size=32).digest()


def _freeze(utxo: dict) -> tuple:
    return tuple(sorted((t, i, a, m)
                 for (t, i), (a, m) in utxo.items()))


class MockLedger(LedgerRules):
    """LedgerRules over MockLedgerState.

    genesis: {addr: amount} initial distribution (spendable as inputs of
    the all-zero txid)."""

    GENESIS_TXID = b"\x00" * 32

    def __init__(self, genesis: dict):
        self.genesis = dict(genesis)

    def initial_state(self) -> MockLedgerState:
        utxo = {(self.GENESIS_TXID, ix): (addr, amount)
                for ix, (addr, amount) in enumerate(
                    sorted(self.genesis.items()))}
        return MockLedgerState(_freeze(utxo), -1, Point.genesis())

    def tip(self, state: MockLedgerState) -> Point:
        return state.tip

    def tick(self, state: MockLedgerState, slot: int) -> MockLedgerState:
        return MockLedgerState(state.utxo, slot, state.tip)

    # -- structural application (shared by apply/reapply) --------------------
    def _apply_txs(self, state: MockLedgerState, block) -> MockLedgerState:
        utxo = state.utxo_dict()
        for tx in block.body:
            if len({(i.txid, i.ix) for i in tx.inputs}) != len(tx.inputs):
                raise LedgerError(
                    f"tx {tx.txid.hex()[:12]} has duplicate inputs")
            spent = 0
            for i in tx.inputs:
                key = (i.txid, i.ix)
                if key not in utxo:
                    raise LedgerError(
                        f"missing input {i.txid.hex()[:12]}#{i.ix}")
                spent += utxo[key][1]
            if any(o.amount < 0 for o in tx.outputs):
                raise LedgerError(
                    f"tx {tx.txid.hex()[:12]} has a negative output")
            produced = sum(o.amount for o in tx.outputs)
            if produced > spent:
                raise LedgerError(
                    f"tx {tx.txid.hex()[:12]} produces {produced} > "
                    f"spends {spent}")
            for i in tx.inputs:
                del utxo[(i.txid, i.ix)]
            for ix, o in enumerate(tx.outputs):
                utxo[(tx.txid, ix)] = (o.addr, o.amount)
        return MockLedgerState(_freeze(utxo), state.slot, point_of(block))

    def check_tx_witnesses(self, state: MockLedgerState, tx: Tx) -> None:
        """Structural witness check: every spending address has a witness.
        (Signature validity itself is the batchable proof.)"""
        utxo = state.utxo_dict()
        witness_vks = {vk for vk, _ in tx.witnesses}
        for i in tx.inputs:
            key = (i.txid, i.ix)
            if key in utxo and utxo[key][0] not in witness_vks:
                raise LedgerError(
                    f"tx {tx.txid.hex()[:12]} spends from "
                    f"{utxo[key][0].hex()[:12]} without a witness")

    def sequential_checks(self, ticked: MockLedgerState, block) -> None:
        for tx in block.body:
            self.check_tx_witnesses(ticked, tx)

    def apply_block(self, ticked: MockLedgerState, block,
                    backend=None) -> MockLedgerState:
        from ..crypto.backend import default_backend
        backend = backend or default_backend()
        self.sequential_checks(ticked, block)
        reqs = self.extract_proofs(ticked, block)
        if reqs:
            ok = backend.verify_ed25519_batch(reqs)
            if not all(ok):
                raise LedgerError(
                    f"invalid tx witness in block at slot {block.slot}")
        return self._apply_txs(ticked, block)

    def reapply_block(self, ticked: MockLedgerState, block) -> MockLedgerState:
        return self._apply_txs(ticked, block)

    def extract_proofs(self, ticked: MockLedgerState, block) -> list:
        return [Ed25519Req(vk=vk, msg=tx.txid, sig=sig)
                for tx in block.body for vk, sig in tx.witnesses]

    # -- tx-level interface for the mempool ----------------------------------
    def apply_tx(self, state: MockLedgerState, tx: Tx,
                 backend=None) -> MockLedgerState:
        """Validate one tx against `state` (mempool revalidation path)."""

        class _OneTxBlock:
            body = (tx,)
            slot = state.slot
            hash = state.tip.hash

            @property
            def header(self):
                return self
        blk = _OneTxBlock()
        self.check_tx_witnesses(state, tx)
        from ..crypto.backend import default_backend
        ok = (backend or default_backend()).verify_ed25519_batch(
            self.extract_proofs(state, blk))
        if not all(ok):
            raise LedgerError(f"tx {tx.txid.hex()[:12]}: bad witness")
        new = self._apply_txs(state, blk)
        return MockLedgerState(new.utxo, state.slot, state.tip)

    def tx_proofs(self, state: MockLedgerState, tx: Tx) -> list:
        """One tx's witness obligations (the batching-service admission
        seam): same requests apply_tx would verify inline."""
        return [Ed25519Req(vk=vk, msg=tx.txid, sig=sig)
                for vk, sig in tx.witnesses]

    def ledger_view(self, state: MockLedgerState):
        return None
