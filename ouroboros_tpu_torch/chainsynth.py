"""Forge a Shelley (TPraos) chain in memory: the replay's workload.

The in-memory counterpart of `tools/db_synth.py:synth_shelley` (the chain
`bench.py` replays): the same configuration formula and the same forging
loop, without the storage writes.  Every slot, each pool in turn checks
leadership with its VRF key; the leader's block carries `txs_per_block`
transactions, each moving one pool owner's coin back to itself (owner
`(forged * txs_per_block + t) mod pools`, spending that owner's oldest
output), and is KES-signed by the pool's evolving hot key.

Forging is pure Python (the port's CPU references) and deterministic in
`seed`: RFC 8032 signing and the ECVRF prover are deterministic, so the
bytes equal the JAX package's for the same parameters.  Most of its time
is the VRF prover's leadership checks (about 2.8 proofs a block at
f = 4/5 with two pools).

    ext, blocks, state = forge_shelley(2304, kes_depth=6)
    ext.initial_state() ... replay ... state.ledger.state_hash()

`reapplied_state` is `tick_then_reapply` folded over the forged chain, as
db_synth computes it: its `ledger.state_hash()` is what a valid replay
must end at, known without verifying any proof.
"""
from __future__ import annotations

from dataclasses import replace
from fractions import Fraction
from typing import Optional

from .consensus.headers import ProtocolBlock, make_header
from .consensus.ledger import ExtLedgerRules
from .crypto import kes as kes_mod
from .eras.shelley import (TPraosConfig, forge_tpraos_fields,
                           make_shelley_tx, shelley_genesis_setup)

K = 2160                       # db_synth's security parameter


def tpraos_config(blocks: int, f: Fraction, epoch_length: int,
                  kes_depth: int) -> TPraosConfig:
    """db_synth's configuration: KES periods cover the whole chain."""
    slots_per_period = max(
        1, int(blocks * 2 / f) // kes_mod.total_periods(kes_depth) + 1)
    return TPraosConfig(
        k=K, f=f, epoch_length=epoch_length,
        slots_per_kes_period=slots_per_period, kes_depth=kes_depth,
        max_kes_evolutions=kes_mod.total_periods(kes_depth) - 2)


def shelley_setup(blocks: int, pools: int = 2, f: str = "4/5",
                  epoch_length: int = 600, kes_depth: int = 10,
                  seed: bytes = b"db-synth") -> tuple:
    """The genesis a `blocks`-block chain is forged from: (ext_rules,
    pool list), each pool with 100,000 of stake (db_synth's)."""
    cfg = tpraos_config(blocks, Fraction(f), epoch_length, kes_depth)
    protocol, ledger, pool_list = shelley_genesis_setup(
        pools, cfg, stake_per_pool=100_000, seed=seed)
    return ExtLedgerRules(protocol, ledger), pool_list


def _flip_first_witness(body: list) -> list:
    tx = body[0]
    vk, sig = tx.witnesses[0]
    bad = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
    return [replace(tx, witnesses=((vk, bad),) + tx.witnesses[1:])] \
        + list(body[1:])


def forge_shelley(blocks: int, txs_per_block: int = 2, pools: int = 2,
                  f: str = "4/5", epoch_length: int = 600,
                  kes_depth: int = 10, seed: bytes = b"db-synth",
                  bad_witness_at: Optional[int] = None,
                  log=None) -> tuple:
    """Forge `blocks` blocks; returns (ext_rules, blocks,
    reapplied_state), and with `bad_witness_at` = i a fourth item: block
    i with its first witness signature flipped before its header was
    forged and KES-signed (the key has evolved past its period by the
    end, so it cannot be re-signed later).  `log(forged)` is called
    every 500 blocks."""
    ext, pool_list = shelley_setup(blocks, pools, f, epoch_length,
                                   kes_depth, seed)
    protocol, ledger = ext.protocol, ext.ledger
    state = ext.initial_state()
    # spendable (txid, ix, amount) per pool owner, from the genesis
    # pseudo-tx
    gen_order = sorted(p["addr"] for p in pool_list)
    spendable = {i: [(ledger.GENESIS_TXID, gen_order.index(p["addr"]),
                      100_000)] for i, p in enumerate(pool_list)}
    out: list = []
    variant = None
    prev = None
    slot = 0
    while len(out) < blocks:
        view = ledger.forecast_view(state.ledger, slot)
        ticked = protocol.tick_chain_dep_state(
            state.header.chain_dep_state, view, slot)
        lead = None
        for p in pool_list:
            lead = protocol.check_is_leader(p["can_be_leader"], slot,
                                            ticked, view)
            if lead is not None:
                break
        if lead is None:
            slot += 1
            continue
        body = []
        for t in range(txs_per_block):
            owner = (len(out) * txs_per_block + t) % len(pool_list)
            if not spendable[owner]:
                continue
            txid, ix, amount = spendable[owner].pop(0)
            op = pool_list[owner]
            tx = make_shelley_tx(
                inputs=[(txid, ix)], outputs=[(op["addr"], amount)],
                certs=[], signing_keys=[op["keys"].addr_sk])
            spendable[owner].append((tx.txid, 0, amount))
            body.append(tx)
        if len(out) == bad_witness_at:
            bad = _flip_first_witness(body)
            hdr = forge_tpraos_fields(
                protocol, p["hot_key"], p["can_be_leader"], lead,
                make_header(prev, slot, bad, issuer=0))
            variant = ProtocolBlock(hdr, tuple(bad))
        signed = forge_tpraos_fields(protocol, p["hot_key"],
                                     p["can_be_leader"], lead,
                                     make_header(prev, slot, body, issuer=0))
        block = ProtocolBlock(signed, tuple(body))
        state = ext.tick_then_reapply(state, block)
        out.append(block)
        prev = signed
        slot += 1
        if log is not None and len(out) % 500 == 0:
            log(len(out))
    if bad_witness_at is None:
        return ext, out, state
    return ext, out, state, variant


def wallet_txs(pools, ledger_state, n_valid: int,
               n_flipped: int = 0) -> list:
    """Transactions a wallet submits at a tip whose ledger state is
    `ledger_state`, made as forge_shelley makes a block's: `n_valid`
    spends, the pool owners taken in turn, each spending its owner's
    oldest unspent output (first the owner's output in `ledger_state`,
    then the output of the owner's previous transaction) back to the
    owner, witnessed by the owner's key; then `n_flipped` more, each
    spending its owner's oldest unspent output with one byte of its
    witness signature flipped (byte 7 t mod 64 of the t-th), so that
    only the witness check rejects it.  `pools` is `shelley_setup`'s pool
    list for the chain's parameters."""
    utxo = ledger_state.utxo_dict()
    spendable = {i: sorted((txid, ix, amount) for (txid, ix), (addr, amount,
                                                              _a)
                           in utxo.items() if addr == p["addr"])
                 for i, p in enumerate(pools)}
    out = []
    for t in range(n_valid):
        owner = t % len(pools)
        txid, ix, amount = spendable[owner].pop(0)
        op = pools[owner]
        tx = make_shelley_tx(inputs=[(txid, ix)],
                             outputs=[(op["addr"], amount)], certs=[],
                             signing_keys=[op["keys"].addr_sk])
        spendable[owner].append((tx.txid, 0, amount))
        out.append(tx)
    for t in range(n_flipped):
        owner = t % len(pools)
        txid, ix, amount = spendable[owner][0]
        op = pools[owner]
        tx = make_shelley_tx(inputs=[(txid, ix)],
                             outputs=[(op["addr"], amount)], certs=[],
                             signing_keys=[op["keys"].addr_sk])
        vk, sig = tx.witnesses[0]
        j = 7 * t % 64
        bad = sig[:j] + bytes([sig[j] ^ 1]) + sig[j + 1:]
        out.append(replace(tx, witnesses=((vk, bad),)))
    return out


# -- the chain database's on-disk state (storage/chaindb.py) ------------------

def shelley_block_decode(raw: bytes) -> ProtocolBlock:
    """A Shelley block from its bytes: db_analyser's span-retaining
    decoder (six body fields a transaction, then its witnesses)."""
    from .eras.shelley import ShelleyTx
    return ProtocolBlock.from_bytes(raw, tx_decode=ShelleyTx.decode,
                                    tx_body_elems=6)


def write_chaindb(fs, blocks, n_immutable: int) -> None:
    """Leave `blocks` on `fs` as a running ChainDB leaves a chain: the
    first `n_immutable` in the ImmutableDB, the rest in the VolatileDB
    (`VolatileDB.put_block`), no ledger snapshot; chunks of 100 slots
    and 50 blocks a volatile file, `ChainDB.open`'s defaults."""
    from .storage import ImmutableDB, VolatileDB
    imm = ImmutableDB.open(fs, 100)
    for b in blocks[:n_immutable]:
        imm.append_block(b.slot, b.block_no, b.hash, b.prev_hash, b.bytes)
    vol = VolatileDB.open(fs, 50)
    for b in blocks[n_immutable:]:
        vol.put_block(b.hash, b.prev_hash, b.slot, b.block_no, b.bytes)


def open_chaindb(fs, ext, backend, db_cls=None):
    """`ChainDB.open` over a Shelley chain on `fs` (`write_chaindb`'s
    layout) with the port's snapshot codec: the immutable replay, then
    the initial chain selection, whose candidates `backend` verifies.
    `db_cls` is ChainDB (the default) or a subclass of it."""
    from .storage.chaindb import ChainDB
    from .storage.stream import pickle_decode, pickle_encode
    return (db_cls or ChainDB).open(fs, ext, pickle_encode, pickle_decode,
                                    shelley_block_decode, backend=backend)
