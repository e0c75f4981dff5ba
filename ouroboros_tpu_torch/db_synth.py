"""db-synth — forge an on-disk chain to replay with db-analyser.

    python -m ouroboros_tpu_torch.db_synth --out DIR [--protocol shelley]
        [--blocks N] [--txs-per-block M] [--pools P] [--f NUM/DEN]
        [--epoch-length E] [--kes-depth D] [--chunk-size C]
        [--format native|reference] [--eras ladder|byron-shelley]

The role the reference's `db-converter` plays for its validate-mainnet CI
gate (ouroboros-consensus-byron `db-converter`): produce an ImmutableDB
the analyser can replay.  Three chain flavours:

  --protocol mock-praos   mock ledger + mock-Praos (1 VRF + 1 KES/header)
  --protocol shelley      TPraos + Shelley ledger: 2 ECVRF proofs + 1 KES
                          signature + 1 OCert Ed25519 signature per
                          header, Ed25519 transaction witnesses per body
  --protocol cardano      Byron (PBFT, EBBs) -> Shelley through the
                          hard-fork combinator, with `--eras ladder` on
                          to Allegra and Mary

Ported from `tools/db_synth.py` (the port imports nothing of the JAX
package): for the same arguments it writes the same files, byte for
byte (`config.json`, the chunks and their indices, in either format).
The Shelley chain is `chainsynth.forge_shelley`'s, written by
`write_chain`, so a caller that already forged a chain in memory writes
it to disk without forging it again:

    ext, blocks, _state = chainsynth.forge_shelley(2304, kes_depth=6)
    write_chain(out, shelley_config(ext, chunk_size=100), blocks)

Forging is pure Python on the host and needs no device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from fractions import Fraction

from . import chainsynth
from .consensus.hardfork.combinator import ERA_FIELD
from .consensus.headers import ProtocolBlock, make_header
from .consensus.protocols.praos import (
    HotKey, Praos, PraosConfig, PraosNode, praos_forge_fields,
)
from .crypto import ed25519_ref, kes as kes_mod
from .eras.byron import CERT_UPDATE, byron_sign_header, make_byron_tx, make_ebb
from .eras.cardano import ALLEGRA, BYRON, MARY, cardano_setup
from .eras.shelley import TPraosConfig, forge_tpraos_fields, make_shelley_tx, \
    pool_id_of
from .ledgers.mock import Tx, TxIn, TxOut
from .storage.fs import IoFS
from .storage.immutabledb import ImmutableDB
from .storage.refformat import RefDbWriter
from .utils import cbor as _cbor


class _RefShim:
    """ImmutableDB.append_block's signature over RefDbWriter, computing
    the header-within-block span the secondary entries record."""

    def __init__(self, fs, chunk_size: int, epoch_length: int):
        self._w = RefDbWriter(fs, chunk_size, epoch_length=epoch_length)

    def append_block(self, slot, block_no, h, prev_hash, data,
                     is_ebb=False):
        obj = _cbor.loads(data)
        hdr_enc = _cbor.dumps(obj[0])
        off = data.find(hdr_enc)
        if off < 0:
            # fail loudly at write time: a wrong header span in the
            # secondary index would only surface as downstream garbage
            raise RuntimeError(
                f"block at slot {slot}: header re-encoding is not a "
                f"substring of the block bytes; cannot record the "
                f"header span in the reference secondary index")
        self._w.append_block(slot, h, data, is_ebb=is_ebb,
                             header_offset=off, header_size=len(hdr_enc))

    def close(self):
        self._w.close()


def open_out_db(fs, fmt: str = "native", chunk_size: int = 100,
                epoch_length: int = 500):
    """The output store: the native ImmutableDB, or a reference-format
    writer (`fmt="reference"`: the .primary/.secondary/.chunk dialect of
    Impl/Index/{Primary,Secondary}.hs) behind the same append_block
    shape.  The reference format's tail chunk is written by `close()`."""
    if fmt != "reference":
        return ImmutableDB.open(fs, chunk_size, validate_all=False)
    return _RefShim(fs, chunk_size, epoch_length)


def _append(db, blk) -> None:
    db.append_block(blk.slot, blk.block_no, blk.hash, blk.prev_hash,
                    blk.bytes, is_ebb=bool(blk.header.get("ebb", 0)))


def _write_config(out: str, config: dict) -> None:
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "config.json"), "w") as fh:
        json.dump(config, fh, indent=2)


def write_chain(out: str, config: dict, blocks, fmt: str = "native",
                epoch_length: int = 500) -> None:
    """Write `config` as `out/config.json` and `blocks` (ProtocolBlocks
    in chain order) into the DB under `out`, at `config["chunk_size"]`
    slots a chunk, in `fmt` ("native" or "reference"; the reference
    format also needs the chain's `epoch_length`)."""
    _write_config(out, config)
    db = open_out_db(IoFS(out), fmt, config["chunk_size"], epoch_length)
    for blk in blocks:
        _append(db, blk)
    if hasattr(db, "close"):
        db.close()              # flush the reference-format tail chunk


def shelley_config(ext, chunk_size: int = 100) -> dict:
    """The `config.json` of a Shelley chain forged from `ext` (the rules
    `chainsynth.shelley_setup` / `forge_shelley` return), as the
    analyser rebuilds the protocol and ledger from it."""
    cfg, ledger = ext.protocol.config, ext.ledger
    return {
        "protocol": "shelley",
        "k": cfg.k, "f": str(cfg.f), "epoch_length": cfg.epoch_length,
        "slots_per_kes_period": cfg.slots_per_kes_period,
        "kes_depth": cfg.kes_depth,
        "max_kes_evolutions": cfg.max_kes_evolutions,
        "genesis_seed": ext.protocol.genesis_seed.decode(),
        "genesis": {a.hex(): amt for a, amt in ledger.genesis.items()},
        "pools": [{"pool_id": pid.hex(),
                   "vrf_vk": ledger.initial_pools[pid].hex(),
                   "addr": addr.hex()}
                  for addr, pid in ledger.initial_delegs.items()],
        "chunk_size": chunk_size,
    }


def shelley_config_for(args) -> dict:
    """The `config.json` the CLI writes for `args`, without forging."""
    ext, _pools = chainsynth.shelley_setup(
        args.blocks, args.pools, args.f, args.epoch_length, args.kes_depth,
        args.seed.encode())
    return shelley_config(ext, args.chunk_size)


def _progress(t0: float, total: int):
    def log(forged: int) -> None:
        print(f"  forged {forged}/{total} "
              f"({forged / (time.time() - t0):.0f} blocks/s)",
              file=sys.stderr)
    return log


def synth_mock_praos(args) -> dict:
    seed = args.seed.encode()

    def h(tag: bytes, i: int) -> bytes:
        return hashlib.blake2b(seed + tag + i.to_bytes(4, "big"),
                               digest_size=32).digest()

    n = args.nodes
    vrf_sks = [h(b"vrf", i) for i in range(n)]
    vrf_vks = [ed25519_ref.public_key(sk) for sk in vrf_sks]
    kes_seeds = [h(b"kes", i) for i in range(n)]
    kes_vks = [kes_mod.vk_of(args.kes_depth, s) for s in kes_seeds]
    pay_sks = [h(b"pay", i) for i in range(n)]
    pay_vks = [ed25519_ref.public_key(sk) for sk in pay_sks]

    cfg = PraosConfig(
        nodes=tuple(PraosNode(vrf_vks[i], kes_vks[i], 1) for i in range(n)),
        k=2160, f=float(Fraction(args.f)), epoch_length=args.epoch_length,
        kes_depth=args.kes_depth,
        slots_per_kes_period=max(
            1, (args.blocks * 4) // kes_mod.total_periods(args.kes_depth)))
    protocol = Praos(cfg)
    hot_keys = [HotKey(kes_mod.KesSignKey(args.kes_depth, s))
                for s in kes_seeds]

    genesis = {pay_vks[i].hex(): 10_000 for i in range(n)}
    _write_config(args.out, {
        "protocol": "mock-praos",
        "k": cfg.k, "f": cfg.f, "epoch_length": cfg.epoch_length,
        "kes_depth": cfg.kes_depth,
        "slots_per_kes_period": cfg.slots_per_kes_period,
        "nodes": [{"vrf_vk": vrf_vks[i].hex(),
                   "kes_vk": kes_vks[i].hex(), "stake": 1}
                  for i in range(n)],
        "genesis": genesis,
        "chunk_size": args.chunk_size,
    })
    db = open_out_db(IoFS(args.out), args.format, args.chunk_size,
                     args.epoch_length)

    # spendable outputs per node, seeded from the genesis pseudo-tx whose
    # outputs MockLedger indexes in sorted(vk) order
    GEN = b"\x00" * 32
    spendable: dict[int, list] = {}
    for ix, vk in enumerate(sorted(pay_vks)):
        spendable[pay_vks.index(vk)] = [(GEN, ix, 10_000)]

    state = protocol.initial_chain_dep_state()
    prev = None
    slot = 0
    forged = 0
    log = _progress(time.time(), args.blocks)
    while forged < args.blocks:
        view = None
        ticked = protocol.tick_chain_dep_state(state, view, slot)
        leader = None
        for i in range(n):
            pi = protocol.check_is_leader((i, vrf_sks[i]), slot, ticked,
                                          view)
            if pi is not None:
                leader = (i, pi)
                break
        if leader is None:
            slot += 1
            continue
        i, pi = leader
        body = []
        for t in range(args.txs_per_block):
            owner = (forged * args.txs_per_block + t) % n
            if not spendable[owner]:
                continue
            txid, ix, amount = spendable[owner].pop(0)
            tx = Tx((TxIn(txid, ix),), (TxOut(pay_vks[owner], amount),))
            sig = ed25519_ref.sign(pay_sks[owner], tx.txid)
            tx = Tx(tx.inputs, tx.outputs, ((pay_vks[owner], sig),))
            spendable[owner].append((tx.txid, 0, amount))
            body.append(tx)
        hdr = make_header(prev, slot, body, issuer=i)
        signed = praos_forge_fields(protocol, hot_keys[i], pi, hdr)
        block = ProtocolBlock(signed, tuple(body))
        _append(db, block)
        state = protocol.reupdate_chain_dep_state(ticked, signed, view)
        prev = signed
        forged += 1
        slot += 1
        if forged % 500 == 0:
            log(forged)
    if hasattr(db, "close"):
        db.close()              # flush the reference-format tail chunk
    return {"blocks": forged, "last_slot": slot - 1}


def synth_shelley(args) -> dict:
    """Forge a TPraos/Shelley chain (`chainsynth.forge_shelley`) and
    write it: the flagship replay workload.

    Reference: the Shelley chain the db-analyser validate-mainnet path
    replays (tools/db-analyser/Block/Shelley.hs + Shelley/Protocol.hs:
    433-442 PRTCL verifies per header; Ledger.hs:279-284 witnesses per
    body)."""
    ext, blocks, _state = chainsynth.forge_shelley(
        args.blocks, txs_per_block=args.txs_per_block, pools=args.pools,
        f=args.f, epoch_length=args.epoch_length,
        kes_depth=args.kes_depth, seed=args.seed.encode(),
        log=_progress(time.time(), args.blocks))
    write_chain(args.out, shelley_config(ext, args.chunk_size), blocks,
                args.format, args.epoch_length)
    return {"blocks": len(blocks), "last_slot": blocks[-1].slot}


def synth_cardano(args) -> dict:
    """Forge a chain crossing the era ladder (Byron->Shelley->Allegra->
    Mary per Cardano/Block.hs:161-186, or Byron->Shelley with
    `--eras byron-shelley`): PBFT blocks + EBBs, a Byron update proposal
    naming the Shelley fork epoch, TPraos blocks, then configured-epoch
    hops into Allegra (a validity-interval tx exercises the timelock
    gate) and Mary (a minting tx exercises multi-asset) — all through
    the combinator."""
    epoch_length = args.epoch_length
    total_epochs = max(8, args.blocks // epoch_length)
    # Byron spans >= 2 epochs so the chain contains an EBB with a same-slot
    # Byron successor (the EBB layout the storage layer must handle)
    fork_epoch = max(2, total_epochs // 4)
    if getattr(args, "eras", "ladder") == "byron-shelley":
        # the two-era chain of the streaming replay: Byron EBBs -> ONE
        # translation -> a long Shelley tail, no intra-Shelley hops — the
        # minimal shape that still crosses the hard fork mid-stream
        allegra_epoch = mary_epoch = None
    else:
        allegra_epoch = fork_epoch + max(1, total_epochs // 4)
        mary_epoch = allegra_epoch + max(1, total_epochs // 4)
    # KES periods must cover the whole chain (synth_shelley discipline):
    # cardano_setup's default 50 slots/period exhausts the depth-5 key's
    # 30 usable evolutions after ~1500 slots.  Sized here and recorded in
    # config.json so db_analyser rebuilds the identical setup.
    slots_per_kes_period = max(50, (args.blocks * 2) // 30 + 1)
    shelley_cfg = TPraosConfig(
        k=8, epoch_length=epoch_length,
        slots_per_kes_period=slots_per_kes_period,
        kes_depth=5, max_kes_evolutions=30)
    eras, rules, nodes = cardano_setup(
        args.pools, epoch_length=epoch_length,
        shelley_config=shelley_cfg, seed=args.seed.encode(),
        allegra_epoch=allegra_epoch, mary_epoch=mary_epoch)

    _write_config(args.out, {
        "protocol": "cardano", "nodes": args.pools,
        "epoch_length": epoch_length, "seed": args.seed,
        "fork_epoch": fork_epoch, "allegra_epoch": allegra_epoch,
        "mary_epoch": mary_epoch, "chunk_size": args.chunk_size,
        "slots_per_kes_period": slots_per_kes_period,
    })
    db = open_out_db(IoFS(args.out), args.format, args.chunk_size,
                     epoch_length)

    byron_era, shelley_era = eras[0], eras[1]
    state = rules.initial_state()
    prev = None
    slot = 0
    forged = 0
    update_sent = False
    # one feature tx per new era (none when the ladder stops at Shelley)
    feature_todo = ({ALLEGRA, MARY} if allegra_epoch is not None
                    else set())
    log = _progress(time.time(), args.blocks)

    while forged < args.blocks:
        view = rules.ledger.ledger_view(rules.ledger.tick(state.ledger,
                                                          slot))
        ticked_dep = rules.protocol.tick_chain_dep_state(
            state.header.chain_dep_state, view, slot)
        if ticked_dep.era == BYRON:
            if slot % epoch_length == 0 and slot > 0:
                ebb = make_ebb(prev, slot // epoch_length, epoch_length)
                ebb = ebb.with_fields(**{ERA_FIELD: BYRON})
                blk = ProtocolBlock(ebb, ())
                state = rules.tick_then_reapply(state, blk)
                _append(db, blk)
                forged += 1
                prev = ebb
            leader_ix = byron_era.protocol.slot_leader(slot)
            node = nodes[leader_ix]
            body = []
            if not update_sent:
                body.append(make_byron_tx(
                    inputs=[], outputs=[],
                    certs=[(CERT_UPDATE, fork_epoch.to_bytes(8, "big"),
                            b"")],
                    signing_keys=[node["genesis_sk"]]))
                update_sent = True
            hdr = make_header(prev, slot, body, issuer=leader_ix)
            hdr = hdr.with_fields(**{ERA_FIELD: BYRON})
            hdr = byron_sign_header(node["delegate_sk"], hdr)
            blk = ProtocolBlock(hdr, tuple(body))
        else:
            era_ix = ticked_dep.era
            lead = node = None
            for node in nodes:
                lead = shelley_era.protocol.check_is_leader(
                    node["can_be_leader"], slot, ticked_dep.inner,
                    view.inner)
                if lead is not None:
                    break
            if lead is None:
                slot += 1
                continue
            # one feature tx per era entry: Allegra's validity interval,
            # Mary's mint — spending the forger's own crossing UTxO
            body = []
            if era_ix in feature_todo:
                owner_addr = node["addr"]
                entry = next((u for u in state.ledger.inner.utxo
                              if u[2] == owner_addr and not u[4]), None)
                if entry is not None:
                    t, i, _a, amt, _assets = entry
                    if era_ix == ALLEGRA:
                        tx = make_shelley_tx(
                            inputs=[(t, i)], outputs=[(owner_addr, amt)],
                            certs=[], signing_keys=[node["keys"].addr_sk],
                            validity=(0, slot + epoch_length))
                    else:                       # MARY: mint a native asset
                        aid = pool_id_of(owner_addr)
                        tx = make_shelley_tx(
                            inputs=[(t, i)],
                            outputs=[(owner_addr, amt - 1),
                                     (owner_addr, 1, ((aid, 5),))],
                            certs=[], signing_keys=[node["keys"].addr_sk],
                            mint=[(aid, 5)])
                    body.append(tx)
                    feature_todo.discard(era_ix)
            hdr = make_header(prev, slot, body, issuer=0)
            hdr = hdr.with_fields(**{ERA_FIELD: era_ix})
            hdr = forge_tpraos_fields(shelley_era.protocol, node["hot_key"],
                                      node["can_be_leader"], lead, hdr)
            blk = ProtocolBlock(hdr, tuple(body))
        state = rules.tick_then_reapply(state, blk)
        _append(db, blk)
        prev = blk.header
        forged += 1
        slot += 1
        if forged % 500 == 0:
            log(forged)
    if hasattr(db, "close"):
        db.close()              # flush the reference-format tail chunk
    return {"blocks": forged, "last_slot": slot - 1,
            "fork_epoch": fork_epoch}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="target directory")
    ap.add_argument("--protocol", default="mock-praos",
                    choices=["mock-praos", "shelley", "cardano"])
    ap.add_argument("--blocks", type=int, default=1000)
    ap.add_argument("--txs-per-block", type=int, default=2)
    ap.add_argument("--nodes", type=int, default=4,
                    help="mock-praos forgers")
    ap.add_argument("--pools", type=int, default=2,
                    help="shelley stake pools")
    ap.add_argument("--f", default="4/5",
                    help="active slot coefficient (fraction)")
    ap.add_argument("--epoch-length", type=int, default=500)
    ap.add_argument("--kes-depth", type=int, default=10)
    ap.add_argument("--chunk-size", type=int, default=100)
    ap.add_argument("--format", default="native",
                    choices=["native", "reference"],
                    help="on-disk dialect: the CBOR-indexed ImmutableDB or "
                         "the reference .primary/.secondary layout")
    ap.add_argument("--eras", default="ladder",
                    choices=["ladder", "byron-shelley"],
                    help="cardano era span: the full "
                         "Byron->Shelley->Allegra->Mary ladder, or stop "
                         "at Shelley (the streaming-replay shape)")
    ap.add_argument("--seed", default="db-synth")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    t0 = time.time()
    if args.protocol == "shelley":
        info = synth_shelley(args)
    elif args.protocol == "cardano":
        info = synth_cardano(args)
    else:
        info = synth_mock_praos(args)
    info.update({"protocol": args.protocol, "dir": args.out,
                 "synth_secs": round(time.time() - t0, 2)})
    print(json.dumps(info))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
