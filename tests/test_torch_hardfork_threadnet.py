"""Cross-era ThreadNet on the port: the cases of
tests/test_hardfork_threadnet.py on `ouroboros_tpu_torch` (CppBackend
where the reference used OpensslBackend), then the same network (BFT into
mock Praos with a faster slot) driven in both packages at the same seed:
every node's block hashes, era tags and encoded final ExtLedgerState
equal.  Tolerance: none.

Cross-era ThreadNet: a full network lives through a hard fork.

Reference: ouroboros-consensus-cardano-test/test/Test/ThreadNet/Cardano.hs
(nodes cross Byron(PBFT)→Shelley(Praos) mid-run, slot lengths change at the
boundary) — SURVEY.md §4.1's cross-era HFC runs.
"""
import importlib
import sys
import hashlib

import pytest

from ouroboros_tpu_torch import simharness as sim
from ouroboros_tpu_torch.chain.block import Point
from ouroboros_tpu_torch.consensus.hardfork import (
    Era, EraParams, hard_fork_rules,
)
from ouroboros_tpu_torch.consensus.hardfork.combinator import (
    ERA_FIELD, HardForkState, hfc_forge,
)
from ouroboros_tpu_torch.consensus.header_validation import AnnTip, HeaderState
from ouroboros_tpu_torch.consensus.headers import ProtocolBlock
from ouroboros_tpu_torch.consensus.ledger import ExtLedgerState
from ouroboros_tpu_torch.consensus.mempool import Mempool
from ouroboros_tpu_torch.consensus.protocols import Bft, bft_sign_header
from ouroboros_tpu_torch.consensus.protocols.praos import (
    HotKey, Praos, PraosConfig, PraosNode, PraosState, praos_forge_fields,
)
from ouroboros_tpu_torch.crypto import ed25519_ref, kes as kes_mod
from ouroboros_tpu_torch.crypto.cpp_backend import CppBackend
from ouroboros_tpu_torch.ledgers.mock import MockLedger, MockLedgerState, Tx
from ouroboros_tpu_torch.node import BlockForging, NodeKernel, connect_nodes
from ouroboros_tpu_torch.node.blockchain_time import HardForkBlockchainTime
from ouroboros_tpu_torch.storage import MockFS
from ouroboros_tpu_torch.storage.chaindb import ChainDB
from ouroboros_tpu_torch.utils import cbor

N_NODES = 3
EPOCH = 10
TRANSITION_EPOCH = 2                   # era boundary at slot 20
KES_DEPTH = 5
BACKEND = CppBackend()


def _mk(tag, i):
    return hashlib.blake2b(b"hfc-net" + tag + bytes([i]),
                           digest_size=32).digest()


def _network_setup():
    sks = [_mk(b"sig", i) for i in range(N_NODES)]
    vks = [ed25519_ref.public_key(sk) for sk in sks]
    vrf_sks = [_mk(b"vrf", i) for i in range(N_NODES)]
    vrf_vks = [ed25519_ref.public_key(sk) for sk in vrf_sks]
    kes_seeds = [_mk(b"kes", i) for i in range(N_NODES)]
    kes_vks = [kes_mod.vk_of(KES_DEPTH, s) for s in kes_seeds]
    genesis = {vk: 100 for vk in vks}

    bft = Bft(vks, k=8)
    praos = Praos(PraosConfig(
        nodes=tuple(PraosNode(vrf_vks[i], kes_vks[i], 1)
                    for i in range(N_NODES)),
        k=8, f=0.7, epoch_length=EPOCH, kes_depth=KES_DEPTH,
        slots_per_kes_period=50))
    eras = [
        Era("bft", bft, MockLedger(genesis), EraParams(EPOCH, 1.0),
            transition_epoch=lambda st: TRANSITION_EPOCH,
            translate_chain_dep=lambda s: PraosState.genesis()),
        # the new era runs FASTER: 0.5s slots (the Cardano slot-length
        # change at the Shelley fork)
        Era("praos", praos, MockLedger(genesis), EraParams(EPOCH, 0.5)),
    ]
    return eras, dict(sks=sks, vrf_sks=vrf_sks, kes_seeds=kes_seeds)


def _enc_state(ext):
    def enc_hf(hf, enc_inner):
        return [hf.era, enc_inner(hf.inner), list(hf.transitions)]

    def enc_led(led):
        return [list(led.utxo), led.slot, led.tip.encode()]

    def enc_dep(dep):
        if dep == ():
            return None
        return [dep.epoch, dep.eta, list(dep.pending)]
    tip = ext.header.tip
    return [enc_hf(ext.ledger, enc_led),
            None if tip is None else [tip.slot, tip.block_no, tip.hash],
            enc_hf(ext.header.chain_dep_state, enc_dep)]


def _dec_state(obj):
    def dec_led(o):
        utxo = tuple((bytes(e[0]), int(e[1]), bytes(e[2]), int(e[3]))
                     for e in o[0])
        return MockLedgerState(utxo, int(o[1]), Point.decode(o[2]))

    def dec_dep(o):
        if o is None:
            return ()
        return PraosState(int(o[0]), bytes(o[1]),
                          tuple(bytes(p) for p in o[2]))

    def dec_hf(o, dec_inner):
        return HardForkState(int(o[0]), dec_inner(o[1]),
                             tuple(int(t) for t in o[2]))
    led = dec_hf(obj[0], dec_led)
    tip = None if obj[1] is None else AnnTip(int(obj[1][0]),
                                             int(obj[1][1]),
                                             bytes(obj[1][2]))
    dep = dec_hf(obj[2], dec_dep)
    return ExtLedgerState(led, HeaderState(tip, dep))


def _block_decode(raw):
    return ProtocolBlock.decode(cbor.loads(raw), tx_decode=Tx.decode)


def _make_node(i, eras, keys):
    rules = hard_fork_rules(eras)
    fs = MockFS()
    db = ChainDB.open(fs, rules, _enc_state, _dec_state, _block_decode,
                      backend=BACKEND)
    ledger = rules.ledger
    mempool = Mempool(ledger, lambda db=db: (db.current_ledger.ledger,
                                             db.tip_point()),
                      backend=BACKEND)
    hot_key = HotKey(kes_mod.KesSignKey(KES_DEPTH, keys["kes_seeds"][i]))
    forging = BlockForging(
        issuer=i,
        can_be_leader={0: i, 1: (i, keys["vrf_sks"][i])},
        forge=hfc_forge(eras, {
            0: lambda p, proof, hdr, i=i: bft_sign_header(keys["sks"][i],
                                                          hdr),
            1: lambda p, proof, hdr, hk=hot_key: praos_forge_fields(
                p, hk, proof, hdr),
        }))
    btime = HardForkBlockchainTime(
        lambda db=db, ledger=ledger:
            ledger.summary(db.current_ledger.ledger))
    from ouroboros_tpu_torch.consensus.headers import ProtocolHeader
    return NodeKernel(
        db, ledger, mempool, btime, [forging], label=f"hfc{i}",
        backend=BACKEND, chain_sync_window=8,
        header_decode=ProtocolHeader.decode,
        block_decode_obj=lambda o: ProtocolBlock.decode(
            o, tx_decode=Tx.decode),
        tx_decode=Tx.decode)


def test_network_crosses_hard_fork():
    eras, keys = _network_setup()

    async def main():
        kernels = [_make_node(i, eras, keys) for i in range(N_NODES)]
        for k in kernels:
            k.start()
        for i in range(N_NODES):
            for j in range(i + 1, N_NODES):
                connect_nodes(kernels[i], kernels[j], delay=0.02)
        # era 0: slots 0..19 at 1s = 20s; then 0.5s slots.  Run to ~slot 40.
        await sim.sleep(20.0 + 10.0 + 1.0)
        out = []
        for k in kernels:
            chain = k.chain_db.current_chain.copy()
            # include the immutable prefix era tags
            imm_tags = []
            for entry, raw in k.chain_db.immutable.stream():
                imm_tags.append(_block_decode(raw).header.get(ERA_FIELD))
            out.append((chain, imm_tags, k.chain_db.current_ledger))
            for t in k._threads:
                try:
                    t.poll()
                except sim.AsyncCancelled:
                    pass
                except BaseException as e:
                    raise AssertionError(
                        f"{k.label}/{t.label} failed: {e!r}") from e
            k.stop()
        return out

    results = sim.run(main(), seed=17)
    for chain, imm_tags, ext in results:
        tags = imm_tags + [b.header.get(ERA_FIELD) for b in chain.blocks]
        assert 0 in tags, "no era-0 blocks"
        assert 1 in tags, "network never crossed the fork"
        assert tags == sorted(tags), f"era tags not monotone: {tags}"
        assert ext.ledger.era == 1
        assert ext.ledger.transitions == (TRANSITION_EPOCH,)
        # era-1 slots must be ≥ 20 (the boundary slot)
        era1_slots = [b.slot for b in chain.blocks
                      if b.header.get(ERA_FIELD) == 1]
        assert all(s >= 20 for s in era1_slots)
    # convergence: all nodes on the same chain within a couple of blocks
    heads = [c.head_block_no for c, _, _ in results]
    assert max(heads) - min(heads) <= 2
    assert min(heads) >= 10


def test_faster_era_increases_block_rate():
    """After the fork the 0.5s slots should roughly double the block rate
    per wall-clock second (the point of per-era slot lengths)."""
    eras, keys = _network_setup()

    async def main():
        kern = _make_node(0, eras, keys)
        kern.start()
        await sim.sleep(40.0)        # era0: 20s (20 slots), era1: 20s (40)
        chain_blocks = list(kern.chain_db.current_chain.blocks)
        imm = [_block_decode(raw) for _, raw in
               kern.chain_db.immutable.stream()]
        kern.stop()
        return imm + chain_blocks

    blocks = sim.run(main(), seed=18)
    era0 = [b for b in blocks if b.header.get(ERA_FIELD) == 0]
    era1 = [b for b in blocks if b.header.get(ERA_FIELD) == 1]
    # era 0: 20 wall seconds, 20 slots; era 1: 20 wall seconds, 40 slots.
    # BFT leads every slot; praos f=0.7 — expect era1 count > era0 count.
    assert len(era1) > len(era0)


# -- parity with the JAX package ------------------------------------------

def _network(m, seed: int) -> list:
    """test_network_crosses_hard_fork's network built from module `m`
    (this one, or tests/test_hardfork_threadnet.py for the JAX package):
    per node its block hashes (the immutable prefix's first), their era
    tags and its final ExtLedgerState as `m._enc_state`'s CBOR bytes."""
    eras, keys = m._network_setup()

    async def main():
        kernels = [m._make_node(i, eras, keys) for i in range(m.N_NODES)]
        for k in kernels:
            k.start()
        for i in range(m.N_NODES):
            for j in range(i + 1, m.N_NODES):
                m.connect_nodes(kernels[i], kernels[j], delay=0.02)
        await m.sim.sleep(20.0 + 10.0 + 1.0)
        out = []
        for k in kernels:
            blocks = [m._block_decode(raw)
                      for _e, raw in k.chain_db.immutable.stream()]
            blocks += list(k.chain_db.current_chain.blocks)
            out.append(([b.hash for b in blocks],
                        [b.header.get(m.ERA_FIELD) for b in blocks],
                        m.cbor.dumps(m._enc_state(
                            k.chain_db.current_ledger))))
            k.stop()
        return out

    return m.sim.run(main(), seed=seed)


def test_network_equals_the_jax_packages():
    ref = importlib.import_module("test_hardfork_threadnet")
    ours = _network(sys.modules[__name__], 17)
    assert ours == _network(ref, 17)
    assert all(0 in tags and 1 in tags for _h, tags, _s in ours)
