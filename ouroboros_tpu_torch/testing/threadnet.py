"""ThreadNet — N full nodes in the deterministic simulator.

Reference: ouroboros-consensus-test/src/Test/ThreadNet/General.hs:204,230
(`runTestNetwork` inside `runSimOrThrow`) + Network.hs:275-344 (mesh of
real NodeKernels over in-memory channels), instantiated for mock Praos as
in ouroboros-consensus-mock-test/test/Test/ThreadNet/Praos.hs — the
reference's cheapest full-stack configuration and BASELINE.md config #1.

Each node is the real stack: MockFS → ImmutableDB/VolatileDB/LedgerDB →
ChainDB → NodeKernel with mempool, forging loop, batched-window ChainSync
clients, BlockFetch decision logic — connected by mux bearers with
configurable delay.  The umbrella property (`prop_general`, General.hs:408)
maps to ThreadNetResult checks: convergence, chain growth, no unexpected
thread failures.

Ported from `ouroboros_tpu/testing/threadnet.py` (the port imports nothing
of the JAX package). Copied up to `run_threadnet`. Left out: the chaos
section (`ChaosConfig`, `run_chaos_threadnet` and their policies), which
imports the diffusion layer, the error policy and the propagation timelines;
the port has none of them yet.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

from .. import simharness as sim
from ..chain.block import Point
from ..consensus.header_validation import AnnTip, HeaderState
from ..consensus.headers import ProtocolBlock
from ..consensus.ledger import ExtLedgerRules, ExtLedgerState
from ..consensus.mempool import Mempool
from ..consensus.protocols.praos import (
    HotKey, Praos, PraosConfig, PraosNode, PraosState, praos_forge_fields,
)
from ..crypto import ed25519_ref, kes as kes_mod
from ..crypto.backend import OpensslBackend
from ..ledgers.mock import MockLedger, MockLedgerState, Tx
from ..node import BlockForging, BlockchainTime, NodeKernel, connect_nodes
from ..storage import MockFS
from ..storage.chaindb import ChainDB
from ..utils import cbor


@dataclass
class NodeKeys:
    vrf_sk: bytes
    vrf_vk: bytes
    kes_seed: bytes
    kes_vk: bytes
    payment_sk: bytes
    payment_vk: bytes


def praos_node_keys(i: int, kes_depth: int, seed: bytes = b"threadnet"
                    ) -> NodeKeys:
    def h(tag: bytes) -> bytes:
        return hashlib.blake2b(seed + tag + i.to_bytes(4, "big"),
                               digest_size=32).digest()
    vrf_sk = h(b"vrf")
    kes_seed = h(b"kes")
    pay_sk = h(b"pay")
    return NodeKeys(
        vrf_sk=vrf_sk, vrf_vk=ed25519_ref.public_key(vrf_sk),
        kes_seed=kes_seed, kes_vk=kes_mod.vk_of(kes_depth, kes_seed),
        payment_sk=pay_sk, payment_vk=ed25519_ref.public_key(pay_sk))


@dataclass
class ThreadNetConfig:
    n_nodes: int = 3
    n_slots: int = 30
    slot_length: float = 1.0
    k: int = 10
    f: float = 0.6                   # active slot coefficient
    epoch_length: int = 100
    kes_depth: int = 7
    slots_per_kes_period: int = 10
    seed: int = 0
    link_delay: float = 0.05         # bearer one-way delay, in slots units
    join_slots: Optional[Sequence[int]] = None   # node i joins at slot[i]
    topology: str = "mesh"           # "mesh" | "ring" | "line"
    chain_sync_window: int = 8
    coin_per_node: int = 1000
    # txs submitted at (slot, node, tx_factory(keys, ledger_state)) hooks
    tx_plan: tuple = ()
    # per-node handshake network magic (default: all 0 — one network)
    network_magics: Optional[Sequence[int]] = None
    # (slot, node_ix) pairs: stop the node at `slot` and restart it from
    # its own on-disk state (NodeRestarts.hs analog — the restarted node
    # re-opens its ChainDB, replays, reconnects, and catches up)
    restart_plan: tuple = ()


@dataclass
class ThreadNetResult:
    chains: list                     # final current_chain per node
    ledgers: list                    # final ExtLedgerState per node
    keys: list                       # NodeKeys per node
    trace: list = field(default_factory=list)
    failures: list = field(default_factory=list)

    # -- prop_general checks (General.hs:408) --------------------------------
    def common_prefix_ok(self, k: int) -> bool:
        """Every pair of final chains forks at most k blocks from either
        head (the common-prefix / bounded-fork-length property)."""
        for i in range(len(self.chains)):
            for j in range(i + 1, len(self.chains)):
                a, b = self.chains[i], self.chains[j]
                isect = a.intersect(b)
                if isect is None:
                    isect_bn = a.anchor_block_no
                else:
                    blk = a.lookup(isect.hash)
                    isect_bn = blk.block_no if blk is not None \
                        else a.anchor_block_no
                for c in (a, b):
                    if c.head_block_no - isect_bn > k:
                        return False
        return True

    def max_fork_depth(self) -> int:
        """Deepest divergence among final chains: max over pairs of
        (head height - intersection height).  prop_general bounds this by
        the protocol-specific expectation (Util/Expectations.hs) — for
        honest mock Praos, end-of-run slot battles only (a few blocks)."""
        worst = 0
        for i in range(len(self.chains)):
            for j in range(i + 1, len(self.chains)):
                a, b = self.chains[i], self.chains[j]
                isect = a.intersect(b)
                if isect is None:
                    isect_bn = min(a.anchor_block_no, b.anchor_block_no)
                else:
                    blk = a.lookup(isect.hash)
                    isect_bn = blk.block_no if blk is not None \
                        else a.anchor_block_no
                worst = max(worst, a.head_block_no - isect_bn,
                            b.head_block_no - isect_bn)
        return worst

    def min_length(self) -> int:
        return min(c.head_block_no + 1 for c in self.chains)

    def max_length(self) -> int:
        return max(c.head_block_no + 1 for c in self.chains)


class PraosNetworkFactory:
    """Builds the per-node stacks for a mock-Praos network; reused by
    run_threadnet and by node-to-client / tooling tests that need one
    full node outside the ThreadNet driver."""

    def __init__(self, cfg: ThreadNetConfig):
        self.cfg = cfg
        self.keys = [praos_node_keys(i, cfg.kes_depth)
                     for i in range(cfg.n_nodes)]
        self.protocol_cfg = PraosConfig(
            nodes=tuple(PraosNode(k.vrf_vk, k.kes_vk, stake=1)
                        for k in self.keys),
            k=cfg.k, f=cfg.f, epoch_length=cfg.epoch_length,
            kes_depth=cfg.kes_depth,
            slots_per_kes_period=cfg.slots_per_kes_period)
        self.genesis = {k.payment_vk: cfg.coin_per_node for k in self.keys}
        self.backend = OpensslBackend()

    # -- codecs ---------------------------------------------------------------
    @staticmethod
    def block_decode(raw: bytes) -> ProtocolBlock:
        return ProtocolBlock.decode(cbor.loads(raw), tx_decode=Tx.decode)

    @staticmethod
    def header_decode_obj(obj):
        from ..consensus.headers import ProtocolHeader
        return ProtocolHeader.decode(obj)

    @staticmethod
    def block_decode_obj(obj):
        return ProtocolBlock.decode(obj, tx_decode=Tx.decode)

    @staticmethod
    def enc_state(ext: ExtLedgerState):
        dep: PraosState = ext.header.chain_dep_state
        tip = ext.header.tip
        return [list(ext.ledger.utxo), ext.ledger.slot,
                ext.ledger.tip.encode(),
                None if tip is None else [tip.slot, tip.block_no, tip.hash,
                                          int(tip.is_ebb)],
                [dep.epoch, dep.eta, list(dep.pending)]]

    @staticmethod
    def dec_state(obj) -> ExtLedgerState:
        utxo = tuple((bytes(e[0]), int(e[1]), bytes(e[2]), int(e[3]))
                     for e in obj[0])
        led = MockLedgerState(utxo, int(obj[1]), Point.decode(obj[2]))
        tip = None if obj[3] is None else AnnTip(
            int(obj[3][0]), int(obj[3][1]), bytes(obj[3][2]),
            bool(obj[3][3]) if len(obj[3]) > 3 else False)
        dep = PraosState(int(obj[4][0]), bytes(obj[4][1]),
                         tuple(bytes(p) for p in obj[4][2]))
        return ExtLedgerState(led, HeaderState(tip, dep))

    def make_node(self, i: int, fs=None,
                  label: Optional[str] = None) -> NodeKernel:
        """Build node i's full stack; pass its previous MockFS to model a
        RESTART — ChainDB.open then recovers from the on-disk state.
        Restarts must also pass a FRESH label: peer ids derive from it,
        and reusing the old one would collide the neighbors' per-peer
        state with the dead connection's."""
        cfg, keys = self.cfg, self.keys
        protocol = Praos(self.protocol_cfg)
        ledger = MockLedger(self.genesis)
        ext_rules = ExtLedgerRules(protocol, ledger)
        fs = fs if fs is not None else MockFS()
        db = ChainDB.open(fs, ext_rules, self.enc_state, self.dec_state,
                          self.block_decode, backend=self.backend)
        mempool = Mempool(ledger,
                          lambda db=db: (db.current_ledger.ledger,
                                         db.tip_point()),
                          backend=self.backend)
        hot_key = HotKey(kes_mod.KesSignKey(cfg.kes_depth,
                                            keys[i].kes_seed))
        forging = BlockForging(
            issuer=i, can_be_leader=(i, keys[i].vrf_sk),
            forge=lambda protocol, proof, hdr, hk=hot_key:
                praos_forge_fields(protocol, hk, proof, hdr))
        btime = BlockchainTime(cfg.slot_length)
        kern = NodeKernel(db, ledger, mempool, btime, [forging],
                          label=label or f"node{i}", backend=self.backend,
                          chain_sync_window=cfg.chain_sync_window,
                          header_decode=self.header_decode_obj,
                          block_decode_obj=self.block_decode_obj,
                          tx_decode=Tx.decode)
        if cfg.network_magics is not None:
            kern.network_magic = cfg.network_magics[i]
        kern.fs = fs                      # restartable: same disk next time
        return kern

    def forge_at(self, i: int, slot: int, ext_state) -> ProtocolBlock:
        """Forge node i's empty block at `slot` on ext_state's tip (test
        helper for out-of-band blocks, e.g. clock-skew scenarios).  Node i
        must lead the slot (use f=1.0 configs)."""
        from ..chain.block import GENESIS_HASH
        from ..consensus.headers import ProtocolHeader, body_hash_of
        protocol = Praos(self.protocol_cfg)
        ticked = protocol.tick_chain_dep_state(
            ext_state.header.chain_dep_state, None, slot)
        pi = protocol.check_is_leader((i, self.keys[i].vrf_sk), slot,
                                      ticked, None)
        assert pi is not None, f"node {i} does not lead slot {slot}"
        ann = ext_state.header.tip
        prev_hash = ann.hash if ann else GENESIS_HASH
        block_no = ann.block_no + 1 if ann else 0
        hdr = ProtocolHeader(slot=slot, block_no=block_no,
                             prev_hash=prev_hash,
                             body_hash=body_hash_of(()), issuer=i)
        hot_key = HotKey(kes_mod.KesSignKey(self.cfg.kes_depth,
                                            self.keys[i].kes_seed))
        return ProtocolBlock(praos_forge_fields(protocol, hot_key, pi, hdr),
                             ())

    def forge_chain_from(self, i: int, ext_state, n: int) -> list:
        """n connected empty blocks from ext_state's tip, one per slot."""
        protocol = Praos(self.protocol_cfg)
        ledger = MockLedger(self.genesis)
        rules = ExtLedgerRules(protocol, ledger)
        out = []
        slot = (ext_state.header.tip.slot + 1
                if ext_state.header.tip else 0)
        st = ext_state
        while len(out) < n:
            blk = self.forge_at(i, slot, st)
            st = rules.tick_then_reapply(st, blk)
            out.append(blk)
            slot += 1
        return out


def run_threadnet(cfg: ThreadNetConfig) -> ThreadNetResult:
    """Run the network to n_slots and collect final chains (runTestNetwork)."""
    factory = PraosNetworkFactory(cfg)
    keys = factory.keys
    kernels: list[NodeKernel] = []
    make_node = factory.make_node

    def edges() -> list[tuple[int, int]]:
        n = cfg.n_nodes
        if cfg.topology == "mesh":
            return [(i, j) for i in range(n) for j in range(i + 1, n)]
        if cfg.topology == "ring":
            return [(i, (i + 1) % n) for i in range(n)] if n > 2 else \
                   [(0, 1)]
        if cfg.topology == "line":
            return [(i, i + 1) for i in range(n - 1)]
        raise ValueError(cfg.topology)

    result = ThreadNetResult([], [], keys)

    async def main():
        join = cfg.join_slots or [0] * cfg.n_nodes
        started: dict[int, NodeKernel] = {}
        wired: set[tuple[int, int]] = set()

        async def start_node(i: int):
            at = join[i] * cfg.slot_length
            if at > sim.now():
                await sim.sleep(at - sim.now())
            kern = make_node(i)
            kernels.append(kern)
            started[i] = kern
            kern.start()
            for a, b in edges():
                if a in started and b in started and (a, b) not in wired:
                    wired.add((a, b))
                    connect_nodes(started[a], started[b],
                                  delay=cfg.link_delay * cfg.slot_length)

        starters = [sim.spawn(start_node(i), label=f"start-{i}")
                    for i in range(cfg.n_nodes)]
        for s in starters:
            await s.wait()

        # plan tasks are supervised (polled at snapshot time below): a
        # fire-and-forget fork would swallow a failed submit/restart and
        # the run would pass on a net that never saw its planned events
        plan_tasks: list = []
        for slot, node_ix, tx_factory in cfg.tx_plan:
            async def submit(slot=slot, node_ix=node_ix,
                             tx_factory=tx_factory):
                at = slot * cfg.slot_length
                if at > sim.now():
                    await sim.sleep(at - sim.now())
                kern = started[node_ix]
                tx = tx_factory(keys, kern.chain_db.current_ledger.ledger)
                kern.mempool.try_add_txs([tx])
            plan_tasks.append(sim.spawn(submit(), label=f"tx@{slot}"))

        for slot, node_ix in cfg.restart_plan:
            async def restart(slot=slot, node_ix=node_ix):
                at = slot * cfg.slot_length
                if at > sim.now():
                    await sim.sleep(at - sim.now())
                old = started[node_ix]
                old.stop()
                fs = old.fs
                await sim.sleep(0.5 * cfg.slot_length)   # downtime
                # recover from disk, under a FRESH label: peer ids derive
                # from labels, and reusing the old one would collide the
                # neighbors' per-peer state with the dead connection's
                kern = make_node(node_ix, fs=fs,
                                 label=f"{old.label}r")
                kernels.append(kern)
                started[node_ix] = kern
                kern.start()
                for a, b in edges():
                    if node_ix in (a, b) and a in started and b in started:
                        connect_nodes(started[a], started[b],
                                      delay=cfg.link_delay
                                      * cfg.slot_length)
            plan_tasks.append(sim.spawn(restart(),
                                        label=f"restart-{node_ix}@{slot}"))

        await sim.sleep(cfg.n_slots * cfg.slot_length - sim.now()
                        + 2 * cfg.slot_length)
        for t in plan_tasks:
            try:
                if not t.done:
                    # poll() returns None for blocked AND for done-with-
                    # None; a plan task still parked at snapshot time is
                    # a planned event the net never saw — a failure
                    result.failures.append(
                        ("plan", t.label, "still blocked at snapshot"))
                else:
                    t.poll()
            except BaseException as e:
                result.failures.append(("plan", t.label, e))
        # settle: let in-flight messages drain with the clock stopped for
        # forging (no new slots matter; we just stop the world)
        for kern in started.values():
            result.chains.append(kern.chain_db.current_chain.copy())
            result.ledgers.append(kern.chain_db.current_ledger)
            for t in kern._threads:
                try:
                    t.poll()
                except sim.AsyncCancelled:
                    pass
                except BaseException as e:
                    result.failures.append((kern.label, t.label, e))
            kern.stop()

    sim.run(main(), seed=cfg.seed)
    return result
