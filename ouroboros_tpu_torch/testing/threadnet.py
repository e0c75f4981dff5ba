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
of the JAX package). Copied whole, with the chaos section
(`ChaosConfig`, `run_chaos_threadnet` and their policies).
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


# ---------------------------------------------------------------------------
# Chaos ThreadNet — the Praos network under a seeded FaultPlan
# ---------------------------------------------------------------------------
#
# Reference shape: the io-sim fault exploration of the reference test suites
# (attenuated bearers / AbsBearerInfo in ouroboros-network-framework's sim
# tests) composed with ThreadNet's prop_general checks.  Nodes are wired
# through diffusion.py's subscription layer (NOT the static mesh), so a
# connection killed by a fault or watchdog is *suspended* by the error
# policy (demotion) and *redialled* after backoff (re-promotion) — the
# recovery loop this harness exists to exercise.

from ..network.error_policy import (          # noqa: E402  (section import)
    default_node_policies,
)
from ..node.diffusion import SimNetwork, run_sim_diffusion  # noqa: E402
from ..node.watchdog import NodeTimeLimits    # noqa: E402
from ..observe import netmetrics as _netmetrics             # noqa: E402
from ..observe.propagation import FleetTelemetry            # noqa: E402
from ..simharness import FaultPlan, FaultSpec, Partition    # noqa: E402


def chaos_error_policies(scale: float = 1.0) -> list:
    """The REAL policy set (default_node_policies) with durations scaled
    to chaos-sim time — the production 200 s/60 s windows would outlast a
    40-slot run."""
    return default_node_policies(violation=8.0 * scale,
                                 transport=4.0 * scale,
                                 unknown=6.0 * scale)


def chaos_time_limits() -> NodeTimeLimits:
    """Watchdog limits scaled to the chaos net's 1 s slots (same ratios as
    the production defaults in node/watchdog.py)."""
    # must_reply stays ~7x the expected block interval (reference ratio:
    # 135 s against ~20 s blocks) — tighter and a healthy-but-quiet
    # producer gets spuriously killed during the settle window
    return NodeTimeLimits(
        chain_sync_short=3.0, chain_sync_must_reply=20.0,
        keep_alive_timeout=3.0, block_fetch_busy=6.0,
        fetch_deadline_floor=1.5, fetch_deadline_mult=4.0,
        handshake_timeout=3.0)


@dataclass
class ChaosConfig:
    """One chaos run: a ThreadNetConfig + the hostility applied to it.

    The FaultSpec/Partition fields (not a FaultPlan instance) keep the
    config pure data — run_chaos_threadnet builds a FRESH plan per run, so
    replaying the same config replays the identical fault schedule."""
    net: ThreadNetConfig = field(default_factory=ThreadNetConfig)
    spec: FaultSpec = field(default_factory=FaultSpec)
    partitions: tuple = ()               # Partition over node labels
    base_backoff: float = 2.0
    keepalive_interval: float = 2.0
    settle_slots: int = 4
    time_limits: NodeTimeLimits = field(default_factory=chaos_time_limits)
    # slot after which per-message hostility stops (None = hostile through
    # the settle window too).  Default: faults run for the measured
    # n_slots, then the settle window is clean — the ThreadNet
    # partition-heals-then-net-converges shape, so the final-chain
    # common-prefix check judges recovery, not mid-fault luck.
    fault_until_slot: Optional[int] = -1     # -1 -> net.n_slots
    # multiplier on chaos_error_policies' suspension windows: the max
    # escalated backoff must fit inside the settle window or a peer
    # suspended in the hostile tail never rejoins before the snapshot
    error_scale: float = 1.0


@dataclass
class ChaosResult(ThreadNetResult):
    """ThreadNetResult + the observability a chaos run is judged on."""
    seed: int = 0
    fault_events: list = field(default_factory=list)   # plan.events
    workers: list = field(default_factory=list)        # SubscriptionWorkers
    race_report: Optional[object] = None   # RaceReport under explore=K
    # the merged FleetTelemetry report: adoption quantiles,
    # per-edge delivery latency, partition healing, per-peer mux bytes —
    # byte-identical (sort_keys JSON) across replays of one seed
    fleet: Optional[dict] = None

    # -- trace views ---------------------------------------------------------
    def _events(self, label: str) -> list:
        # trace_event(payload, label) records the label in SimEvent.kind
        # (the `label` field is the emitting thread's, always "user" here)
        return [e for e in self.trace if e.kind == label]

    def watchdog_events(self) -> list:
        """Every per-state timeout + the kills it caused."""
        return self._events("watchdog")

    def suspensions(self) -> list:
        """(time, worker, addr, kind, duration, fail_count) demotions."""
        return [(e.time, e.payload[0], *e.payload[2:])
                for e in self._events("subscription")
                if e.payload[1] == "suspend"]

    def demoted_then_repromoted(self) -> list:
        """Addresses that were suspended (demoted) and later redialled
        (re-promoted) by the subscription layer — the recovery loop's
        end-to-end evidence, readable from the trace alone."""
        suspended_at: dict = {}
        recovered = []
        for e in self._events("subscription"):
            worker, kind = e.payload[0], e.payload[1]
            addr = e.payload[2]
            key = (worker, addr)
            if kind == "suspend":
                suspended_at.setdefault(key, e.time)
            elif kind == "dial" and key in suspended_at \
                    and e.time > suspended_at[key] and addr not in recovered:
                recovered.append(addr)
        return recovered

    def trace_tail(self, n: int = 40) -> str:
        """The reproduction blurb chaos test failures print: seed + the
        last n sim-trace events."""
        tail = "\n".join(repr(e) for e in self.trace[-n:])
        return (f"fault plan seed={self.seed} — rerun with this seed to "
                f"reproduce; sim trace tail:\n{tail}")


# TVar labels whose races are tolerated during chaos exploration, with
# the justification readable next to the suppression (the ouro-lint
# baseline discipline applied to dynamic findings).  Patterns are
# fnmatch globs over the TVar label.
#
# Everything here is an ORDER-INSENSITIVE access pattern: in the
# cooperative runtime a sync block is atomic regardless of schedule, so
# an unordered pair is only a bug when the two orders produce different
# outcomes.  Monotone counters, one-way latches and re-validated peeks
# commute; anything NOT matching these globs blocks the exploration
# gate (tests/test_races.py).
CHAOS_RACE_TOLERATED = {
    "current-slot": "monotonic slot counter: readers peek the current "
                    "slot and tolerate being one tick stale by design "
                    "(the reference reads the slot clock non-atomically "
                    "too); torn reads are impossible in the cooperative "
                    "sim",
    "*-fetch-wakeup": "edge-triggered poke counter: concurrent pokes "
                      "coalesce and the fetch-logic loop re-reads the "
                      "full decision state after every wake, so a lost "
                      "increment only costs one extra (idempotent) "
                      "decision pass",
    "*-chain-version": "monotonic version counter poked from the ChainDB "
                       "writer thread; followers re-validate against the "
                       "real chain after waking, so stale peeks are "
                       "self-healing",
    "mempool-version": "same monotone version-counter shape as "
                       "chain-version: watchers re-snapshot the mempool "
                       "after every wake",
    "chaindb-add-queue": "wake counter for the single add-block writer "
                         "thread: the runner drains the whole queue "
                         "after every wake and re-checks before "
                         "blocking, so a coalesced increment is "
                         "absorbed by the drain loop",
    "fetch-req-*": "block_fetch._queued's documented non-transactional "
                   "peek of the per-peer request queue: the decision "
                   "loop re-runs on every fetch-wakeup poke, so a "
                   "stale snapshot costs one extra decision pass, "
                   "never a lost request",
    "*.closed": "mux teardown latch: one-way False->True flips commute "
                "(concurrent stop() calls are idempotent) and readers "
                "racing the flip either see open and get woken by the "
                "notify, or see closed",
    "*.chanver": "mux ingress version counter: monotone, bumped per "
                 "delivered SDU; channel readers re-check decodability "
                 "under STM after every wake",
}


def _chaos_setup(cfg: ChaosConfig):
    """Fresh per-run state + the program coroutine factory.  Exploration
    re-runs the SAME config under perturbed schedules, and every schedule
    must get its own kernels/plan/result — sim programs are not
    re-runnable."""
    factory = PraosNetworkFactory(cfg.net)
    net = cfg.net
    until_slot = net.n_slots if cfg.fault_until_slot == -1 \
        else cfg.fault_until_slot
    plan = FaultPlan(net.seed, cfg.spec, cfg.partitions,
                     until=None if until_slot is None
                     else until_slot * net.slot_length)
    result = ChaosResult([], [], factory.keys, seed=net.seed)

    def neighbors(i: int) -> list:
        if net.topology == "mesh":
            return [j for j in range(net.n_nodes) if j != i]
        if net.topology == "ring":
            return sorted({(i - 1) % net.n_nodes, (i + 1) % net.n_nodes}
                          - {i})
        if net.topology == "line":
            return [j for j in (i - 1, i + 1) if 0 <= j < net.n_nodes]
        raise ValueError(net.topology)

    async def main():
        # fresh fleet-accounting scope: MuxIO totals born in THIS run are
        # what the fleet report folds, so two replays of one seed report
        # identical per-peer bytes
        _netmetrics.reset_run_scope()
        fleet = FleetTelemetry(partitions=cfg.partitions)
        network = SimNetwork(
            link_delay=net.link_delay * net.slot_length,
            fault_plan=plan)
        kernels = [factory.make_node(i) for i in range(net.n_nodes)]
        # every address must be listening before any worker dials, or the
        # startup order would masquerade as connection failures
        for i, kern in enumerate(kernels):
            kern.propagation = fleet.tracker(kern.label)
            network.listen(f"addr{i}", kern)
        worker_threads = []
        for i, kern in enumerate(kernels):
            kern.time_limits = cfg.time_limits
            kern.keepalive_interval = cfg.keepalive_interval
            kern.start()
            d = run_sim_diffusion(
                kern, network, f"addr{i}",
                ip_targets=[f"addr{j}" for j in neighbors(i)],
                valency=len(neighbors(i)),
                error_policies=chaos_error_policies(cfg.error_scale),
                base_backoff=cfg.base_backoff, seed=net.seed)
            result.workers.extend(d.workers)
            worker_threads.extend(d.threads)
        await sim.sleep(net.n_slots * net.slot_length
                        + cfg.settle_slots * net.slot_length)
        for kern in kernels:
            result.chains.append(kern.chain_db.current_chain.copy())
            result.ledgers.append(kern.chain_db.current_ledger)
        for t in worker_threads:
            try:
                t.poll()
            except sim.AsyncCancelled:
                pass
            except BaseException as e:   # a THROW verdict or worker bug
                result.failures.append(("subscription", t.label, e))
        result.fleet = fleet.report()
        for kern in kernels:
            kern.stop()

    return plan, result, main


def run_chaos_threadnet(cfg: ChaosConfig, explore: int = 0,
                        tolerate=None) -> ChaosResult:
    """Run the Praos network under cfg's FaultPlan, wired through the
    subscription/diffusion layer so faulted peers are demoted (error-policy
    suspension) and re-promoted (redial) instead of staying dead.

    Deterministic end to end: the plan, the scheduler, the subscription
    jitter and every watchdog all derive from cfg.net.seed, so two runs of
    the same config produce byte-identical sim traces.

    explore=K additionally attaches the happens-before race detector
    (simharness/race.py) to the measured run — which IS exploration
    schedule 0, the production FIFO schedule — and re-runs the same
    config under K-1 further seeded schedule perturbations, returning
    the RaceReport on ``result.race_report``.  `tolerate` overrides the
    default CHAOS_RACE_TOLERATED label globs (each documented above)."""
    plan, result, main = _chaos_setup(cfg)
    det0 = sim.RaceDetector(schedule_index=0) if explore > 0 else None
    measured = sim.Sim(seed=cfg.net.seed, collect_trace=True, race=det0)
    try:
        measured.run(main())
    except BaseException as e:
        # crash-proof evidence: when the flight recorder is
        # armed, a failing chaos run dumps the sim trace tail alongside
        # whatever spans/metric deltas the ring already holds.  All
        # timestamps are VIRTUAL sim time, so the same seed dumps
        # byte-identical files on every replay of the failure.
        from ..observe import flight as _flight
        if _flight.FLIGHT.armed:
            # the sim has already exited (its runtime is detached), so
            # each event carries its OWN virtual time — stamping with
            # monotonic_now() here would leak wall clock into the dump
            for ev in getattr(measured, "_trace", [])[-256:]:
                _flight.FLIGHT.note(ev, t=ev.time)
            _flight.FLIGHT.dump_on_failure(
                f"chaos threadnet seed={cfg.net.seed}: {e!r}")
        raise
    result.trace = measured._trace
    result.fault_events = list(plan.events)
    if explore > 0:
        def make_program():
            _plan, _result, fresh_main = _chaos_setup(cfg)
            return fresh_main()
        controller = sim.ScheduleController(
            make_program, k=explore, seed=cfg.net.seed,
            tolerate=tuple(CHAOS_RACE_TOLERATED
                           if tolerate is None else tolerate))
        # the measured FIFO run doubles as schedule 0: re-running it
        # would be byte-identical wasted wall-clock
        result.race_report = controller.explore(pre_collected=[det0],
                                                start=1)
    return result
