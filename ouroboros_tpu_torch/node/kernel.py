"""NodeKernel — ties ChainDB, mempool, forging, and peers together.

Reference: ouroboros-consensus/src/Ouroboros/Consensus/NodeKernel.hs:87
(`NodeKernel` record), :139-175 (initNodeKernel forks block-forging threads
+ BlockFetch logic + candidate-fragment map), :344-496 (the forging loop:
slot tick → checkShouldForge → mempool snapshot → forgeBlock →
addBlockAsync), plus the connection assembly of Network/NodeToNode.hs
(mkApps: per-protocol handlers over one mux bearer, protocol numbers
chainsync=2 blockfetch=3 txsubmission=4 — NodeToNode.hs:211,382).

Ported from `ouroboros_tpu/node/kernel.py` (the port imports nothing of the
JAX package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from .. import simharness as sim
from ..chain.block import GENESIS_HASH
from ..consensus.headers import ProtocolBlock, ProtocolHeader, body_hash_of
from ..consensus.mempool import Mempool
from ..network.mux import (
    INITIATOR, RESPONDER, CodecChannel, Mux, bearer_pair,
)
from ..network import node_to_node as n2n
from ..network.deltaq import PeerGSVTracker
from ..network.protocols import blockfetch as bf_proto
from ..network.protocols import chainsync as cs_proto
from ..network.protocols import handshake as hs_proto
from ..network.protocols import keepalive as ka_proto
from ..network.protocols import txsubmission as tx_proto
from ..network.typed import CLIENT, PipelinedSession, SERVER, Session
from ..observe import metrics as _metrics
from ..simharness import TVar
from .block_fetch import (
    PeerFetchState, block_fetch_client, block_fetch_server, fetch_logic_loop,
)
from .blockchain_time import BlockchainTime
from .chain_sync import CandidateState, chain_sync_client, chain_sync_server
from .tx_submission import (TxInboundProtocolError, tx_inbound_loop,
                            tx_outbound_loop)
from .watchdog import KeepAliveTimeout, NodeTimeLimits, WatchdogTimeout

# protocol numbers per NodeToNode.hs:211-212 (handshake=0, chainsync=2,
# blockfetch=3, txsubmission=4, keepalive=8)
CHAINSYNC_NUM, BLOCKFETCH_NUM, TXSUBMISSION_NUM, KEEPALIVE_NUM = 2, 3, 4, 8

# whole-negotiation latency (the net.rtt.* namespace)
_HANDSHAKE_SECS = _metrics.latency_histogram("net.rtt.handshake_secs")


@dataclass
class BlockForging:
    """One forging credential (Block/Forging.hs:81-183).

    forge(protocol, is_leader_proof, header) -> signed header."""
    issuer: int
    can_be_leader: Any
    forge: Callable


class NodeKernel:
    """One node: storage + mempool + forging + peer connections."""

    def __init__(self, chain_db, ledger_rules, mempool: Optional[Mempool],
                 btime: BlockchainTime, forgings=(), label: str = "node",
                 backend=None, chain_sync_window: int = 32,
                 header_decode=None, block_decode_obj=None, tx_decode=None,
                 tracers=None, time_limits: Optional[NodeTimeLimits] = None,
                 verify_service=None):
        from ..utils.tracer import NodeTracers
        self.chain_db = chain_db
        self.ledger_rules = ledger_rules
        self.protocol = chain_db.ext_rules.protocol
        self.mempool = mempool
        self.btime = btime
        self.forgings = list(forgings)
        self.label = label
        self.backend = backend
        # adaptive batching service (crypto/batching.py): when attached,
        # sub-window ChainSync flushes (the caught-up batch-of-1 regime)
        # and mempool admission coalesce their proofs through it instead
        # of dispatching alone
        self.verify_service = verify_service
        if mempool is not None and verify_service is not None \
                and mempool.verify_service is None:
            mempool.verify_service = verify_service
        self.chain_sync_window = chain_sync_window
        self.header_decode = header_decode
        self.block_decode_obj = block_decode_obj
        self.tx_decode = tx_decode
        # per-subsystem typed tracer bundle (Node/Tracers.hs:51-62)
        self.tracers = tracers if tracers is not None else NodeTracers.nop()

        self.candidates: Dict[object, CandidateState] = {}
        self.peer_fetch: Dict[object, PeerFetchState] = {}
        self.peer_gsv: Dict[object, PeerGSVTracker] = {}
        # block-propagation lifecycle tracker (observe/propagation.py):
        # attached by the fleet harness (threadnet) or an operator; None
        # = zero per-block bookkeeping
        self.propagation = None
        self.keepalive_interval = 10.0
        # per-state protocol watchdogs (timeLimits*; node/watchdog.py)
        self.time_limits = time_limits if time_limits is not None \
            else NodeTimeLimits()
        self.network_magic = 0
        self.fetch_wakeup = TVar(0, label=f"{label}-fetch-wakeup")
        self._fetch_v = 0
        self._threads: list = []

        # STM hook for followers / servers blocking on chain changes
        chain_db.version_tvar = TVar(chain_db.version,
                                     label=f"{label}-chain-version")
        chain_db.on_change(self._on_chain_change)

    # -- wiring ---------------------------------------------------------------
    def _on_chain_change(self) -> None:
        try:
            self.chain_db.version_tvar.set_notify(self.chain_db.version)
        except Exception:
            self.chain_db.version_tvar._value = self.chain_db.version
        prop = self.propagation
        if prop is not None:
            # stamp every newly adopted block (walk back from the head;
            # the first already-stamped hash ends the new suffix)
            for b in reversed(self.chain_db.current_chain.blocks):
                if not prop.mark("adopted", b.hash):
                    break
        if self.mempool is not None:
            self.mempool.sync_with_ledger()
        self.poke_fetch_logic()

    def poke_fetch_logic(self) -> None:
        self._fetch_v += 1
        try:
            self.fetch_wakeup.set_notify(self._fetch_v)
        except Exception:
            self.fetch_wakeup._value = self._fetch_v

    def ledger_view(self):
        return self.ledger_rules.ledger_view(self.chain_db.current_ledger.ledger)

    def forecast_view(self, slot: int):
        """View forecast at `slot` from the current tip (cross-era aware);
        raises OutsideForecastRange past the stability horizon."""
        return self.ledger_rules.forecast_view(
            self.chain_db.current_ledger.ledger, slot)

    def have_block(self, h: bytes) -> bool:
        """Stored, queued for the writer thread, or buffered as a future
        block — all count as "have" so fetch decisions never re-request
        them (the reference's getIsFetched includes cdbBlocksToAdd)."""
        db = self.chain_db
        return (db.volatile.block_info(h) is not None
                or h in db.immutable
                or h in db.future_blocks
                or any(b.hash == h for b in db._add_queue))

    def plausible_candidate(self, frag) -> bool:
        """Would we prefer this candidate over our current chain?
        (Decision.hs plausible-candidates filter; select-view comparison.)"""
        head = frag.head
        if head is None:
            return False
        cur = self.chain_db.current_chain
        cur_head = cur.head
        if cur_head is None:
            # an empty fragment has no header to project: only its block
            # number is known (a bare int is no SelectView of TPraos, so
            # it must not reach prefer_candidate; ChainDB._beats_current
            # keeps the same rule), and every protocol prefers the longer
            # chain first
            return head.block_no > cur.head_block_no
        return self.protocol.prefer_candidate(
            self.protocol.select_view(cur_head.header),
            self.protocol.select_view(head))

    def add_fetched_block(self, block) -> None:
        """Fetched blocks go through the async queue — chain selection
        runs only on the ChainDB writer thread (addBlockAsync,
        BlockFetch.hs:169)."""
        self.chain_db.add_block_async(block)

    def new_candidate(self, peer_id) -> CandidateState:
        c = CandidateState(peer_id)
        orig = c.publish

        def publish(fragment):
            orig(fragment)
            self.poke_fetch_logic()
        c.publish = publish
        self.candidates[peer_id] = c
        return c

    def drop_peer(self, peer_id) -> None:
        self.candidates.pop(peer_id, None)
        self.peer_fetch.pop(peer_id, None)
        self.peer_gsv.pop(peer_id, None)
        self.poke_fetch_logic()

    def fetch_order_key(self, peer_id) -> float:
        """Expected time to fetch a reference-sized batch from this peer
        (the DeltaQ comparison of Decision.hs prioritisation)."""
        t = self.peer_gsv.get(peer_id)
        return t.expected_fetch_time(16 * 2048) if t is not None else 0.0

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        """Fork the background threads (initNodeKernel, NodeKernel.hs:139,
        + the ChainDB background pipeline, Background.hs:84-102)."""
        self.btime.start(label=f"{self.label}-btime")
        self.chain_db.current_slot_fn = lambda: self.btime.current.value
        self._threads.append(sim.spawn(fetch_logic_loop(self),
                                       label=f"{self.label}-fetch-logic"))
        self._threads.append(sim.spawn(self._background_loop(),
                                       label=f"{self.label}-chaindb-bg"))
        self._threads.append(sim.spawn(self.chain_db.add_block_runner(),
                                       label=f"{self.label}-add-block"))
        self._threads.append(sim.spawn(self._slot_tick_loop(),
                                       label=f"{self.label}-slot-tick"))
        for forging in self.forgings:
            self._threads.append(
                sim.spawn(self._forging_loop(forging),
                          label=f"{self.label}-forge-{forging.issuer}"))

    async def _slot_tick_loop(self) -> None:
        """Re-triage buffered future blocks as their slots arrive
        (cdbFutureBlocks rerun; Fragment/InFuture.hs clock-skew check)."""
        last = self.btime.current.value - 1
        while True:
            slot = await self.btime.wait_slot_after(last)
            last = slot
            if self.chain_db.future_blocks:
                for res in self.chain_db.on_slot_tick(slot):
                    sim.trace_event(("future-block-adopted", self.label,
                                     res.kind))

    async def _background_loop(self) -> None:
        """copyAndSnapshotRunner: whenever the chain grows past k, copy the
        excess to the ImmutableDB, GC the VolatileDB, snapshot the ledger
        (all inside ChainDB.copy_to_immutable)."""
        from .chain_sync import _wait_version_above, kernel_version_value
        while True:
            seen = kernel_version_value(self.chain_db)
            copied = self.chain_db.copy_to_immutable()
            if copied:
                sim.trace_event(("copy-to-immutable", self.label, copied))
                continue
            await _wait_version_above(self.chain_db, seen)

    def stop(self) -> None:
        self.btime.stop()
        for t in self._threads:
            t.cancel()
        self._threads.clear()

    # -- forging (NodeKernel.hs:344-496) --------------------------------------
    async def _forging_loop(self, forging: BlockForging) -> None:
        last = self.btime.current.value - 1
        while True:
            slot = await self.btime.wait_slot_after(last)
            last = slot
            try:
                self._try_forge(forging, slot)
            except Exception as e:
                sim.trace_event(("forge-error", self.label, slot, repr(e)))

    def _try_forge(self, forging: BlockForging, slot: int) -> None:
        ext = self.chain_db.current_ledger
        # forecast AT the slot (NodeKernel.hs:~400 ledger view forecast):
        # for era-composed ledgers this is the new era's view when `slot`
        # sits past a decided transition
        view = self.ledger_rules.forecast_view(ext.ledger, slot)
        ticked_dep = self.protocol.tick_chain_dep_state(
            ext.header.chain_dep_state, view, slot)
        proof = self.protocol.check_is_leader(
            forging.can_be_leader, slot, ticked_dep, view)
        if proof is None:
            return
        if self.mempool is not None:
            ticked_ledger = self.ledger_rules.tick(ext.ledger, slot)
            snap = self.mempool.get_snapshot_for(slot, ticked_ledger)
            body = tuple(snap.txs)
        else:
            body = ()
        # Build on the validated tip from the ledger state, NOT the chain
        # fragment: after copy-to-immutable empties the fragment the anchor
        # is a real block, and forging prev=GENESIS there would waste every
        # led slot on an unconnectable block.
        ann = ext.header.tip
        if ann is None:
            prev_hash, block_no = GENESIS_HASH, 0
        else:
            prev_hash, block_no = ann.hash, ann.block_no + 1
        hdr = ProtocolHeader(slot=slot, block_no=block_no,
                             prev_hash=prev_hash,
                             body_hash=body_hash_of(body),
                             issuer=forging.issuer)
        signed = forging.forge(self.protocol, proof, hdr)
        block = ProtocolBlock(signed, body)
        res = self.chain_db.add_block(block)
        sim.trace_event(("forged", self.label, slot, res.kind))
        if self.tracers.forge.active:
            from ..utils.tracer import TraceForgeEvent
            self.tracers.forge.trace(TraceForgeEvent(
                slot=slot, outcome="forged", detail=res.kind))


def connect_nodes(a: NodeKernel, b: NodeKernel, delay: float = 0.0,
                  sdu_size: int = 12288, fault_plan=None) -> None:
    """Wire a<->b with two directional connections (the ThreadNet mesh edge,
    Test/ThreadNet/Network.hs:275-344): each direction runs its own bearer,
    mux, and initiator/responder protocol set.  A FaultPlan wraps every
    bearer so the whole mesh runs under seeded network hostility."""
    _connect_directional(a, b, delay, sdu_size, fault_plan=fault_plan)
    _connect_directional(b, a, delay, sdu_size, fault_plan=fault_plan)


def _connect_directional(initiator: NodeKernel, responder: NodeKernel,
                         delay: float, sdu_size: int, fault_plan=None,
                         conn_seq: int = 0):
    """initiator runs chainsync/blockfetch clients against responder's
    servers (learning responder's chain) and offers its txs to responder's
    inbound (NodeToNode.hs initiator/responder application split).

    Version negotiation runs FIRST, on protocol 0 over the same bearer, and
    only a successful handshake starts the mini-protocols (Socket.hs:226:
    negotiate-then-multiplex).

    fault_plan: a simharness FaultPlan wrapping both bearers (each write
    direction draws from its own seeded stream).  conn_seq distinguishes
    successive redials of the same edge in thread labels."""
    peer_id = f"{initiator.label}->{responder.label}"
    tag = f"{peer_id}#{conn_seq}" if conn_seq else peer_id
    bi, br = bearer_pair(sdu_size=sdu_size, delay=delay)
    if fault_plan is not None:
        bi = fault_plan.wrap_bearer(bi, initiator.label, responder.label)
        br = fault_plan.wrap_bearer(br, responder.label, initiator.label)
    # the initiator's GSV estimate for this peer is fed passively by the
    # demuxer's per-SDU one-way delays (TraceStats.hs) on top of the
    # KeepAlive RTT probes; the label publishes the estimate as per-peer
    # net.deltaq.* gauges through the bounded-label helper
    tracker = PeerGSVTracker(label=peer_id)
    mux_i = Mux(bi, f"{tag}.mux-i", owd_observer=tracker.observe_owd)
    mux_r = Mux(br, f"{tag}.mux-r")
    mux_i.start()
    mux_r.start()

    async def run_and_teardown():
        # the dial-path contract (matching diffusion._dialer): when the
        # initiator application ends — cleanly or by a kill — its mux dies
        # with it, so redials never talk over a poisoned half-open bearer
        try:
            await _run_initiator(initiator, mux_i, peer_id, tracker)
        finally:
            mux_i.stop()

    handle = sim.spawn(run_and_teardown(), label=f"{tag}.connect-i")
    initiator._threads.append(handle)
    responder._threads.append(sim.spawn(
        _run_responder(responder, mux_r, peer_id),
        label=f"{tag}.connect-r"))
    return handle


async def _initiator_handshake(initiator: NodeKernel, mux_i, peer_id):
    """Version negotiation on protocol 0; returns the agreed version, or
    None on refusal/magic mismatch (the warm-up step every outbound
    connection — subscription-driven or governor-driven — runs first)."""
    versions = n2n.node_to_node_versions(initiator.network_magic)
    hs = Session(
        hs_proto.SPEC, CLIENT,
        CodecChannel(mux_i.channel(n2n.HANDSHAKE_NUM, INITIATOR),
                     hs_proto.CODEC))
    res = await hs_proto.client_propose(hs, versions)
    if res[0] != "accepted":
        sim.trace_event(("handshake-refused", initiator.label, peer_id,
                         res[1]))
        return None
    _, version, params = res
    if dict(params or {}).get("magic") != initiator.network_magic:
        sim.trace_event(("handshake-magic-mismatch", initiator.label,
                         peer_id, params))
        return None
    sim.trace_event(("handshake-ok", initiator.label, peer_id, version))
    return version


def _start_keepalive(initiator: NodeKernel, mux_i, peer_id, tracker):
    """The WARM-stage protocol (the reference keeps KeepAlive running on
    warm peers): RTT probes feeding the peer's GSV tracker.

    The probe doubles as the whole-connection liveness watchdog
    (timeLimitsKeepAlive): a responder silent past the reply deadline
    raises KeepAliveTimeout, and the supervisor tears the mux down —
    poisoning every mini-protocol channel so the hot set dies with
    MuxError instead of hanging, which ends the connection and feeds the
    failure to the error-policy/reconnect layer."""
    initiator.peer_gsv[peer_id] = tracker
    ka_sess = Session(
        ka_proto.SPEC, CLIENT,
        CodecChannel(mux_i.channel(KEEPALIVE_NUM, INITIATOR),
                     ka_proto.CODEC))

    async def supervised():
        try:
            await ka_proto.client_probe(
                ka_sess, None, initiator.keepalive_interval,
                on_rtt=tracker.observe_rtt,
                response_timeout=initiator.time_limits.keep_alive_timeout)
        except KeepAliveTimeout:
            sim.trace_event(("keepalive-kill", initiator.label, peer_id),
                            label="watchdog")
            mux_i.stop()
            raise

    return sim.spawn(supervised(), label=f"{peer_id}.ka-client")


async def _run_hot(initiator: NodeKernel, mux_i, peer_id, version) -> None:
    """The HOT protocol set: ChainSync (supervised, the liveness signal)
    + BlockFetch client + TxSubmission outbound.  Returns when ChainSync
    ends; cancels the satellites and releases the peer's candidate."""
    hdr_dec = initiator.header_decode
    blk_dec = initiator.block_decode_obj
    cs_codec = cs_proto.make_codec(hdr_dec) if hdr_dec else cs_proto.CODEC
    bf_codec = bf_proto.make_codec(blk_dec) if blk_dec else bf_proto.CODEC

    candidate = initiator.new_candidate(peer_id)
    initiator.peer_fetch[peer_id] = PeerFetchState(peer_id)

    satellites = []
    bf_sess = Session(
        bf_proto.SPEC, CLIENT,
        CodecChannel(mux_i.channel(BLOCKFETCH_NUM, INITIATOR), bf_codec))
    satellites.append(sim.spawn(
        _supervise_block_fetch(
            block_fetch_client(bf_sess, initiator, peer_id),
            initiator, mux_i, peer_id),
        label=f"{peer_id}.bf-client"))

    if initiator.mempool is not None and version >= n2n.NODE_TO_NODE_V2:
        tx_out = Session(
            tx_proto.SPEC, CLIENT,
            CodecChannel(mux_i.channel(TXSUBMISSION_NUM, INITIATOR),
                         tx_proto.CODEC))
        satellites.append(sim.spawn(
            _supervise_tx(tx_outbound_loop(tx_out, initiator.mempool),
                          initiator, mux_i, peer_id),
            label=f"{peer_id}.tx-out"))
    initiator._threads.extend(satellites)

    cs_sess = PipelinedSession(
        cs_proto.SPEC, CLIENT,
        CodecChannel(mux_i.channel(CHAINSYNC_NUM, INITIATOR), cs_codec),
        max_outstanding=initiator.chain_sync_window + 2)
    try:
        await _supervise_chain_sync(initiator, cs_sess, candidate, peer_id)
    finally:
        for s in satellites:
            s.cancel()
        initiator.drop_peer(peer_id)


async def _run_initiator(initiator: NodeKernel, mux_i, peer_id,
                         tracker=None) -> None:
    """The initiator-side connection runner (warm + hot in one go — the
    subscription-worker path promotes straight to hot).  Completes when
    the ChainSync client ends (the connection's liveness signal —
    Client.hs kill semantics); satellite protocols are cancelled on exit
    so subscription workers can treat completion as connection-down and
    redial."""
    # the whole negotiation runs under one deadline (the reference's
    # handshake timeout): a peer that swallows the proposal would
    # otherwise hang this dial forever while it holds a valency slot
    t0 = sim.now()
    done, version = await sim.timeout(
        initiator.time_limits.handshake_timeout,
        _initiator_handshake(initiator, mux_i, peer_id))
    if done and version is not None:
        _HANDSHAKE_SECS.observe(sim.now() - t0)
    if not done:
        sim.trace_event(("timeout", "handshake", "StConfirm", peer_id),
                        label="watchdog")
        mux_i.stop()
        raise WatchdogTimeout("handshake", "StConfirm",
                              initiator.time_limits.handshake_timeout)
    if version is None:
        return
    tracker = tracker if tracker is not None else PeerGSVTracker()
    ka = _start_keepalive(initiator, mux_i, peer_id, tracker)
    initiator._threads.append(ka)
    try:
        await _run_hot(initiator, mux_i, peer_id, version)
    finally:
        ka.cancel()


async def _run_responder(responder: NodeKernel, mux_r, peer_id) -> None:
    versions = n2n.node_to_node_versions(responder.network_magic)
    hs = Session(
        hs_proto.SPEC, SERVER,
        CodecChannel(mux_r.channel(n2n.HANDSHAKE_NUM, RESPONDER),
                     hs_proto.CODEC))
    res = await hs_proto.server_accept(hs, versions,
                                       policy=n2n.accept_same_magic)
    if res[0] != "accepted":
        sim.trace_event(("handshake-refused", responder.label, peer_id,
                         res[1]))
        return "refused"
    version = res[1]

    hdr_dec = responder.header_decode
    blk_dec = responder.block_decode_obj
    cs_codec = cs_proto.make_codec(hdr_dec) if hdr_dec else cs_proto.CODEC
    bf_codec = bf_proto.make_codec(blk_dec) if blk_dec else bf_proto.CODEC

    cs_srv = Session(
        cs_proto.SPEC, SERVER,
        CodecChannel(mux_r.channel(CHAINSYNC_NUM, RESPONDER), cs_codec))
    responder._threads.append(sim.spawn(
        chain_sync_server(cs_srv, responder.chain_db),
        label=f"{peer_id}.cs-server"))

    bf_srv = Session(
        bf_proto.SPEC, SERVER,
        CodecChannel(mux_r.channel(BLOCKFETCH_NUM, RESPONDER), bf_codec))
    responder._threads.append(sim.spawn(
        block_fetch_server(responder.chain_db)(bf_srv),
        label=f"{peer_id}.bf-server"))

    ka_srv = Session(
        ka_proto.SPEC, SERVER,
        CodecChannel(mux_r.channel(KEEPALIVE_NUM, RESPONDER),
                     ka_proto.CODEC))
    responder._threads.append(sim.spawn(
        ka_proto.server(ka_srv), label=f"{peer_id}.ka-server"))

    if responder.mempool is not None and responder.tx_decode is not None \
            and version >= n2n.NODE_TO_NODE_V2:
        tx_in = Session(
            tx_proto.SPEC, SERVER,
            CodecChannel(mux_r.channel(TXSUBMISSION_NUM, RESPONDER),
                         tx_proto.CODEC))
        responder._threads.append(sim.spawn(
            _supervise_tx(
                tx_inbound_loop(tx_in, responder.mempool,
                                responder.tx_decode),
                responder, mux_r, peer_id),
            label=f"{peer_id}.tx-in"))
    return "accepted"


async def _supervise_tx(coro, kernel, mux, peer_id) -> None:
    """Observe the TxSubmission loops: a window-contract violation is a
    protocol error, so kill the whole connection (stop the mux — every
    mini-protocol channel dies with it), matching the reference's
    ProtocolError -> bearer-teardown path (TxSubmission/Inbound.hs)."""
    try:
        await coro
    except TxInboundProtocolError as e:
        sim.trace_event(("tx-protocol-kill", kernel.label, peer_id,
                         str(e)))
        mux.stop()


async def _supervise_block_fetch(coro, kernel, mux, peer_id) -> None:
    """Observe the BlockFetch client: a watchdog-expired request means the
    peer is silent past its (DeltaQ-informed) deadline — kill the whole
    connection via mux teardown, same as the reference's per-protocol time
    limits feeding the connection-level error path."""
    from .watchdog import WatchdogTimeout
    try:
        await coro
    except WatchdogTimeout:
        sim.trace_event(("block-fetch-watchdog-kill", kernel.label,
                         peer_id), label="watchdog")
        mux.stop()


async def _supervise_chain_sync(kernel: NodeKernel, session, candidate,
                                peer_id) -> None:
    """Run the ChainSync client; on error drop the peer's candidate so
    BlockFetch stops considering it (the kill-the-connection semantics of
    Client.hs:1114), then RE-RAISE so the connection ends exceptionally:
    the reconnect layer's ErrorPolicy must see the violation and suspend
    the peer — swallowing it here would make the failure look like a
    clean session end (fail_count reset + base backoff) and the node
    would churn against a protocol-violating peer forever."""
    from .chain_sync import ChainSyncClientError
    try:
        await chain_sync_client(session, kernel, candidate,
                                window=kernel.chain_sync_window)
    except ChainSyncClientError as e:
        sim.trace_event(("chain-sync-kill", kernel.label, peer_id, str(e)))
        kernel.drop_peer(peer_id)
        raise
