"""Diffusion — compose the node's whole network surface.

Reference: ouroboros-network/src/Ouroboros/Network/Diffusion.hs:119-245.
`runDataDiffusion` composes, in one record-driven call: the snocket layer,
a LOCAL server for wallets (node-to-client), per-address ACCEPT servers
for inbound node-to-node (initiator-and-responder mode only), an IP
subscription worker and per-domain DNS subscription workers for outbound,
with shared connection tables, accept limits and error policies.

This is that composition over this repo's Snocket trait, so the same
`run_data_diffusion` runs deterministically in-sim (SimSnocket) and over
real TCP/Unix sockets (TcpSnocket/UnixSnocket under the IO runtime) —
tests/test_diffusion.py drives both.

The older SimNetwork address-registry path is kept for tests that wire
kernels directly without bearers.

Ported from `ouroboros_tpu/node/diffusion.py` (the port imports nothing of
the JAX package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

from .. import simharness as sim
from ..network.error_policy import default_node_policies
from ..network.mux import Mux
from ..network.snocket import (
    AcceptLimits, ConnectionTable, Listener, Snocket, run_server,
)
from ..network.peer_selection import (
    PeerSelectionActions, PeerSelectionGovernor, PeerSelectionTargets,
)
from ..network.subscription import (
    Resolver, SubscriptionFatal, SubscriptionWorker,
    dns_subscription_targets,
)
from .kernel import NodeKernel, _connect_directional, _run_initiator, \
    _run_responder
from .node_to_client import serve_node_to_client

INITIATOR_AND_RESPONDER = "initiator-and-responder"   # DiffusionMode
INITIATOR_ONLY = "initiator-only"


@dataclass
class DiffusionArguments:
    """Diffusion.hs:119 `DiffusionArguments`: everything the node's
    network surface needs, as one typed record."""
    addresses: Sequence = ()           # listen addrs (daIPv4/daIPv6Address)
    local_address: object = None       # daLocalAddress (node-to-client)
    ip_producers: Sequence = ()        # daIpProducers dial targets
    ip_valency: int = 2
    dns_producers: Sequence = ()       # daDnsProducers domain names
    dns_valency: int = 2
    accept_limits: AcceptLimits = field(default_factory=AcceptLimits)
    mode: str = INITIATOR_AND_RESPONDER   # daDiffusionMode
    error_policies: Optional[list] = None


@dataclass
class Diffusion:
    """Handle on a running diffusion: its workers, servers and tables."""
    threads: list = field(default_factory=list)
    workers: list = field(default_factory=list)
    listeners: list = field(default_factory=list)
    tables: dict = field(default_factory=dict)

    def stop(self) -> None:
        for t in self.threads:
            t.cancel()
        for lst in self.listeners:
            lst.close()


async def _hold_connection(mux: Mux, runner) -> None:
    """Run a connection's application, then hold the bearer open until
    the mux's demuxer ends (bearer EOF/error = connection down), so
    run_server's finally can free the ConnectionTable slot and close the
    bearer (Socket.hs keeps the fd open until the application completes).
    A refused handshake releases the connection immediately."""
    try:
        outcome = await runner
        if outcome != "refused":
            await mux.wait_closed()
    finally:
        mux.stop()


def _dialer(kernel: NodeKernel, snocket: Snocket, label: str):
    """connectToNode over a snocket: dial -> mux -> initiator app.
    Returns the dial function the subscription workers drive."""
    def dial(addr):
        async def conn():
            bearer = await snocket.connect(addr)
            peer_id = f"{kernel.label}->{addr}"
            mux = Mux(bearer, f"{peer_id}.mux")
            mux.start()
            try:
                await _run_initiator(kernel, mux, peer_id)
            finally:
                mux.stop()
                close = getattr(bearer, "close", None)
                if close:
                    close()
        return sim.spawn(conn(), label=f"{label}-dial-{addr}")
    return dial


async def run_data_diffusion(kernel: NodeKernel, args: DiffusionArguments,
                             snocket: Snocket,
                             local_snocket: Optional[Snocket] = None,
                             resolver: Optional[Resolver] = None,
                             ) -> Diffusion:
    """The full composition (runDataDiffusion, Diffusion.hs:175-245):

    - local node-to-client server on args.local_address
    - accept server per args.addresses entry (responder mode only)
    - one IP subscription worker over args.ip_producers
    - one DNS subscription worker per args.dns_producers domain
    - shared remote/local connection tables + accept limits + policies
    """
    d = Diffusion()
    if args.dns_producers and resolver is None:
        raise ValueError("dns_producers given but no resolver — pass a "
                         "Resolver (DictResolver in sim, "
                         "GetAddrInfoResolver for real DNS)")
    policies = args.error_policies if args.error_policies is not None \
        else default_node_policies()
    remote_table = ConnectionTable()
    local_table = ConnectionTable()
    d.tables = {"remote": remote_table, "local": local_table}
    local_snocket = local_snocket or snocket

    # -- local server for wallets (Diffusion.hs:214 runLocalServer)
    if args.local_address is not None:
        lst = await local_snocket.listen(args.local_address)
        d.listeners.append(lst)

        async def local_handler(bearer, remote):
            mux = Mux(bearer, f"{kernel.label}.local.{remote}")
            mux.start()
            threads = serve_node_to_client(
                kernel, mux, label=f"{kernel.label}.local.{remote}")
            # threads[0] = the accept thread; its result is the handshake
            # outcome, so refused wallets release their slot immediately
            await _hold_connection(mux, threads[0].wait())

        d.threads.append(sim.spawn(
            run_server(lst, local_handler, table=local_table,
                       limits=args.accept_limits),
            label=f"{kernel.label}-local-server"))

    # -- accept servers per address (Diffusion.hs:225 runServer)
    if args.mode == INITIATOR_AND_RESPONDER:
        for addr in args.addresses:
            lst = await snocket.listen(addr)
            d.listeners.append(lst)

            async def handler(bearer, remote):
                peer_id = f"{kernel.label}<-{remote}"
                mux = Mux(bearer, f"{peer_id}.mux")
                mux.start()
                await _hold_connection(
                    mux, _run_responder(kernel, mux, peer_id))

            d.threads.append(sim.spawn(
                run_server(lst, handler, table=remote_table,
                           limits=args.accept_limits),
                label=f"{kernel.label}-server-{addr}"))

    # -- IP subscription worker (Diffusion.hs:217 runIpSubscriptionWorker)
    dial = _dialer(kernel, snocket, kernel.label)
    if args.ip_producers:
        w = SubscriptionWorker(
            targets=list(args.ip_producers), valency=args.ip_valency,
            dial=dial, error_policies=policies,
            label=f"{kernel.label}-ip-subscription")
        d.workers.append(w)
        d.threads.append(sim.spawn(
            _run_subscription(w, kernel),
            label=f"{kernel.label}-ip-subscription"))

    # -- DNS subscription workers (Diffusion.hs:220)
    for name in args.dns_producers:
        async def dns_worker(name=name):
            targets = await dns_subscription_targets(resolver, [name])
            if not targets:
                sim.trace_event(("dns-no-targets", kernel.label, name))
                return
            w = SubscriptionWorker(
                targets=targets, valency=args.dns_valency, dial=dial,
                error_policies=policies,
                label=f"{kernel.label}-dns-{name}")
            d.workers.append(w)
            await _run_subscription(w, kernel)
        d.threads.append(sim.spawn(
            dns_worker(), label=f"{kernel.label}-dns-subscription-{name}"))

    kernel._threads.extend(d.threads)
    return d


async def _run_subscription(worker: SubscriptionWorker,
                            kernel: NodeKernel) -> None:
    """Run a subscription worker under the THROW contract: a
    SubscriptionFatal verdict is fatal to the APPLICATION, not just the
    one peer (ErrorPolicy.hs `Throw`), so the whole node is stopped
    visibly — without this the worker thread dies silently reaped and the
    kernel keeps running with its connections never replenished."""
    try:
        await worker.run()
    except SubscriptionFatal as exc:
        sim.trace_event((kernel.label, "diffusion-fatal", repr(exc)),
                        label="subscription")
        try:
            raise
        finally:
            kernel.stop()


async def connect_local_client_via(snocket: Snocket, addr, kernel_info,
                                   label: str = "wallet"):
    """Wallet-side dial of a diffusion's local address: connect over the
    snocket, negotiate node-to-client, return a LocalClient
    (cardano-client Subscription.subscribe's connection phase, but over
    the diffusion's real local server rather than an in-memory pair).

    kernel_info: (network_magic, block_decode_obj) — what the client
    needs to know about the node's chain encoding."""
    from ..network import node_to_node as n2n
    from ..network.mux import INITIATOR, CodecChannel
    from ..network.protocols import chainsync as cs_proto
    from ..network.protocols import handshake as hs_proto
    from ..network.protocols import localstatequery as lsq_proto
    from ..network.protocols import localtxsubmission as ltx_proto
    from ..network.typed import CLIENT, Session
    from .node_to_client import NODE_TO_CLIENT_V1, LocalClient

    network_magic, block_decode_obj = kernel_info
    bearer = await snocket.connect(addr)
    mux_c = Mux(bearer, f"{label}.mux")
    mux_c.start()
    versions = hs_proto.Versions().add(NODE_TO_CLIENT_V1,
                                       {"magic": network_magic})
    hs = Session(hs_proto.SPEC, CLIENT,
                 CodecChannel(mux_c.channel(n2n.HANDSHAKE_NUM, INITIATOR),
                              hs_proto.CODEC))
    res = await hs_proto.client_propose(hs, versions)
    if res[0] != "accepted":
        mux_c.stop()
        close = getattr(bearer, "close", None)
        if close:
            close()
        return None
    cs_codec = cs_proto.make_codec(block_decode_obj) if block_decode_obj \
        else cs_proto.CODEC
    return LocalClient(
        mux=mux_c,
        chain_sync=Session(
            cs_proto.SPEC, CLIENT,
            CodecChannel(mux_c.channel(n2n.LOCAL_CHAINSYNC_NUM,
                                       INITIATOR), cs_codec)),
        state_query=Session(
            lsq_proto.SPEC, CLIENT,
            CodecChannel(mux_c.channel(n2n.LOCAL_STATEQUERY_NUM,
                                       INITIATOR), lsq_proto.CODEC)),
        tx_submission=Session(
            ltx_proto.SPEC, CLIENT,
            CodecChannel(mux_c.channel(n2n.LOCAL_TXSUBMISSION_NUM,
                                       INITIATOR), ltx_proto.CODEC)),
        version=res[1])


# ---------------------------------------------------------------------------
# Legacy in-sim address registry (pre-snocket wiring; kept for tests that
# connect kernels without bearers)
# ---------------------------------------------------------------------------

class SimNetwork:
    """Address registry standing in for the Snocket layer: maps addresses
    to listening kernels and dials by spawning directional connections.

    fault_plan: a simharness FaultPlan applied to every dialled
    connection's bearers — AND to the dial itself: dialling across an
    active partition is refused (the TCP-SYN-times-out analog), so
    suspension/redial cycles run at backoff speed instead of waiting out
    a full handshake watchdog."""

    def __init__(self, link_delay: float = 0.05, sdu_size: int = 12288,
                 fault_plan=None):
        self.link_delay = link_delay
        self.sdu_size = sdu_size
        self.fault_plan = fault_plan
        self.listeners: Dict[object, NodeKernel] = {}
        self._dial_seq: Dict[tuple, int] = {}

    def listen(self, addr, kernel: NodeKernel) -> None:
        self.listeners[addr] = kernel

    def make_dial(self, kernel: NodeKernel):
        def dial(addr):
            target = self.listeners.get(addr)
            if target is None:
                async def fail():
                    raise ConnectionError(f"no listener at {addr}")
                return sim.spawn(fail(), label=f"dial-fail-{addr}")
            if self.fault_plan is not None and \
                    self.fault_plan.partition_severs(kernel.label,
                                                     target.label):
                async def refused():
                    sim.trace_event(("dial-refused-partition", kernel.label,
                                     target.label), label="fault")
                    raise ConnectionError(
                        f"partitioned: {kernel.label}->{target.label}")
                return sim.spawn(refused(), label=f"dial-part-{addr}")
            key = (kernel.label, target.label)
            seq = self._dial_seq[key] = self._dial_seq.get(key, 0) + 1
            return _connect_directional(kernel, target,
                                        self.link_delay, self.sdu_size,
                                        fault_plan=self.fault_plan,
                                        conn_seq=seq)
        return dial


class GovernedConnection:
    """One governor-driven outbound connection with warm/hot staging
    (Governor.hs's cold→warm→hot ladder made concrete):

      warm  = bearer + mux + negotiated version + KeepAlive probe
      hot   = ChainSync/BlockFetch/TxSubmission client set running

    The subscription path fuses both stages (_run_initiator); here the
    governor controls each transition separately."""

    def __init__(self, kernel: NodeKernel, target: NodeKernel,
                 link_delay: float, sdu_size: int, on_down=None):
        self.kernel = kernel
        self.target = target
        self.peer_id = f"{kernel.label}->{target.label}"
        self.link_delay = link_delay
        self.sdu_size = sdu_size
        self.on_down = on_down
        self.mux_i = self.mux_r = None
        self.version = None
        self._ka = None
        self._hot = None

    async def establish(self) -> bool:
        """Cold→warm: dial, handshake, start KeepAlive."""
        from .kernel import (
            PeerGSVTracker, _initiator_handshake, _run_responder,
            _start_keepalive,
        )
        from ..network.mux import bearer_pair
        bi, br = bearer_pair(sdu_size=self.sdu_size, delay=self.link_delay)
        tracker = PeerGSVTracker(label=self.peer_id)
        self.mux_i = Mux(bi, f"{self.peer_id}.mux-i",
                         owd_observer=tracker.observe_owd)
        self.mux_r = Mux(br, f"{self.peer_id}.mux-r")
        self.mux_i.start()
        self.mux_r.start()
        self.target._threads.append(sim.spawn(
            _run_responder(self.target, self.mux_r, self.peer_id),
            label=f"{self.peer_id}.connect-r"))
        self.version = await _initiator_handshake(self.kernel, self.mux_i,
                                                  self.peer_id)
        if self.version is None:
            self.close()
            return False
        self._ka = _start_keepalive(self.kernel, self.mux_i, self.peer_id,
                                    tracker)
        return True

    def activate(self) -> bool:
        """Warm→hot: start the full client protocol set; when ChainSync
        ends (peer gone / protocol kill) the governor hears about it via
        on_down."""
        from .kernel import _run_hot
        if self.version is None or self._hot is not None:
            return False

        async def hot_then_report():
            try:
                await _run_hot(self.kernel, self.mux_i, self.peer_id,
                               self.version)
            finally:
                self._hot = None
                if self.on_down is not None:
                    self.on_down()
        self._hot = sim.spawn(hot_then_report(),
                              label=f"{self.peer_id}.hot")
        self.kernel._threads.append(self._hot)
        return True

    def deactivate(self) -> None:
        """Hot→warm: cancel the hot set, keep the connection."""
        if self._hot is not None:
            job, self._hot = self._hot, None
            job.cancel()

    def close(self) -> None:
        """→cold: tear the whole connection down."""
        self.deactivate()
        if self._ka is not None:
            self._ka.cancel()
            self._ka = None
        for m in (self.mux_i, self.mux_r):
            if m is not None:
                m.stop()


class GovernedPeerActions(PeerSelectionActions):
    """PeerSelectionActions over a SimNetwork: the governor's decisions
    become real staged connections (the runnable-governor wiring)."""

    def __init__(self, kernel: NodeKernel, network: SimNetwork,
                 root_peers=(), gossip_fn=None):
        self.kernel = kernel
        self.network = network
        self.root_peers = list(root_peers)
        self.gossip_fn = gossip_fn
        self.conns: Dict[object, GovernedConnection] = {}
        self.governor = None          # wired by run_governed_diffusion

    async def request_peers(self):
        return list(self.root_peers)

    async def gossip(self, addr):
        return list(self.gossip_fn(addr)) if self.gossip_fn else []

    async def connect(self, addr) -> bool:
        target = self.network.listeners.get(addr)
        if target is None or addr in self.conns:
            return addr in self.conns
        conn = GovernedConnection(
            self.kernel, target, self.network.link_delay,
            self.network.sdu_size,
            on_down=lambda a=addr: self._peer_down(a))
        if await conn.establish():
            self.conns[addr] = conn
            return True
        return False

    def _peer_down(self, addr) -> None:
        """Hot set died (connection gone): drop the stale connection so a
        re-promotion dials fresh, and feed the failure back (suspension +
        demotion) if the governor still thought the peer active."""
        was_active = (self.governor is not None
                      and addr in self.governor.active)
        conn = self.conns.pop(addr, None)
        if conn is not None:
            conn.close()
        if was_active:
            self.governor.report_failure(addr)

    async def activate(self, addr) -> bool:
        conn = self.conns.get(addr)
        return bool(conn) and conn.activate()

    async def deactivate(self, addr) -> None:
        conn = self.conns.get(addr)
        if conn:
            conn.deactivate()

    async def disconnect(self, addr) -> None:
        conn = self.conns.pop(addr, None)
        if conn:
            conn.close()


def run_governed_diffusion(kernel: NodeKernel, network: SimNetwork,
                           address, root_peers=(),
                           targets: Optional[PeerSelectionTargets] = None,
                           seed: int = 0, churn_interval: float = 0.0,
                           gossip_fn=None) -> Diffusion:
    """Governor-driven peer maintenance: instead of fixed-valency
    subscription workers, a PeerSelectionGovernor walks peers up and down
    the cold/warm/hot ladder toward declarative targets (Governor.hs:427
    as the diffusion driver)."""
    network.listen(address, kernel)
    actions = GovernedPeerActions(kernel, network, root_peers=root_peers,
                                  gossip_fn=gossip_fn)
    gov = PeerSelectionGovernor(
        targets or PeerSelectionTargets(), actions, seed=seed,
        self_addr=address)
    actions.governor = gov
    d = Diffusion()
    t = sim.spawn(gov.run(), label=f"{kernel.label}-governor")
    kernel._threads.append(t)
    d.threads.append(t)
    if churn_interval > 0:
        tc = sim.spawn(gov.run_churn(churn_interval),
                       label=f"{kernel.label}-governor-churn")
        kernel._threads.append(tc)
        d.threads.append(tc)
    d.tables["governor"] = gov
    d.tables["actions"] = actions
    return d


def run_sim_diffusion(kernel: NodeKernel, network: SimNetwork,
                      address, ip_targets=(), valency: int = 2,
                      error_policies=None, base_backoff: float = 5.0,
                      seed: int = 0) -> Diffusion:
    """SimNetwork-based composition (the pre-round-4 surface)."""
    network.listen(address, kernel)
    d = Diffusion()
    if ip_targets:
        worker = SubscriptionWorker(
            targets=list(ip_targets), valency=valency,
            dial=network.make_dial(kernel),
            error_policies=(error_policies if error_policies is not None
                            else default_node_policies()),
            base_backoff=base_backoff, seed=seed,
            label=f"{kernel.label}-subscription")
        t = sim.spawn(_run_subscription(worker, kernel),
                      label=f"{kernel.label}-subscription")
        kernel._threads.append(t)
        d.workers.append(worker)
        d.threads.append(t)
    return d
