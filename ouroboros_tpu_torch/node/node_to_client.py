"""Node-to-client: local chainsync (blocks), state queries, tx submission.

Reference: ouroboros-consensus/src/Ouroboros/Consensus/MiniProtocol/
LocalStateQuery/Server.hs (acquire against LedgerDB past states),
LocalTxSubmission/Server.hs (submit → mempool), consensus
Network/NodeToClient.hs (app assembly; local protocol numbers: chainsync=5,
txsubmission=6, statequery=7 — ouroboros-network NodeToNode.hs:382-391),
and cardano-client/src/Cardano/Client/Subscription.hs:57 (`subscribe`:
follow the chain with client callbacks).

The local chainsync rolls FULL BLOCKS forward (node-to-client serves
blocks, not headers).

Ported from `ouroboros_tpu/node/node_to_client.py` (the port imports
nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from .. import simharness as sim
from ..chain.block import Point
from ..network import node_to_node as n2n
from ..network.mux import INITIATOR, RESPONDER, CodecChannel, Mux, bearer_pair
from ..network.protocols import chainsync as cs_proto
from ..network.protocols import handshake as hs_proto
from ..network.protocols import localstatequery as lsq_proto
from ..network.protocols import localtxsubmission as ltx_proto
from ..network.typed import CLIENT, SERVER, Session
from ..utils import cbor
from .chain_sync import chain_sync_server

NODE_TO_CLIENT_V1 = 1


# -- queries (Shelley/Ledger/Query.hs analog: a small closed query algebra) --
def answer_query(kernel, ext_state, query):
    """Answer a query against an acquired ExtLedgerState."""
    kind = query[0] if isinstance(query, (list, tuple)) else query
    if kind == "tip":
        return ext_state.header.tip_point.encode()
    if kind == "slot":
        return getattr(ext_state.ledger, "slot", None)
    if kind == "state-hash":
        return ext_state.ledger.state_hash()
    if kind == "utxo":
        return [list(e) for e in getattr(ext_state.ledger, "utxo", ())]
    if kind == "protocol-state":
        dep = ext_state.header.chain_dep_state
        return repr(dep)
    raise ValueError(f"unknown query {query!r}")


def serve_node_to_client(kernel, mux_r: Mux, label: str = "local") -> list:
    """Spawn the responder-side local protocol servers on an existing mux
    (mkApps for node-to-client, Network/NodeToClient.hs)."""
    threads = []

    async def run():
        versions = hs_proto.Versions().add(NODE_TO_CLIENT_V1,
                                           {"magic": kernel.network_magic})
        hs = Session(hs_proto.SPEC, SERVER,
                     CodecChannel(mux_r.channel(n2n.HANDSHAKE_NUM,
                                                RESPONDER),
                                  hs_proto.CODEC))
        res = await hs_proto.server_accept(hs, versions,
                                           policy=n2n.accept_same_magic)
        if res[0] != "accepted":
            return "refused"

        blk_dec = kernel.block_decode_obj
        cs_codec = cs_proto.make_codec(blk_dec) if blk_dec \
            else cs_proto.CODEC
        cs_srv = Session(
            cs_proto.SPEC, SERVER,
            CodecChannel(mux_r.channel(n2n.LOCAL_CHAINSYNC_NUM, RESPONDER),
                         cs_codec))
        threads.append(sim.spawn(
            chain_sync_server(cs_srv, kernel.chain_db,
                              content_of=lambda b: b),
            label=f"{label}.local-cs"))

        def acquire_state(point: Optional[Point]):
            db = kernel.chain_db
            if point is None:
                return db.current_ledger
            return db.ledger_db.state_at(point)

        lsq_srv = Session(
            lsq_proto.SPEC, SERVER,
            CodecChannel(mux_r.channel(n2n.LOCAL_STATEQUERY_NUM, RESPONDER),
                         lsq_proto.CODEC))
        threads.append(sim.spawn(
            lsq_proto.server(lsq_srv, acquire_state,
                             lambda st, q: answer_query(kernel, st, q)),
            label=f"{label}.local-lsq"))

        def try_add(tx_bytes: bytes) -> Optional[str]:
            if kernel.mempool is None or kernel.tx_decode is None:
                return "node has no mempool"
            tx = kernel.tx_decode(cbor.loads(tx_bytes))
            added, rejected = kernel.mempool.try_add_txs([tx])
            if added:
                return None
            return str(rejected[0][1]) if rejected else "rejected"

        ltx_srv = Session(
            ltx_proto.SPEC, SERVER,
            CodecChannel(mux_r.channel(n2n.LOCAL_TXSUBMISSION_NUM,
                                       RESPONDER),
                         ltx_proto.CODEC))
        threads.append(sim.spawn(
            ltx_proto.server(ltx_srv, try_add),
            label=f"{label}.local-ltx"))
        return "accepted"

    # threads[0] is the accept thread; awaiting it yields the handshake
    # outcome ("accepted"/"refused") — diffusion's local server holds or
    # releases the connection on it
    threads.insert(0, sim.spawn(run(), label=f"{label}.local-accept"))
    kernel._threads.extend(threads)
    return threads


@dataclass
class LocalClient:
    """A connected node-to-client handle (the wallet's end)."""
    mux: Mux
    chain_sync: Session
    state_query: Session
    tx_submission: Session
    version: int

    async def query(self, query, point: Optional[Point] = None):
        """Acquire → query → release, keeping the session open for the
        next query (query_once's MsgDone would retire it)."""
        sess = self.state_query
        await sess.send(lsq_proto.MsgAcquire(point))
        reply = await sess.recv()
        if isinstance(reply, lsq_proto.MsgFailure):
            return None
        await sess.send(lsq_proto.MsgQuery(query))
        result = (await sess.recv()).result
        await sess.send(lsq_proto.MsgRelease())
        return result

    async def submit_tx(self, tx) -> Optional[str]:
        """Submit one tx, keeping the session open for more (the submit()
        helper's MsgDone would retire it)."""
        sess = self.tx_submission
        await sess.send(ltx_proto.MsgSubmitTx(cbor.dumps(tx.encode())))
        reply = await sess.recv()
        return None if isinstance(reply, ltx_proto.MsgAcceptTx) \
            else reply.reason


async def connect_local_client(kernel, delay: float = 0.0,
                               network_magic: Optional[int] = None,
                               label: str = "wallet") -> Optional[LocalClient]:
    """Dial a node's node-to-client surface: negotiate, then expose typed
    sessions (connectTo + Subscription.subscribe's connection phase)."""
    bc, bn = bearer_pair(sdu_size=12288, delay=delay)
    mux_c = Mux(bc, f"{label}.mux-c")
    mux_n = Mux(bn, f"{label}.mux-n")
    mux_c.start()
    mux_n.start()
    serve_node_to_client(kernel, mux_n, label=label)

    magic = kernel.network_magic if network_magic is None else network_magic
    versions = hs_proto.Versions().add(NODE_TO_CLIENT_V1, {"magic": magic})
    hs = Session(hs_proto.SPEC, CLIENT,
                 CodecChannel(mux_c.channel(n2n.HANDSHAKE_NUM, INITIATOR),
                              hs_proto.CODEC))
    res = await hs_proto.client_propose(hs, versions)
    if res[0] != "accepted":
        return None

    blk_dec = kernel.block_decode_obj
    cs_codec = cs_proto.make_codec(blk_dec) if blk_dec else cs_proto.CODEC
    return LocalClient(
        mux=mux_c,
        chain_sync=Session(
            cs_proto.SPEC, CLIENT,
            CodecChannel(mux_c.channel(n2n.LOCAL_CHAINSYNC_NUM, INITIATOR),
                         cs_codec)),
        state_query=Session(
            lsq_proto.SPEC, CLIENT,
            CodecChannel(mux_c.channel(n2n.LOCAL_STATEQUERY_NUM, INITIATOR),
                         lsq_proto.CODEC)),
        tx_submission=Session(
            ltx_proto.SPEC, CLIENT,
            CodecChannel(mux_c.channel(n2n.LOCAL_TXSUBMISSION_NUM,
                                       INITIATOR),
                         ltx_proto.CODEC)),
        version=res[1])


async def subscribe(client: LocalClient, on_block: Callable[[Any], None],
                    points=(), until_blocks: Optional[int] = None) -> None:
    """Follow the node's chain, calling on_block per rolled-forward block
    (cardano-client Subscription.subscribe:57).  Stops after until_blocks
    rolls (None = forever)."""
    sess = client.chain_sync
    pts = tuple(points) or (Point.genesis(),)
    await sess.send(cs_proto.MsgFindIntersect(pts))
    reply = await sess.recv()
    if isinstance(reply, cs_proto.MsgIntersectNotFound):
        raise RuntimeError("no intersection for subscription")
    seen = 0
    while until_blocks is None or seen < until_blocks:
        await sess.send(cs_proto.MsgRequestNext())
        msg = await sess.recv()
        if isinstance(msg, cs_proto.MsgAwaitReply):
            msg = await sess.recv()
        if isinstance(msg, cs_proto.MsgRollForward):
            on_block(msg.header)        # local variant: this IS the block
            seen += 1
        # MsgRollBackward: restart from the new point (callbacks decide)
    await sess.send(cs_proto.MsgDone())
