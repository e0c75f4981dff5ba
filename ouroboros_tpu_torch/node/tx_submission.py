"""Node-side TxSubmission: blocking outbound from the mempool, windowed
inbound to the mempool.

Reference: ouroboros-network/src/Ouroboros/Network/TxSubmission/
{Outbound,Inbound}.hs + Mempool/Reader.hs — the outbound side serves tx
ids/bodies from a mempool reader, *blocking* on the blocking id request
until new txs arrive; the inbound side (Inbound.hs:52-172) keeps a
bounded FIFO of unacknowledged ids, acks strictly in order as txs are
processed, budgets the bodies it requests, dedups against the mempool,
and treats any window violation by the peer as a protocol error that
tears the connection down — an over-announcing or re-announcing peer
cannot grow node memory unboundedly.

Ported from `ouroboros_tpu/node/tx_submission.py` (the port imports nothing
of the JAX package). Copied whole.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from .. import simharness as sim
from ..network.protocols.txsubmission import (
    MsgReplyTxIds, MsgReplyTxs, MsgRequestTxIds, MsgRequestTxs,
)
from ..simharness import Retry
from ..utils import cbor


class TxInboundProtocolError(Exception):
    """Peer violated the TxSubmission window contract; the caller must
    drop the connection (the reference throws ProtocolErrorXxx from
    Inbound.hs and the mux tears the bearer down)."""


@dataclass
class TxInboundPolicy:
    """Bounds of the inbound window (Inbound.hs txSubmissionInbound
    arguments; numbers are the node defaults' shape, not a copy)."""
    max_unacked: int = 10          # FIFO bound on unacknowledged ids
    max_ids_per_req: int = 3       # new ids per MsgRequestTxIds
    max_txs_per_req: int = 2       # bodies per MsgRequestTxs
    max_bytes_in_flight: int = 100_000   # advertised-size budget per fetch
    max_tx_size: int = 65_536      # reject absurd advertised sizes


async def tx_outbound_loop(session, mempool,
                           max_window: int = 100) -> None:
    """CLIENT role: serve our mempool to the peer's inbound server.

    Blocking MsgRequestTxIds waits on the mempool version TVar when the
    reader is drained (Outbound.hs blocking semantics) instead of
    terminating — this is a long-lived node-to-node connection.

    Keeps the peer honest the way Outbound.hs does: acks may only cover
    ids we actually sent, and the requested window is bounded — a peer
    asking for an absurd window is a protocol violation, not an
    allocation.
    """
    reader = mempool.reader()
    unacked: deque = deque()
    while True:
        msg = await session.recv()
        if isinstance(msg, MsgRequestTxIds):
            if msg.ack > len(unacked) or msg.req > max_window:
                raise TxInboundProtocolError(
                    f"outbound: bad ack/req {msg.ack}/{msg.req} "
                    f"(unacked {len(unacked)})")
            for _ in range(msg.ack):
                unacked.popleft()
            if len(unacked) + msg.req > max_window:
                raise TxInboundProtocolError(
                    "outbound: window overflow requested")
            new = reader.next_ids(msg.req)
            if not new and msg.blocking:
                while not new:
                    seen = mempool.version.value
                    new = reader.next_ids(msg.req)
                    if new:
                        break

                    def wait_change(tx, seen=seen):
                        if tx.read(mempool.version) == seen:
                            raise Retry()
                    await sim.atomically(wait_change)
            unacked.extend(i for i, _s in new)
            await session.send(MsgReplyTxIds(tuple(new)))
        elif isinstance(msg, MsgRequestTxs):
            txs = []
            for txid in msg.ids:
                if txid not in unacked:
                    raise TxInboundProtocolError(
                        "outbound: tx requested outside the window")
                tx = reader.lookup(txid)
                if tx is not None:
                    txs.append(cbor.dumps(tx.encode()))
            await session.send(MsgReplyTxs(tuple(txs)))
        else:
            return


async def tx_inbound_loop(session, mempool, tx_decode,
                          policy: TxInboundPolicy | None = None,
                          window: int | None = None) -> None:
    """SERVER role: pull txs from the peer into our mempool with the
    reference's full window discipline (Inbound.hs:52-172):

    - `unacked` is a bounded FIFO of advertised ids; acks cover exactly
      the processed PREFIX (the peer drops that many from its own queue).
    - ids already in the mempool are processed immediately (dedup) —
      acked without fetching a body.
    - body requests are budgeted by count and by advertised size.
    - violations (more ids than requested, an id re-announced while
      still unacknowledged, empty non-blocking reply abuse, oversize
      advertisements, bodies that hash to an id we never asked for)
      raise TxInboundProtocolError — the connection dies, memory stays
      bounded by max_unacked + the fetch budget.
    """
    from dataclasses import replace
    policy = policy or TxInboundPolicy()
    if window is not None:       # legacy knob: cap ids per request
        policy = replace(policy, max_ids_per_req=window)
    unacked: deque = deque()      # ids in announce order
    done: set = set()             # processed (fetched/deduped) ids
    sizes: dict = {}              # id -> advertised size, not yet fetched
    ack = 0
    while True:
        in_window = len(unacked)
        req = min(policy.max_ids_per_req, policy.max_unacked - in_window)
        blocking = in_window == 0 and not sizes
        if req > 0:
            await session.send(MsgRequestTxIds(blocking, ack, req))
            ack = 0
            reply = await session.recv()
            if not isinstance(reply, MsgReplyTxIds):
                return
            if len(reply.ids_and_sizes) > req:
                raise TxInboundProtocolError(
                    f"peer sent {len(reply.ids_and_sizes)} ids for a "
                    f"window of {req}")
            if blocking and not reply.ids_and_sizes:
                raise TxInboundProtocolError(
                    "empty reply to a blocking id request")
            have = set(mempool.get_snapshot().tx_ids)
            pending = set(unacked)
            for txid, size in reply.ids_and_sizes:
                if txid in pending:
                    raise TxInboundProtocolError(
                        "id re-announced while still unacknowledged")
                if size > policy.max_tx_size:
                    raise TxInboundProtocolError(
                        f"advertised tx size {size} exceeds limit")
                pending.add(txid)
                unacked.append(txid)
                if txid in have or txid in done:
                    done.add(txid)       # dedup: ack without fetching
                else:
                    sizes[txid] = size
        # budgeted body fetch: oldest-first so acks can advance
        batch: list = []
        budget = policy.max_bytes_in_flight
        for txid in unacked:
            if len(batch) >= policy.max_txs_per_req or budget <= 0:
                break
            if txid in sizes and txid not in done:
                if sizes[txid] <= budget or not batch:
                    batch.append(txid)
                    budget -= sizes[txid]
        if batch:
            await session.send(MsgRequestTxs(tuple(batch)))
            reply = await session.recv()
            if not isinstance(reply, MsgReplyTxs):
                return
            requested = set(batch)
            txs = []
            for raw in reply.txs:
                tx = tx_decode(cbor.loads(raw))
                if tx.txid not in requested:
                    raise TxInboundProtocolError(
                        "peer sent a tx body we did not request")
                txs.append(tx)
            if txs:
                mempool.try_add_txs(txs)
            # requested-but-missing ids are done too: the peer's mempool
            # evicted them (Outbound.hs filters); we must still ack
            for txid in batch:
                done.add(txid)
                sizes.pop(txid, None)
        # advance the ack prefix
        while unacked and unacked[0] in done:
            done.discard(unacked.popleft())
            ack += 1
