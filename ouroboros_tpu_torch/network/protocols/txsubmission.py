"""TxSubmission2 — pull-based transaction relay (the server asks).

Reference: ouroboros-network/src/Ouroboros/Network/Protocol/TxSubmission/
Type.hs:43-215.  Agency is inverted vs the other protocols: the inbound side
(SERVER role here) requests tx ids/txs; the outbound side (CLIENT role, the
node with the mempool) replies.  Windowed acks bound memory (SURVEY.md §5
"long-context": windowed TxSubmission acks).

Ported from `ouroboros_tpu/network/protocols/txsubmission.py` (the port
imports nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..typed import CLIENT, NOBODY, SERVER, ProtocolSpec, branch
from .codec import Codec


@dataclass(frozen=True)
class MsgRequestTxIds:
    TAG = 0
    blocking: bool
    ack: int      # how many previously-sent ids the server has processed
    req: int      # how many new ids may be sent

    def encode_args(self):
        return [self.blocking, self.ack, self.req]

    @classmethod
    def decode_args(cls, a):
        return cls(bool(a[0]), int(a[1]), int(a[2]))


@dataclass(frozen=True)
class MsgReplyTxIds:
    TAG = 1
    ids_and_sizes: tuple   # ((txid: bytes, size: int), ...)

    def encode_args(self):
        return [[[i, s] for i, s in self.ids_and_sizes]]

    @classmethod
    def decode_args(cls, a):
        return cls(tuple((bytes(i), int(s)) for i, s in a[0]))


@dataclass(frozen=True)
class MsgRequestTxs:
    TAG = 2
    ids: tuple

    def encode_args(self):
        # tsIdList must use indefinite-length framing — the reference
        # codec accepts nothing else (messages.cddl:78 note)
        from ...utils.cbor import IndefList
        return [IndefList(self.ids)]

    @classmethod
    def decode_args(cls, a):
        return cls(tuple(bytes(i) for i in a[0]))


@dataclass(frozen=True)
class MsgReplyTxs:
    TAG = 3
    txs: tuple             # opaque tx bytes

    def encode_args(self):
        from ...utils.cbor import IndefList
        return [IndefList(self.txs)]

    @classmethod
    def decode_args(cls, a):
        return cls(tuple(bytes(t) for t in a[0]))


@dataclass(frozen=True)
class MsgDone:
    TAG = 4

    def encode_args(self):
        return []

    @classmethod
    def decode_args(cls, a):
        return cls()


SPEC = ProtocolSpec(
    name="tx-submission",
    init_state="TxIdle",
    agency={"TxIdle": SERVER, "TxIdsBlocking": CLIENT,
            "TxIdsNonBlocking": CLIENT, "TxTxs": CLIENT, "TxDone": NOBODY},
    transitions={
        ("TxIdle", "MsgRequestTxIds"): branch(
            lambda m: "TxIdsBlocking" if m.blocking else "TxIdsNonBlocking",
            "TxIdsBlocking", "TxIdsNonBlocking"),
        ("TxIdsBlocking", "MsgReplyTxIds"): "TxIdle",
        ("TxIdsBlocking", "MsgDone"): "TxDone",
        ("TxIdsNonBlocking", "MsgReplyTxIds"): "TxIdle",
        ("TxIdle", "MsgRequestTxs"): "TxTxs",
        ("TxTxs", "MsgReplyTxs"): "TxIdle",
    })

CODEC = Codec([MsgRequestTxIds, MsgReplyTxIds, MsgRequestTxs, MsgReplyTxs,
               MsgDone])


async def outbound_from_mempool(session, mempool_reader, done_when_drained=True):
    """Outbound side (CLIENT role): serves tx ids/txs from a mempool reader.

    mempool_reader: object with next_ids(n) -> [(txid, size)] (advancing an
    internal cursor) and lookup(txid) -> tx bytes | None.
    Reference: TxSubmission/Outbound.hs + Mempool/Reader.hs.
    """
    unacked: list = []
    while True:
        msg = await session.recv()
        if isinstance(msg, MsgRequestTxIds):
            del unacked[:msg.ack]
            new = mempool_reader.next_ids(msg.req)
            unacked.extend(i for i, _ in new)
            if not new and msg.blocking and done_when_drained:
                await session.send(MsgDone())
                return
            await session.send(MsgReplyTxIds(tuple(new)))
        elif isinstance(msg, MsgRequestTxs):
            txs = tuple(t for t in (mempool_reader.lookup(i)
                                    for i in msg.ids) if t is not None)
            await session.send(MsgReplyTxs(txs))


async def inbound_collect(session, sink, window: int = 10,
                          max_rounds: int = 1000):
    """Inbound side (SERVER role): window-request ids, fetch txs, feed sink.

    sink(tx) -> None.  The peer may legitimately reply with *fewer* txs than
    requested (mempool eviction between id advertisement and the fetch —
    Outbound.hs filters missing ids), so txs are NOT paired with requested
    ids here; the mempool derives the id by hashing the tx, as the reference
    inbound does (TxSubmission/Inbound.hs:52-172, windowed acks + dedup).
    """
    ack = 0
    for _ in range(max_rounds):
        await session.send(MsgRequestTxIds(True, ack, window))
        reply = await session.recv()
        if isinstance(reply, MsgDone):
            return
        ids = [i for i, _ in reply.ids_and_sizes]
        if ids:
            await session.send(MsgRequestTxs(tuple(ids)))
            for tx in (await session.recv()).txs:
                sink(tx)
        ack = len(ids)
