"""TxSubmission2 — Hello-wrapped TxSubmission.

Reference: ouroboros-network/src/Ouroboros/Network/Protocol/TxSubmission2/
Type.hs (TxSubmission2 = Hello TxSubmission StIdle) and Codec.hs:62-63
(codecHello with helloTag 6).

The outbound side (CLIENT role, the node offering its mempool) sends
MsgHello first, then the plain TxSubmission exchange runs: the inbound
side requests tx ids / txs, the outbound side replies.

Ported from `ouroboros_tpu/network/protocols/txsubmission2.py` (the port
imports nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

from . import txsubmission as tx1
from .hello import wrap

SPEC, CODEC, MsgHello = wrap(tx1.SPEC, tx1.CODEC, hello_tag=6,
                             name="tx-submission-2")

# Re-exports so users of TxSubmission2 see the full message vocabulary.
MsgRequestTxIds = tx1.MsgRequestTxIds
MsgReplyTxIds = tx1.MsgReplyTxIds
MsgRequestTxs = tx1.MsgRequestTxs
MsgReplyTxs = tx1.MsgReplyTxs
MsgDone = tx1.MsgDone


async def outbound_from_mempool(session, mempool_reader,
                                done_when_drained: bool = True):
    """Outbound side: announce with MsgHello, then serve ids/txs
    (TxSubmission2's initiator, Protocol/TxSubmission2/Client.hs shape)."""
    await session.send(MsgHello())
    return await tx1.outbound_from_mempool(
        session, mempool_reader, done_when_drained=done_when_drained)


async def inbound_collect(session, sink, window: int = 10,
                          max_rounds: int = 1000):
    """Inbound side: wait for the peer's MsgHello, then run the windowed
    id/tx collection loop (Protocol/TxSubmission2/Server.hs shape)."""
    hello = await session.recv()
    if not isinstance(hello, MsgHello):
        raise RuntimeError(f"tx-submission-2: expected MsgHello, "
                           f"got {type(hello).__name__}")
    return await tx1.inbound_collect(session, sink, window=window,
                                     max_rounds=max_rounds)
