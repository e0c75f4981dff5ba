"""LocalTxMonitor — mempool observation for local clients.

Reference: ouroboros-network/src/Ouroboros/Network/Protocol/LocalTxMonitor/
Type.hs (states StIdle / StBusy / StDone; messages MsgRequestTx /
MsgReplyTx / MsgDone).  At the reference snapshot only the type exists (no
codec/client/server shipped); the rebuild provides the full set so wallets
and explorers can stream mempool contents.

Semantics (Type.hs docstring): the server returns each transaction that is
in the mempool and has not yet been sent to this client; slow clients may
miss txs evicted in the meantime — observationally equivalent to missing
them on the network.

Ported from `ouroboros_tpu/network/protocols/localtxmonitor.py` (the port
imports nothing of the JAX package). Copied whole; its server asks its
mempool for `snapshot_txs()` and `wait_for_new(seen)`, which neither
package's `Mempool` has: callers pass an adapter.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..typed import CLIENT, NOBODY, SERVER, ProtocolSpec
from .codec import Codec


@dataclass(frozen=True)
class MsgRequestTx:
    TAG = 0

    def encode_args(self):
        return []

    @classmethod
    def decode_args(cls, a):
        return cls()


@dataclass(frozen=True)
class MsgReplyTx:
    TAG = 1
    tx: bytes

    def encode_args(self):
        return [self.tx]

    @classmethod
    def decode_args(cls, a):
        return cls(bytes(a[0]))


@dataclass(frozen=True)
class MsgDone:
    TAG = 2

    def encode_args(self):
        return []

    @classmethod
    def decode_args(cls, a):
        return cls()


SPEC = ProtocolSpec(
    name="local-tx-monitor",
    init_state="TMIdle",
    agency={"TMIdle": CLIENT, "TMBusy": SERVER, "TMDone": NOBODY},
    transitions={
        ("TMIdle", "MsgRequestTx"): "TMBusy",
        ("TMBusy", "MsgReplyTx"): "TMIdle",
        ("TMIdle", "MsgDone"): "TMDone",
    })

CODEC = Codec([MsgRequestTx, MsgReplyTx, MsgDone])


async def server_from_mempool(session, mempool):
    """Stream each mempool tx once per client; blocks (virtually) until a
    new tx arrives.  `mempool` needs snapshot_txs() -> [tx bytes] and an
    awaitable wait_for_new(seen_count) used when drained."""
    sent = 0
    while True:
        msg = await session.recv()
        if isinstance(msg, MsgDone):
            return
        while True:
            txs = mempool.snapshot_txs()
            if sent < len(txs):
                break
            await mempool.wait_for_new(sent)
        await session.send(MsgReplyTx(txs[sent]))
        sent += 1


async def client_collect(session, n: int):
    """Request n transactions, then terminate; returns them."""
    out = []
    for _ in range(n):
        await session.send(MsgRequestTx())
        out.append((await session.recv()).tx)
    await session.send(MsgDone())
    return out
