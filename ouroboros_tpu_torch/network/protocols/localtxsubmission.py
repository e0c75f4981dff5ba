"""LocalTxSubmission — wallet-to-node transaction submission.

Reference: ouroboros-network/src/Ouroboros/Network/Protocol/
LocalTxSubmission/Type.hs (submit / accept / reject-with-reason).

Ported from `ouroboros_tpu/network/protocols/localtxsubmission.py` (the
port imports nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ..typed import CLIENT, NOBODY, SERVER, ProtocolSpec
from .codec import Codec


@dataclass(frozen=True)
class MsgSubmitTx:
    TAG = 0
    tx: bytes

    def encode_args(self):
        return [self.tx]

    @classmethod
    def decode_args(cls, a):
        return cls(bytes(a[0]))


@dataclass(frozen=True)
class MsgAcceptTx:
    TAG = 1

    def encode_args(self):
        return []

    @classmethod
    def decode_args(cls, a):
        return cls()


@dataclass(frozen=True)
class MsgRejectTx:
    TAG = 2
    reason: str

    def encode_args(self):
        return [self.reason]

    @classmethod
    def decode_args(cls, a):
        return cls(str(a[0]))


@dataclass(frozen=True)
class MsgDone:
    TAG = 3

    def encode_args(self):
        return []

    @classmethod
    def decode_args(cls, a):
        return cls()


SPEC = ProtocolSpec(
    name="local-tx-submission",
    init_state="LTSIdle",
    agency={"LTSIdle": CLIENT, "LTSBusy": SERVER, "LTSDone": NOBODY},
    transitions={
        ("LTSIdle", "MsgSubmitTx"): "LTSBusy",
        ("LTSIdle", "MsgDone"): "LTSDone",
        ("LTSBusy", "MsgAcceptTx"): "LTSIdle",
        ("LTSBusy", "MsgRejectTx"): "LTSIdle",
    })

CODEC = Codec([MsgSubmitTx, MsgAcceptTx, MsgRejectTx, MsgDone])


async def server(session, try_add):
    """try_add(tx_bytes) -> None (accepted) | str (rejection reason)."""
    while True:
        msg = await session.recv()
        if isinstance(msg, MsgDone):
            return
        err = try_add(msg.tx)
        if err is None:
            await session.send(MsgAcceptTx())
        else:
            await session.send(MsgRejectTx(err))


async def submit(session, txs):
    """Client: submit txs in order; returns list of None|reason."""
    results = []
    for tx in txs:
        await session.send(MsgSubmitTx(tx))
        reply = await session.recv()
        results.append(None if isinstance(reply, MsgAcceptTx)
                       else reply.reason)
    await session.send(MsgDone())
    return results
