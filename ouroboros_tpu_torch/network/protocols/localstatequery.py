"""LocalStateQuery — node-to-client ledger queries with acquire/release.

Reference: ouroboros-network/src/Ouroboros/Network/Protocol/LocalStateQuery/
Type.hs:33-124 (acquire a point, query against that ledger state, release)
and consensus's server vs LedgerDB past states
(MiniProtocol/LocalStateQuery/Server.hs).

Ported from `ouroboros_tpu/network/protocols/localstatequery.py` (the port
imports nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from ...chain import Point
from ..typed import CLIENT, NOBODY, SERVER, ProtocolSpec
from .codec import Codec


@dataclass(frozen=True)
class MsgAcquire:
    TAG = 0
    point: Optional[Point]   # None = current tip

    def encode_args(self):
        return [self.point.encode() if self.point else None]

    @classmethod
    def decode_args(cls, a):
        return cls(Point.decode(a[0]) if a[0] is not None else None)


@dataclass(frozen=True)
class MsgAcquired:
    TAG = 1

    def encode_args(self):
        return []

    @classmethod
    def decode_args(cls, a):
        return cls()


@dataclass(frozen=True)
class MsgFailure:
    TAG = 2
    reason: str

    def encode_args(self):
        return [self.reason]

    @classmethod
    def decode_args(cls, a):
        return cls(str(a[0]))


@dataclass(frozen=True)
class MsgQuery:
    TAG = 3
    query: Any               # CBOR-encodable query value

    def encode_args(self):
        return [self.query]

    @classmethod
    def decode_args(cls, a):
        return cls(a[0])


@dataclass(frozen=True)
class MsgResult:
    TAG = 4
    result: Any

    def encode_args(self):
        return [self.result]

    @classmethod
    def decode_args(cls, a):
        return cls(a[0])


@dataclass(frozen=True)
class MsgReAcquire:
    TAG = 5
    point: Optional[Point]

    def encode_args(self):
        return [self.point.encode() if self.point else None]

    @classmethod
    def decode_args(cls, a):
        return cls(Point.decode(a[0]) if a[0] is not None else None)


@dataclass(frozen=True)
class MsgRelease:
    TAG = 6

    def encode_args(self):
        return []

    @classmethod
    def decode_args(cls, a):
        return cls()


@dataclass(frozen=True)
class MsgDone:
    TAG = 7

    def encode_args(self):
        return []

    @classmethod
    def decode_args(cls, a):
        return cls()


SPEC = ProtocolSpec(
    name="local-state-query",
    init_state="LSQIdle",
    agency={"LSQIdle": CLIENT, "LSQAcquiring": SERVER,
            "LSQAcquired": CLIENT, "LSQQuerying": SERVER, "LSQDone": NOBODY},
    transitions={
        ("LSQIdle", "MsgAcquire"): "LSQAcquiring",
        ("LSQIdle", "MsgDone"): "LSQDone",
        ("LSQAcquiring", "MsgAcquired"): "LSQAcquired",
        ("LSQAcquiring", "MsgFailure"): "LSQIdle",
        ("LSQAcquired", "MsgQuery"): "LSQQuerying",
        ("LSQAcquired", "MsgReAcquire"): "LSQAcquiring",
        ("LSQAcquired", "MsgRelease"): "LSQIdle",
        ("LSQQuerying", "MsgResult"): "LSQAcquired",
    })

CODEC = Codec([MsgAcquire, MsgAcquired, MsgFailure, MsgQuery, MsgResult,
               MsgReAcquire, MsgRelease, MsgDone])


async def server(session, acquire_state, answer):
    """acquire_state(point|None) -> state handle | None;
    answer(state, query) -> result."""
    state = None
    while True:
        msg = await session.recv()
        if isinstance(msg, MsgDone):
            return
        if isinstance(msg, (MsgAcquire, MsgReAcquire)):
            state = acquire_state(msg.point)
            if state is None:
                await session.send(MsgFailure("point not available"))
            else:
                await session.send(MsgAcquired())
        elif isinstance(msg, MsgQuery):
            await session.send(MsgResult(answer(state, msg.query)))
        elif isinstance(msg, MsgRelease):
            state = None


async def query_once(session, query, point: Optional[Point] = None):
    """Client helper: acquire, query, release, done."""
    await session.send(MsgAcquire(point))
    reply = await session.recv()
    if isinstance(reply, MsgFailure):
        await session.send(MsgDone())
        return None
    await session.send(MsgQuery(query))
    result = (await session.recv()).result
    await session.send(MsgRelease())
    await session.send(MsgDone())
    return result
