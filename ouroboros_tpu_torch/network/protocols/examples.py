"""PingPong + ReqResp — the teaching/test fixture protocols.

Reference: typed-protocols-examples/src/Network/TypedProtocol/
{PingPong,ReqResp}/Type.hs.  PingPong is the smallest protocol with client
agency (MsgPing/MsgPong/MsgDone); ReqResp is the generic request-response
shape (MsgReq/MsgResp/MsgDone) used throughout the reference's driver and
channel tests.  Both serve the same role here: minimal fixtures for the
session-type machinery, pipelining, and codec plumbing.

Ported from `ouroboros_tpu/network/protocols/examples.py` (the port imports
nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from ..typed import CLIENT, NOBODY, SERVER, ProtocolSpec
from .codec import Codec

# --- PingPong ---------------------------------------------------------------


@dataclass(frozen=True)
class MsgPing:
    TAG = 0

    def encode_args(self):
        return []

    @classmethod
    def decode_args(cls, a):
        return cls()


@dataclass(frozen=True)
class MsgPong:
    TAG = 1

    def encode_args(self):
        return []

    @classmethod
    def decode_args(cls, a):
        return cls()


@dataclass(frozen=True)
class MsgPingDone:
    TAG = 2

    def encode_args(self):
        return []

    @classmethod
    def decode_args(cls, a):
        return cls()


PING_PONG_SPEC = ProtocolSpec(
    name="ping-pong",
    init_state="PPIdle",
    agency={"PPIdle": CLIENT, "PPBusy": SERVER, "PPDone": NOBODY},
    transitions={
        ("PPIdle", "MsgPing"): "PPBusy",
        ("PPBusy", "MsgPong"): "PPIdle",
        ("PPIdle", "MsgPingDone"): "PPDone",
    })

PING_PONG_CODEC = Codec([MsgPing, MsgPong, MsgPingDone])


async def ping_pong_client(session, rounds: int) -> int:
    """Send `rounds` pings, count pongs (PingPong/Client.hs shape)."""
    pongs = 0
    for _ in range(rounds):
        await session.send(MsgPing())
        reply = await session.recv()
        assert isinstance(reply, MsgPong)
        pongs += 1
    await session.send(MsgPingDone())
    return pongs


async def ping_pong_server(session) -> int:
    """Answer every ping; returns how many were served."""
    served = 0
    while True:
        msg = await session.recv()
        if isinstance(msg, MsgPingDone):
            return served
        await session.send(MsgPong())
        served += 1


# --- ReqResp ----------------------------------------------------------------


@dataclass(frozen=True)
class MsgReq:
    TAG = 0
    payload: Any

    def encode_args(self):
        return [self.payload]

    @classmethod
    def decode_args(cls, a):
        return cls(a[0])


@dataclass(frozen=True)
class MsgResp:
    TAG = 1
    payload: Any

    def encode_args(self):
        return [self.payload]

    @classmethod
    def decode_args(cls, a):
        return cls(a[0])


@dataclass(frozen=True)
class MsgReqDone:
    TAG = 2

    def encode_args(self):
        return []

    @classmethod
    def decode_args(cls, a):
        return cls()


REQ_RESP_SPEC = ProtocolSpec(
    name="req-resp",
    init_state="RRIdle",
    agency={"RRIdle": CLIENT, "RRBusy": SERVER, "RRDone": NOBODY},
    transitions={
        ("RRIdle", "MsgReq"): "RRBusy",
        ("RRBusy", "MsgResp"): "RRIdle",
        ("RRIdle", "MsgReqDone"): "RRDone",
    })

REQ_RESP_CODEC = Codec([MsgReq, MsgResp, MsgReqDone])


async def req_resp_client(session, requests) -> list:
    """Issue each request in turn, collect responses
    (ReqResp/Client.hs reqRespClientMap shape)."""
    out = []
    for r in requests:
        await session.send(MsgReq(r))
        out.append((await session.recv()).payload)
    await session.send(MsgReqDone())
    return out


async def req_resp_client_pipelined(session, requests) -> list:
    """Pipelined variant: all requests in flight before collecting —
    the reqRespClientMapPipelined fixture (ReqResp/Client.hs) used to
    check pipelined == unpipelined results."""
    for r in requests:
        await session.send_pipelined(MsgReq(r), reply_state="RRIdle")
    out = [(await session.collect()).payload for _ in requests]
    await session.send(MsgReqDone())
    return out


async def req_resp_server(session, serve: Callable[[Any], Any]):
    """Answer requests with serve(payload) until MsgReqDone."""
    served = 0
    while True:
        msg = await session.recv()
        if isinstance(msg, MsgReqDone):
            return served
        await session.send(MsgResp(serve(msg.payload)))
        served += 1
