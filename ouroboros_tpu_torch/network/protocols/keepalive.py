"""KeepAlive — RTT probe + liveness.

Reference: ouroboros-network/src/Ouroboros/Network/Protocol/KeepAlive/
Type.hs:42-74 and KeepAlive.hs:41-55 (client loop feeding per-peer GSV
DeltaQ state).

Ported from `ouroboros_tpu/network/protocols/keepalive.py` (the port imports
nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass

from ... import simharness as sim
from ..typed import CLIENT, NOBODY, SERVER, ProtocolSpec
from .codec import Codec


@dataclass(frozen=True)
class MsgKeepAlive:
    TAG = 0
    cookie: int

    def encode_args(self):
        return [self.cookie]

    @classmethod
    def decode_args(cls, a):
        return cls(int(a[0]))


@dataclass(frozen=True)
class MsgKeepAliveResponse:
    TAG = 1
    cookie: int

    def encode_args(self):
        return [self.cookie]

    @classmethod
    def decode_args(cls, a):
        return cls(int(a[0]))


@dataclass(frozen=True)
class MsgDone:
    TAG = 2

    def encode_args(self):
        return []

    @classmethod
    def decode_args(cls, a):
        return cls()


SPEC = ProtocolSpec(
    name="keep-alive",
    init_state="KAClient",
    agency={"KAClient": CLIENT, "KAServer": SERVER, "KADone": NOBODY},
    transitions={
        ("KAClient", "MsgKeepAlive"): "KAServer",
        ("KAServer", "MsgKeepAliveResponse"): "KAClient",
        ("KAClient", "MsgDone"): "KADone",
    })

CODEC = Codec([MsgKeepAlive, MsgKeepAliveResponse, MsgDone])


async def server(session):
    while True:
        msg = await session.recv()
        if isinstance(msg, MsgDone):
            return
        await session.send(MsgKeepAliveResponse(msg.cookie))


async def client_probe(session, rounds, interval: float,
                       on_rtt=None, response_timeout=None):
    """Probe loop: send cookie, measure virtual RTT, report to on_rtt
    (the DeltaQ feed, KeepAlive.hs:41-55).  rounds=None probes forever
    (the node's long-lived keep-alive).

    response_timeout: the per-reply watchdog (timeLimitsKeepAlive, 60 s in
    the reference) — a responder silent past it raises KeepAliveTimeout,
    the whole-connection liveness verdict the kernel converts into a mux
    teardown.  The wait is a non-destructive wait_ready poll, so the
    timeout path consumes nothing."""
    rtts = []
    cookie = 0
    while rounds is None or cookie < rounds:
        t0 = sim.now()
        await session.send(MsgKeepAlive(cookie & 0xFFFF))
        if response_timeout is not None:
            ready = await session.channel.wait_ready(response_timeout)
            if not ready:
                from ...node.watchdog import KeepAliveTimeout
                sim.trace_event(("timeout", "keep-alive", "KAServer",
                                 cookie), label="watchdog")
                raise KeepAliveTimeout("keep-alive", "KAServer",
                                       response_timeout)
        reply = await session.recv()
        if reply.cookie != cookie & 0xFFFF:
            raise RuntimeError("keep-alive cookie mismatch")
        rtt = sim.now() - t0
        rtts.append(rtt)
        if on_rtt:
            on_rtt(rtt)
        cookie += 1
        if rounds is not None and cookie == rounds:
            break
        await sim.sleep(interval)
    await session.send(MsgDone())
    return rtts
