"""TipSample — experimental tip sampling from established peers.

Reference: ouroboros-network/src/Ouroboros/Network/Protocol/TipSample/
Type.hs (states StIdle / StFollowTip n / StDone; messages MsgFollowTip,
MsgNextTip, MsgNextTipDone, MsgDone) and Codec.hs (tags 0-3).

The client asks for the next `n` tip changes at-or-after a slot; the server
streams n-1 MsgNextTip then a final MsgNextTipDone that returns agency.  The
reference carries the outstanding count in the type (StFollowTip (S n));
here the runtime spec loops in one "FollowTip" state and the *count* contract
(exactly n tips, last one Done) is enforced by the client loop below —
the same dynamic check surface as the rest of this package's session types.

Ported from `ouroboros_tpu/network/protocols/tipsample.py` (the port imports
nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass

from ...chain import Tip
from ..typed import CLIENT, NOBODY, SERVER, ProtocolSpec
from .codec import Codec


@dataclass(frozen=True)
class MsgFollowTip:
    TAG = 0
    n: int           # how many tip changes to stream (>= 1)
    slot: int        # start at this slot or after

    def encode_args(self):
        return [self.n, self.slot]

    @classmethod
    def decode_args(cls, a):
        return cls(int(a[0]), int(a[1]))


@dataclass(frozen=True)
class MsgNextTip:
    TAG = 1
    tip: Tip

    def encode_args(self):
        return [self.tip.encode()]

    @classmethod
    def decode_args(cls, a):
        return cls(Tip.decode(a[0]))


@dataclass(frozen=True)
class MsgNextTipDone:
    TAG = 2
    tip: Tip

    def encode_args(self):
        return [self.tip.encode()]

    @classmethod
    def decode_args(cls, a):
        return cls(Tip.decode(a[0]))


@dataclass(frozen=True)
class MsgDone:
    TAG = 3

    def encode_args(self):
        return []

    @classmethod
    def decode_args(cls, a):
        return cls()


SPEC = ProtocolSpec(
    name="tip-sample",
    init_state="TSIdle",
    agency={"TSIdle": CLIENT, "TSFollowTip": SERVER, "TSDone": NOBODY},
    transitions={
        ("TSIdle", "MsgFollowTip"): "TSFollowTip",
        ("TSFollowTip", "MsgNextTip"): "TSFollowTip",
        ("TSFollowTip", "MsgNextTipDone"): "TSIdle",
        ("TSIdle", "MsgDone"): "TSDone",
    })

CODEC = Codec([MsgFollowTip, MsgNextTip, MsgNextTipDone, MsgDone])


async def client_sample(session, requests):
    """For each (n, slot) request, collect exactly n tips; returns the list
    of per-request tip lists.  Raises if the server miscounts (the dynamic
    rendering of StFollowTip (S n))."""
    rounds = []
    for n, slot in requests:
        if n < 1:
            raise ValueError("tip-sample: n must be >= 1")
        await session.send(MsgFollowTip(n, slot))
        tips = []
        while True:
            msg = await session.recv()
            tips.append(msg.tip)
            if isinstance(msg, MsgNextTipDone):
                break
            if len(tips) >= n:
                raise RuntimeError(
                    f"tip-sample: server sent more than {n} tips "
                    f"without MsgNextTipDone")
        if len(tips) != n:
            raise RuntimeError(
                f"tip-sample: server ended after {len(tips)} tips, "
                f"expected {n}")
        rounds.append(tips)
    await session.send(MsgDone())
    return rounds


async def server_from_tip_source(session, tip_source):
    """Serve tip changes from `tip_source`, an async callable
    (slot, after_tip) -> Tip yielding each next tip at-or-after `slot`
    (the follower-driven shape of TipSample/Server.hs)."""
    last = None
    while True:
        msg = await session.recv()
        if isinstance(msg, MsgDone):
            return
        slot = msg.slot
        for i in range(msg.n):
            last = await tip_source(slot, last)
            if i == msg.n - 1:
                await session.send(MsgNextTipDone(last))
            else:
                await session.send(MsgNextTip(last))
