"""ChainSync — header-chain following.

Reference: ouroboros-network/src/Ouroboros/Network/Protocol/ChainSync/
Type.hs:26-128 (states StIdle/StNext/StIntersect; messages below),
Examples.hs (follower-driven server), PipelineDecision.hs (pipelining
policy, reimplemented in consensus/chain_sync_client.py).

Ported from `ouroboros_tpu/network/protocols/chainsync.py` (the port imports
nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from ...chain import Block, BlockHeader, Point, Tip, point_of
from ..typed import CLIENT, NOBODY, SERVER, ProtocolSpec
from .codec import Codec


@dataclass(frozen=True)
class MsgRequestNext:
    TAG = 0

    def encode_args(self):
        return []

    @classmethod
    def decode_args(cls, a):
        return cls()


@dataclass(frozen=True)
class MsgAwaitReply:
    TAG = 1

    def encode_args(self):
        return []

    @classmethod
    def decode_args(cls, a):
        return cls()


@dataclass(frozen=True)
class MsgRollForward:
    TAG = 2
    header: BlockHeader
    tip: Tip

    def encode_args(self):
        # wrappedHeader = #6.24(bytes .cbor blockHeader): the header rides
        # inside a tag-24 CBOR-in-CBOR envelope (messages.cddl:34)
        from ...utils import cbor
        return [cbor.Tag(24, cbor.dumps(self.header.encode())),
                self.tip.encode()]

    @classmethod
    def decode_args(cls, a):
        from ...utils import cbor
        return cls(BlockHeader.decode(cbor.unwrap_tag24(a[0])),
                   Tip.decode(a[1]))


@dataclass(frozen=True)
class MsgRollBackward:
    TAG = 3
    point: Point
    tip: Tip

    def encode_args(self):
        return [self.point.encode(), self.tip.encode()]

    @classmethod
    def decode_args(cls, a):
        return cls(Point.decode(a[0]), Tip.decode(a[1]))


@dataclass(frozen=True)
class MsgFindIntersect:
    TAG = 4
    points: tuple

    def encode_args(self):
        return [[p.encode() for p in self.points]]

    @classmethod
    def decode_args(cls, a):
        return cls(tuple(Point.decode(p) for p in a[0]))


@dataclass(frozen=True)
class MsgIntersectFound:
    TAG = 5
    point: Point
    tip: Tip

    def encode_args(self):
        return [self.point.encode(), self.tip.encode()]

    @classmethod
    def decode_args(cls, a):
        return cls(Point.decode(a[0]), Tip.decode(a[1]))


@dataclass(frozen=True)
class MsgIntersectNotFound:
    TAG = 6
    tip: Tip

    def encode_args(self):
        return [self.tip.encode()]

    @classmethod
    def decode_args(cls, a):
        return cls(Tip.decode(a[0]))


@dataclass(frozen=True)
class MsgDone:
    TAG = 7

    def encode_args(self):
        return []

    @classmethod
    def decode_args(cls, a):
        return cls()


SPEC = ProtocolSpec(
    name="chain-sync",
    init_state="StIdle",
    agency={"StIdle": CLIENT, "StNext": SERVER, "StMustReply": SERVER,
            "StIntersect": SERVER, "StDone": NOBODY},
    transitions={
        ("StIdle", "MsgRequestNext"): "StNext",
        ("StNext", "MsgAwaitReply"): "StMustReply",
        ("StNext", "MsgRollForward"): "StIdle",
        ("StNext", "MsgRollBackward"): "StIdle",
        ("StMustReply", "MsgRollForward"): "StIdle",
        ("StMustReply", "MsgRollBackward"): "StIdle",
        ("StIdle", "MsgFindIntersect"): "StIntersect",
        ("StIntersect", "MsgIntersectFound"): "StIdle",
        ("StIntersect", "MsgIntersectNotFound"): "StIdle",
        ("StIdle", "MsgDone"): "StDone",
    })

CODEC = Codec([MsgRequestNext, MsgAwaitReply, MsgRollForward,
               MsgRollBackward, MsgFindIntersect, MsgIntersectFound,
               MsgIntersectNotFound, MsgDone])


def make_codec(header_decode) -> Codec:
    """Codec with a custom header decoder (per-block-type codecs, the
    reference's `codecChainSync` parameterised over the header —
    Protocol/ChainSync/Codec.hs).  header_decode: CBOR object -> header."""
    class _RollForward(MsgRollForward):
        @classmethod
        def decode_args(cls, a):
            from ...utils import cbor
            return cls(header_decode(cbor.unwrap_tag24(a[0])),
                       Tip.decode(a[1]))
    _RollForward.__name__ = "MsgRollForward"
    return Codec([MsgRequestNext, MsgAwaitReply, _RollForward,
                  MsgRollBackward, MsgFindIntersect, MsgIntersectFound,
                  MsgIntersectNotFound, MsgDone])


async def server_from_producer(session, producer_state, fid: int,
                               header_of=None):
    """ChainSync server driven by a ChainProducerState follower
    (Examples.hs's chainSyncServerExample).

    header_of: block -> header to advertise (default: .header attribute).
    When the follower is caught up the server sends MsgAwaitReply and then
    blocks on the producer's version TVar until the chain changes (the
    followerInstructionBlocking semantics) — no polling.
    """
    from ... import simharness as sim
    from ...simharness import Retry

    hdr = header_of or (lambda b: b.header)

    def tip() -> Tip:
        ch = producer_state.chain
        return Tip(ch.head_point, ch.head_block_no)

    while True:
        msg = await session.recv()
        if isinstance(msg, MsgDone):
            return
        if isinstance(msg, MsgFindIntersect):
            found = None
            for p in msg.points:
                if producer_state.chain.contains_point(p):
                    found = p
                    break
            if found is None:
                await session.send(MsgIntersectNotFound(tip()))
            else:
                producer_state.set_follower_point(fid, found)
                await session.send(MsgIntersectFound(found, tip()))
            continue
        # MsgRequestNext
        ins = producer_state.follower_instruction(fid)
        if ins is None:
            await session.send(MsgAwaitReply())
            while ins is None:
                # read the version and re-check the instruction with no
                # yield point in between: a block added during the
                # MsgAwaitReply send (or any earlier await) is seen here
                # instead of being lost to the wait below
                seen = producer_state.version.value
                ins = producer_state.follower_instruction(fid)
                if ins is not None:
                    break

                def wait_change(tx, seen=seen):
                    if tx.read(producer_state.version) == seen:
                        raise Retry()
                await sim.atomically(wait_change)
                ins = producer_state.follower_instruction(fid)
        kind, payload = ins
        if kind == "forward":
            await session.send(MsgRollForward(hdr(payload), tip()))
        else:
            await session.send(MsgRollBackward(payload, tip()))


async def client_sync_to_tip(session, points: Sequence[Point],
                             fragment, header_store: Optional[dict] = None):
    """Simple (unpipelined) client: find intersection, follow until caught
    up to the server tip, then MsgDone.  Updates `fragment`
    (AnchoredFragment of headers) in place; used by tests and as the shape
    model for the consensus ChainSync client."""
    await session.send(MsgFindIntersect(tuple(points)))
    reply = await session.recv()
    if isinstance(reply, MsgIntersectNotFound):
        await session.send(MsgDone())
        return None
    while True:
        await session.send(MsgRequestNext())
        msg = await session.recv()
        if isinstance(msg, MsgAwaitReply):
            # caught up: stop following (test client semantics)
            msg = await session.recv()
            await _apply(msg, fragment, header_store)
            await session.send(MsgDone())
            return fragment
        await _apply(msg, fragment, header_store)
        if fragment.head_point == msg.tip.point:
            await session.send(MsgDone())
            return fragment


async def _apply(msg, fragment, header_store):
    if isinstance(msg, MsgRollForward):
        fragment.add_block(msg.header)
        if header_store is not None:
            header_store[msg.header.hash] = msg.header
    elif isinstance(msg, MsgRollBackward):
        if not fragment.truncate_to(msg.point):
            raise RuntimeError("server rolled back beyond our fragment")
    else:
        raise RuntimeError(f"unexpected {msg}")
