"""BlockFetch — range-batched block download.

Reference: ouroboros-network/src/Ouroboros/Network/Protocol/BlockFetch/
Type.hs:27-54 (MsgRequestRange/MsgStartBatch/MsgBlock/MsgBatchDone/
MsgNoBlocks) + Server/Client wrappers.

Ported from `ouroboros_tpu/network/protocols/blockfetch.py` (the port
imports nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass

from ...chain import Block, Point
from ..typed import CLIENT, NOBODY, SERVER, ProtocolSpec
from .codec import Codec


@dataclass(frozen=True)
class MsgRequestRange:
    TAG = 0
    start: Point       # inclusive
    end: Point         # inclusive

    def encode_args(self):
        return [self.start.encode(), self.end.encode()]

    @classmethod
    def decode_args(cls, a):
        return cls(Point.decode(a[0]), Point.decode(a[1]))


@dataclass(frozen=True)
class MsgClientDone:
    TAG = 1

    def encode_args(self):
        return []

    @classmethod
    def decode_args(cls, a):
        return cls()


@dataclass(frozen=True)
class MsgStartBatch:
    TAG = 2

    def encode_args(self):
        return []

    @classmethod
    def decode_args(cls, a):
        return cls()


@dataclass(frozen=True)
class MsgNoBlocks:
    TAG = 3

    def encode_args(self):
        return []

    @classmethod
    def decode_args(cls, a):
        return cls()


@dataclass(frozen=True)
class MsgBlock:
    TAG = 4
    block: Block

    def encode_args(self):
        # msgBlock = [4, #6.24(bytes .cbor block)] (messages.cddl:55):
        # blocks travel tag-24 CBOR-in-CBOR wrapped
        from ...utils import cbor
        return [cbor.Tag(24, cbor.dumps(self.block.encode()))]

    @classmethod
    def decode_args(cls, a):
        from ...utils import cbor
        return cls(Block.decode(cbor.unwrap_tag24(a[0])))


@dataclass(frozen=True)
class MsgBatchDone:
    TAG = 5

    def encode_args(self):
        return []

    @classmethod
    def decode_args(cls, a):
        return cls()


SPEC = ProtocolSpec(
    name="block-fetch",
    init_state="BFIdle",
    agency={"BFIdle": CLIENT, "BFBusy": SERVER, "BFStreaming": SERVER,
            "BFDone": NOBODY},
    transitions={
        ("BFIdle", "MsgRequestRange"): "BFBusy",
        ("BFIdle", "MsgClientDone"): "BFDone",
        ("BFBusy", "MsgStartBatch"): "BFStreaming",
        ("BFBusy", "MsgNoBlocks"): "BFIdle",
        ("BFStreaming", "MsgBlock"): "BFStreaming",
        ("BFStreaming", "MsgBatchDone"): "BFIdle",
    })

CODEC = Codec([MsgRequestRange, MsgClientDone, MsgStartBatch, MsgNoBlocks,
               MsgBlock, MsgBatchDone])


def make_codec(block_decode) -> Codec:
    """Codec with a custom block decoder (codecBlockFetch parameterised
    over the block type — Protocol/BlockFetch/Codec.hs)."""
    class _Block(MsgBlock):
        @classmethod
        def decode_args(cls, a):
            from ...utils import cbor
            return cls(block_decode(cbor.unwrap_tag24(a[0])))
    _Block.__name__ = "MsgBlock"
    return Codec([MsgRequestRange, MsgClientDone, MsgStartBatch,
                  MsgNoBlocks, _Block, MsgBatchDone])


async def server_from_blocks(session, lookup_range):
    """Server: lookup_range(start, end) -> list[Block] | None.

    Reference: BlockFetch/Server.hs serving from a ChainDB iterator."""
    while True:
        msg = await session.recv()
        if isinstance(msg, MsgClientDone):
            return
        blocks = lookup_range(msg.start, msg.end)
        if not blocks:
            await session.send(MsgNoBlocks())
            continue
        await session.send(MsgStartBatch())
        for b in blocks:
            await session.send(MsgBlock(b))
        await session.send(MsgBatchDone())


async def fetch_range(session, start: Point, end: Point):
    """Client one-shot: request a range, collect the batch (or None)."""
    await session.send(MsgRequestRange(start, end))
    msg = await session.recv()
    if isinstance(msg, MsgNoBlocks):
        return None
    blocks = []
    while True:
        msg = await session.recv()
        if isinstance(msg, MsgBatchDone):
            return blocks
        blocks.append(msg.block)
