"""Chain primitives: Point, Tip, headers/blocks.

Reference: ouroboros-network/src/Ouroboros/Network/Block.hs (HasHeader,
Point, Tip) and Testing/ConcreteBlock.hs (the concrete block used by
network-layer tests).  SlotNo/BlockNo are plain ints.

Ported from `ouroboros_tpu/chain/block.py` (the port imports nothing of
the JAX package). Copied whole; `chain/chain.py` and `chain/fragment.py`
are left out (the replay does not import them).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Optional, Protocol, Sequence, runtime_checkable

from ..utils import cbor

GENESIS_HASH = b"\x00" * 32


@dataclass(frozen=True, order=True)
class Point:
    """A point on a chain: (slot, header hash); origin = Point.genesis()."""
    slot: int
    hash: bytes

    @classmethod
    def genesis(cls) -> "Point":
        return cls(-1, GENESIS_HASH)

    @property
    def is_genesis(self) -> bool:
        return self.slot < 0

    def encode(self):
        """Reference wire grammar: origin = [], other points = [slot, hash]
        (ouroboros-network/test/messages.cddl:152-155)."""
        if self.is_genesis:
            return []
        return [self.slot, self.hash]

    @classmethod
    def decode(cls, obj) -> "Point":
        if len(obj) == 0:
            return cls.genesis()
        return cls(int(obj[0]), bytes(obj[1]))


@dataclass(frozen=True)
class Tip:
    """Tip of a chain as advertised by ChainSync: point + block number."""
    point: Point
    block_no: int

    @classmethod
    def genesis(cls) -> "Tip":
        return cls(Point.genesis(), -1)

    def encode(self):
        """tip = [point, uint] (messages.cddl:36); the genesis tip's
        block number is clamped to 0 on the wire (uint), recovered as
        Tip.genesis() on decode since origin admits no real block."""
        return [self.point.encode(), max(self.block_no, 0)]

    @classmethod
    def decode(cls, obj) -> "Tip":
        p = Point.decode(obj[0])
        if p.is_genesis:
            return cls.genesis()
        return cls(p, int(obj[1]))


@runtime_checkable
class HasHeader(Protocol):
    """Anything with (slot, block_no, hash, prev_hash) — headers and blocks."""
    slot: int
    block_no: int

    @property
    def hash(self) -> bytes: ...

    @property
    def prev_hash(self) -> bytes: ...


def point_of(b) -> Point:
    return Point(b.slot, b.hash)


@dataclass(frozen=True)
class BlockHeader:
    """Concrete test header (ConcreteBlock.hs analog).

    body_hash commits to the block body; signature/proof fields are attached
    by the consensus layer's header wrapper (consensus/headers.py)."""
    slot: int
    block_no: int
    prev_hash: bytes
    body_hash: bytes
    issuer: bytes = b""

    _hash_cache: dict = field(default_factory=dict, repr=False, hash=False,
                              compare=False)

    def encode(self):
        return [self.slot, self.block_no, self.prev_hash, self.body_hash,
                self.issuer]

    @classmethod
    def decode(cls, obj) -> "BlockHeader":
        return cls(int(obj[0]), int(obj[1]), bytes(obj[2]), bytes(obj[3]),
                   bytes(obj[4]))

    @property
    def bytes(self) -> bytes:
        return cbor.dumps(self.encode())

    @property
    def hash(self) -> bytes:
        c = self._hash_cache
        if "h" not in c:
            c["h"] = hashlib.blake2b(self.bytes, digest_size=32).digest()
        return c["h"]


@dataclass(frozen=True)
class Block:
    """Concrete test block: header + opaque tx list."""
    header: BlockHeader
    body: tuple = ()

    @property
    def slot(self) -> int:
        return self.header.slot

    @property
    def block_no(self) -> int:
        return self.header.block_no

    @property
    def hash(self) -> bytes:
        return self.header.hash

    @property
    def prev_hash(self) -> bytes:
        return self.header.prev_hash

    def encode(self):
        return [self.header.encode(), list(self.body)]

    @classmethod
    def decode(cls, obj) -> "Block":
        return cls(BlockHeader.decode(obj[0]),
                   tuple(bytes(t) if isinstance(t, (bytes, bytearray))
                         else t for t in obj[1]))

    @property
    def bytes(self) -> bytes:
        return cbor.dumps(self.encode())


def body_hash(body: Sequence) -> bytes:
    return hashlib.blake2b(cbor.dumps(list(body)), digest_size=32).digest()


def make_block(prev: Optional[Block], slot: int, body: Sequence = (),
               issuer: bytes = b"") -> Block:
    """Chain-extend helper for tests and the mock ledger."""
    if prev is None:
        prev_hash, block_no = GENESIS_HASH, 0
    else:
        prev_hash, block_no = prev.hash, prev.block_no + 1
    hdr = BlockHeader(slot=slot, block_no=block_no, prev_hash=prev_hash,
                      body_hash=body_hash(body), issuer=issuer)
    return Block(hdr, tuple(body))
