"""AnchoredFragment — the workhorse chain-suffix type.

Reference: ouroboros-network/src/Ouroboros/Network/AnchoredFragment.hs (built
on AnchoredSeq.hs's finger tree).  A fragment is a contiguous run of
headers/blocks anchored at a Point (exclusive); the anchor is where the
fragment attaches to the rest of the chain.  Python rebuild uses a list +
hash index: O(1) head/lookup, O(n) copy on rollback — fragments are bounded
by k (=security parameter) in all uses, so this is the right simplicity
trade (SURVEY.md §5 "long-context": k-bounded suffix).

Ported from `ouroboros_tpu/chain/fragment.py` (the port imports nothing of
the JAX package). Copied whole.
"""
from __future__ import annotations

from typing import Generic, Iterable, Optional, Sequence, TypeVar

from .block import Point, point_of

B = TypeVar("B")   # anything HasHeader


class AnchoredFragment(Generic[B]):
    __slots__ = ("anchor", "anchor_block_no", "_blocks", "_index")

    def __init__(self, anchor: Point, blocks: Iterable[B] = (),
                 anchor_block_no: int = -1):
        self.anchor = anchor
        self.anchor_block_no = anchor_block_no
        self._blocks: list[B] = list(blocks)
        self._index = {b.hash: i for i, b in enumerate(self._blocks)}

    # -- construction --------------------------------------------------------
    @classmethod
    def from_genesis(cls) -> "AnchoredFragment[B]":
        return cls(Point.genesis())

    def copy(self) -> "AnchoredFragment[B]":
        new = type(self).__new__(type(self))
        new.anchor = self.anchor
        new.anchor_block_no = self.anchor_block_no
        new._blocks = list(self._blocks)
        new._index = dict(self._index)
        return new

    # -- queries -------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._blocks)

    def __iter__(self):
        return iter(self._blocks)

    @property
    def blocks(self) -> Sequence[B]:
        return self._blocks

    @property
    def head(self) -> Optional[B]:
        return self._blocks[-1] if self._blocks else None

    @property
    def head_point(self) -> Point:
        return point_of(self._blocks[-1]) if self._blocks else self.anchor

    @property
    def head_block_no(self) -> int:
        return self._blocks[-1].block_no if self._blocks \
            else self.anchor_block_no

    def contains_point(self, p: Point) -> bool:
        if p == self.anchor:
            return True
        i = self._index.get(p.hash)
        return i is not None and self._blocks[i].slot == p.slot

    def lookup(self, h: bytes) -> Optional[B]:
        i = self._index.get(h)
        return self._blocks[i] if i is not None else None

    def points(self) -> list[Point]:
        """All points, newest first (for ChainSync intersection finding)."""
        return [point_of(b) for b in reversed(self._blocks)] + [self.anchor]

    def select_points(self, offsets: Sequence[int]) -> list[Point]:
        """Points at the given offsets back from the head (0 = head) —
        O(len(offsets)), not O(fragment)."""
        n = len(self._blocks)
        out = []
        for o in offsets:
            if o < n:
                out.append(point_of(self._blocks[n - 1 - o]))
            elif o == n:
                out.append(self.anchor)
        return out

    # -- modification --------------------------------------------------------
    def add_block(self, b: B) -> None:
        """Extend at the head; validates the prev-hash link (the genesis
        anchor's hash is the all-zero GENESIS_HASH, so the check is total)."""
        expect = self._blocks[-1].hash if self._blocks else self.anchor.hash
        if b.prev_hash != expect:
            raise ValueError("block does not link onto fragment head")
        self._index[b.hash] = len(self._blocks)
        self._blocks.append(b)

    def _rebuild(self, anchor: Point, blocks,
                 anchor_block_no: int) -> "AnchoredFragment[B]":
        """Construct a fragment of the same (sub)class without going through
        the subclass __init__ (subclasses may narrow its signature)."""
        new = type(self).__new__(type(self))
        AnchoredFragment.__init__(new, anchor, blocks, anchor_block_no)
        return new

    def rollback(self, p: Point) -> Optional["AnchoredFragment[B]"]:
        """Fragment truncated so head == p; None if p not on the fragment.
        Preserves the subclass (Chain.rollback returns a Chain)."""
        if p == self.anchor:
            return self._rebuild(self.anchor, (), self.anchor_block_no)
        i = self._index.get(p.hash)
        if i is None or self._blocks[i].slot != p.slot:
            return None
        return self._rebuild(self.anchor, self._blocks[:i + 1],
                             self.anchor_block_no)

    def truncate_to(self, p: Point) -> bool:
        """In-place rollback so head == p; False if p not on the fragment."""
        if p == self.anchor:
            self._blocks.clear()
            self._index.clear()
            return True
        i = self._index.get(p.hash)
        if i is None or self._blocks[i].slot != p.slot:
            return False
        for b in self._blocks[i + 1:]:
            del self._index[b.hash]
        del self._blocks[i + 1:]
        return True

    def drop_newest(self, n: int) -> "AnchoredFragment[B]":
        keep = len(self._blocks) - n
        return self._rebuild(self.anchor, self._blocks[:max(keep, 0)],
                             self.anchor_block_no)

    def anchor_newer_than(self, k: int) -> "AnchoredFragment[B]":
        """Re-anchor so at most k newest blocks remain (the k-suffix)."""
        if len(self._blocks) <= k:
            return self
        cut = len(self._blocks) - k
        new_anchor_blk = self._blocks[cut - 1]
        return self._rebuild(point_of(new_anchor_blk), self._blocks[cut:],
                             new_anchor_blk.block_no)

    # -- comparisons ---------------------------------------------------------
    def intersect(self, other: "AnchoredFragment[B]") -> Optional[Point]:
        """Most recent common point, or None if unrelated.  Probes the
        hash index directly — no per-call set construction."""
        for b in reversed(other._blocks):
            if b.hash in self._index or b.hash == self.anchor.hash:
                return point_of(b)
        if other.anchor.hash in self._index \
                or other.anchor.hash == self.anchor.hash \
                or other.anchor == self.anchor:
            return other.anchor
        return None

    def after_point(self, p: Point) -> Optional[list[B]]:
        """Blocks strictly after point p; None if p not on fragment."""
        if p == self.anchor:
            return list(self._blocks)
        i = self._index.get(p.hash)
        if i is None:
            return None
        return self._blocks[i + 1:]
