"""Chain + ChainProducerState — producer-side follower bookkeeping.

Reference: ouroboros-network/src/Ouroboros/Network/MockChain/Chain.hs:94 and
MockChain/ProducerState.hs:22-171.  ChainProducerState tracks, per follower,
the read pointer on the producer's chain; the ChainSync server is driven off
it (next_change / rollback semantics).

Ported from `ouroboros_tpu/chain/chain.py` (the port imports nothing of the
JAX package). Copied whole.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional

from .block import Point, point_of
from .fragment import AnchoredFragment


class Chain(AnchoredFragment):
    """A genesis-anchored fragment (the mock whole-chain type)."""

    def __init__(self, blocks=()):
        super().__init__(Point.genesis(), blocks)


@dataclass
class _FollowerState:
    # next_to_send: index into chain of next block to send; None => must
    # first send a rollback to `point`
    point: Point
    needs_rollback: bool


class ChainProducerState:
    """Producer chain + per-follower read pointers (ProducerState.hs:22)."""

    def __init__(self, chain: Optional[Chain] = None):
        self.chain: Chain = chain or Chain()
        self._followers: dict[int, _FollowerState] = {}
        self._ids = itertools.count()
        # bumped on every chain change; ChainSync servers block on it
        from ..simharness import TVar
        self.version = TVar(0, label="producer.version")

    def _bump(self) -> None:
        from ..simharness import core
        if core._current_sim is not None:
            self.version.set_notify(self.version.value + 1)
        else:
            self.version._value += 1

    # -- follower management -------------------------------------------------
    def new_follower(self, intersection: Point = None) -> int:
        fid = next(self._ids)
        pt = intersection if intersection is not None else Point.genesis()
        self._followers[fid] = _FollowerState(pt, needs_rollback=True)
        return fid

    def remove_follower(self, fid: int) -> None:
        self._followers.pop(fid, None)

    def set_follower_point(self, fid: int, p: Point) -> bool:
        if not self.chain.contains_point(p):
            return False
        self._followers[fid] = _FollowerState(p, needs_rollback=True)
        return True

    # -- chain updates ---------------------------------------------------------
    def add_block(self, b) -> None:
        self.chain.add_block(b)
        self._bump()

    def rollback(self, p: Point) -> bool:
        new_chain = self.chain.copy()
        if not new_chain.truncate_to(p):
            return False
        self.chain = new_chain
        for fs in self._followers.values():
            if not self.chain.contains_point(fs.point):
                fs.point = p
                fs.needs_rollback = True
        self._bump()
        return True

    def switch_fork(self, p: Point, new_blocks) -> bool:
        if not self.rollback(p):
            return False
        for b in new_blocks:
            self.chain.add_block(b)
        return True

    # -- the ChainSync server's pull API --------------------------------------
    def follower_instruction(self, fid: int):
        """Returns ("rollback", Point) | ("forward", block) | None (idle).

        Mirrors ProducerState.hs's followerInstruction."""
        fs = self._followers[fid]
        if fs.needs_rollback:
            fs.needs_rollback = False
            return ("rollback", fs.point)
        nxt = self.chain.after_point(fs.point)
        if nxt is None:   # pointer fell off (shouldn't happen: rollback fixes)
            fs.point = self.chain.anchor
            fs.needs_rollback = False
            return ("rollback", fs.point)
        if not nxt:
            return None
        b = nxt[0]
        fs.point = point_of(b)
        return ("forward", b)
