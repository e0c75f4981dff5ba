"""chain — chain primitives: Point/Tip, blocks, AnchoredFragment, Chain.

Reference: ouroboros-network Block.hs / AnchoredFragment.hs / MockChain/*.

Ported from `ouroboros_tpu/chain/__init__.py`, with the same exports.
"""
from .block import (GENESIS_HASH, Block, BlockHeader, HasHeader, Point, Tip,
                    body_hash, make_block, point_of)
from .chain import Chain, ChainProducerState
from .fragment import AnchoredFragment

__all__ = ["GENESIS_HASH", "Block", "BlockHeader", "HasHeader", "Point",
           "Tip", "body_hash", "make_block", "point_of", "Chain",
           "ChainProducerState", "AnchoredFragment"]
