"""chain — chain primitives: Point/Tip and blocks.

Ported from `ouroboros_tpu/chain/__init__.py`, without `Chain`,
`ChainProducerState` and `AnchoredFragment` (chain.py, fragment.py),
which the replay does not import.
"""
from .block import (GENESIS_HASH, Block, BlockHeader, HasHeader, Point, Tip,
                    body_hash, make_block, point_of)

__all__ = ["GENESIS_HASH", "Block", "BlockHeader", "HasHeader", "Point",
           "Tip", "body_hash", "make_block", "point_of"]
