"""Protocol instantiations: so far mock Praos, whose evolving `HotKey` the
Shelley era forges with.

Ported from `ouroboros_tpu/consensus/protocols/__init__.py`; BFT, PBFT
and the LeaderSchedule combinators wait for the node layer.
"""
from .praos import (
    Praos, PraosConfig, PraosNode, PraosState, HotKey, praos_forge_fields,
)

__all__ = [
    "Praos", "PraosConfig", "PraosNode", "PraosState", "HotKey",
    "praos_forge_fields",
]
