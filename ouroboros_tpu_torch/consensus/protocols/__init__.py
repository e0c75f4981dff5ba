"""Protocol instantiations: BFT, PBFT, mock Praos, plus the LeaderSchedule
and ModChainSel combinators.

Reference: ouroboros-consensus/src/Ouroboros/Consensus/Protocol/
{BFT,PBFT,LeaderSchedule,ModChainSel}.hs and ouroboros-consensus-mock/src/
Ouroboros/Consensus/Mock/Protocol/Praos.hs.

Ported from `ouroboros_tpu/consensus/protocols/__init__.py`, with the same
exports.
"""
from .bft import Bft, bft_sign_header
from .leader_schedule import LeaderSchedule, ModChainSel, WithLeaderSchedule
from .pbft import PBft, pbft_sign_header
from .praos import (
    Praos, PraosConfig, PraosNode, PraosState, HotKey, praos_forge_fields,
)

__all__ = [
    "Bft", "bft_sign_header",
    "PBft", "pbft_sign_header",
    "Praos", "PraosConfig", "PraosNode", "PraosState", "HotKey",
    "praos_forge_fields",
    "LeaderSchedule", "WithLeaderSchedule", "ModChainSel",
]
