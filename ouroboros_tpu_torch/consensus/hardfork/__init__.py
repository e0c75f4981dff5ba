"""HardFork combinator — era composition.

Reference: ouroboros-consensus/src/Ouroboros/Consensus/HardFork/ (SURVEY.md
§2 L5 "HardFork Combinator"): n-ary era composition with cross-era state
translation, era-tagged blocks, and the slot↔epoch↔wallclock time
interpreter.  Rebuilt idiomatically: eras are first-class Python objects
with translation hooks; the Telescope GADT machinery collapses to an
(era_index, inner_state) pair because Python is untyped anyway.

Ported from `ouroboros_tpu/consensus/hardfork/__init__.py` (the port
imports nothing of the JAX package). Copied whole.
"""
from .history import Bound, EraParams, EraSummary, PastHorizon, Summary
from .combinator import (
    Era, HardForkLedger, HardForkProtocol, HardForkState, era_of_slot,
    hard_fork_rules,
)

__all__ = [
    "Bound", "EraParams", "EraSummary", "PastHorizon", "Summary",
    "Era", "HardForkLedger", "HardForkProtocol", "HardForkState",
    "era_of_slot", "hard_fork_rules",
]
