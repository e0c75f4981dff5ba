"""LeaderSchedule + ModChainSel — protocol combinators for tests.

Reference: ouroboros-consensus/src/Ouroboros/Consensus/Protocol/
LeaderSchedule.hs (WithLeaderSchedule: a static slot -> [node] map replaces
the underlying protocol's leader election, so test cases are inspectable and
shrinkable) and ModChainSel.hs (ModChainSel: swap the SelectView /
chain-ordering of an underlying protocol, delegating everything else).

Ported from `ouroboros_tpu/consensus/protocols/leader_schedule.py` (the port
imports nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Optional, Sequence

from ..protocol import ConsensusProtocol, ProtocolError


@dataclass(frozen=True)
class LeaderSchedule:
    """Slot -> list of leader node ids (LeaderSchedule.hs newtype)."""
    slots: Mapping[int, Sequence[int]]

    def leaders_of(self, slot: int) -> Sequence[int]:
        if slot not in self.slots:
            raise ProtocolError(f"LeaderSchedule: missing slot {slot}")
        return self.slots[slot]

    def slots_for(self, node_id: int) -> set:
        """The slots a given node leads (leaderScheduleFor)."""
        return {s for s, ls in self.slots.items() if node_id in ls}

    def merge(self, other: "LeaderSchedule") -> "LeaderSchedule":
        """Semigroup append: union of per-slot leader lists, left-biased
        dedup (LeaderSchedule.hs Semigroup instance)."""
        out = {s: list(ls) for s, ls in self.slots.items()}
        for s, rs in other.slots.items():
            ls = out.setdefault(s, [])
            ls.extend(n for n in rs if n not in ls)
        return LeaderSchedule(out)


class WithLeaderSchedule(ConsensusProtocol):
    """Extension of protocol `p` by a static leader schedule: leadership is
    read off the schedule; chain-dep state becomes trivial; chain selection
    still delegates to `p` (LeaderSchedule.hs ConsensusProtocol instance)."""

    def __init__(self, inner: ConsensusProtocol, schedule: LeaderSchedule,
                 node_id: int):
        self.inner = inner
        self.schedule = schedule
        self.node_id = node_id
        self.security_param = inner.security_param
        self.accepts_ebb = getattr(inner, "accepts_ebb", False)

    def initial_chain_dep_state(self):
        return ()

    def tick_chain_dep_state(self, state, ledger_view, slot):
        return ()

    def update_chain_dep_state(self, ticked, header, ledger_view,
                               backend=None):
        return ()

    def reupdate_chain_dep_state(self, ticked, header, ledger_view):
        return ()

    def check_is_leader(self, can_be_leader, slot, ticked, ledger_view):
        return () if self.node_id in self.schedule.leaders_of(slot) else None

    def select_view(self, header):
        return self.inner.select_view(header)

    def prefer_candidate(self, ours, candidate):
        return self.inner.prefer_candidate(ours, candidate)


class ModChainSel(ConsensusProtocol):
    """Swap chain selection of an underlying protocol: `view` projects a
    header to the new SelectView; everything else delegates
    (ModChainSel.hs)."""

    def __init__(self, inner: ConsensusProtocol,
                 view: Callable[[Any], Any],
                 prefer: Optional[Callable[[Any, Any], bool]] = None):
        self.inner = inner
        self.view = view
        self.prefer = prefer
        self.security_param = inner.security_param
        self.accepts_ebb = getattr(inner, "accepts_ebb", False)

    def initial_chain_dep_state(self):
        return self.inner.initial_chain_dep_state()

    def tick_chain_dep_state(self, state, ledger_view, slot):
        return self.inner.tick_chain_dep_state(state, ledger_view, slot)

    def update_chain_dep_state(self, ticked, header, ledger_view,
                               backend=None):
        return self.inner.update_chain_dep_state(ticked, header, ledger_view,
                                                 backend=backend)

    def reupdate_chain_dep_state(self, ticked, header, ledger_view):
        return self.inner.reupdate_chain_dep_state(ticked, header,
                                                   ledger_view)

    def sequential_checks(self, ticked, header, ledger_view):
        return self.inner.sequential_checks(ticked, header, ledger_view)

    def extract_proofs(self, ticked, header, ledger_view):
        return self.inner.extract_proofs(ticked, header, ledger_view)

    def check_is_leader(self, can_be_leader, slot, ticked, ledger_view):
        return self.inner.check_is_leader(can_be_leader, slot, ticked,
                                          ledger_view)

    def select_view(self, header):
        return self.view(header)

    def prefer_candidate(self, ours, candidate):
        if self.prefer is not None:
            return self.prefer(ours, candidate)
        return candidate > ours
