"""Era history: slot ↔ epoch ↔ wallclock translation across eras.

Reference: ouroboros-consensus/src/Ouroboros/Consensus/HardFork/History/
{EraParams,Summary,Qry}.hs — `EraParams` {epoch size, slot length, safe
zone}, `Bound` (aligned time/slot/epoch triple), `EraSummary` [start,end),
`Summary` = non-empty era list, and the `Qry` interpreter.  The reference
compiles queries to a small DSL and interprets them against the summary;
here the summary answers directly — same totality properties: queries past
the final era's end raise PastHorizon.

Ported from `ouroboros_tpu/consensus/hardfork/history.py` (the port imports
nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence


class PastHorizon(Exception):
    """Query beyond the known era summary (Qry.hs `PastHorizon`)."""


@dataclass(frozen=True)
class EraParams:
    """EraParams.hs: the shape of slots/epochs within one era."""
    epoch_size: int                  # slots per epoch
    slot_length: float               # seconds
    safe_zone: int = 0               # slots after the tip with era certainty


@dataclass(frozen=True)
class Bound:
    """An era boundary, aligned on all three scales (Summary.hs `Bound`)."""
    time: float
    slot: int
    epoch: int


@dataclass(frozen=True)
class EraSummary:
    """One era's extent: [start, end) with end None = open (final era)."""
    start: Bound
    end: Optional[Bound]
    params: EraParams

    def contains_slot(self, slot: int) -> bool:
        return slot >= self.start.slot and \
            (self.end is None or slot < self.end.slot)

    def contains_time(self, t: float) -> bool:
        return t >= self.start.time and \
            (self.end is None or t < self.end.time)

    def next_bound(self, end_epoch: int) -> Bound:
        """The aligned bound where this era ends at `end_epoch`."""
        n_epochs = end_epoch - self.start.epoch
        n_slots = n_epochs * self.params.epoch_size
        return Bound(self.start.time + n_slots * self.params.slot_length,
                     self.start.slot + n_slots,
                     end_epoch)


class Summary:
    """Non-empty era list; the query interpreter (Summary.hs, Qry.hs)."""

    def __init__(self, eras: Sequence[EraSummary]):
        assert eras, "summary must be non-empty"
        self.eras = list(eras)

    @classmethod
    def from_era_params(cls, params: Sequence[EraParams],
                        transitions: Sequence[int]) -> "Summary":
        """Build from per-era params + transition epochs (era i ends at
        transitions[i]); the final era is open-ended."""
        assert len(transitions) == len(params) - 1
        eras: list[EraSummary] = []
        start = Bound(0.0, 0, 0)
        for i, p in enumerate(params):
            if i < len(transitions):
                era = EraSummary(start, None, p)
                end = era.next_bound(transitions[i])
                eras.append(EraSummary(start, end, p))
                start = end
            else:
                eras.append(EraSummary(start, None, p))
        return cls(eras)

    def _era_for_slot(self, slot: int) -> EraSummary:
        for e in self.eras:
            if e.contains_slot(slot):
                return e
        raise PastHorizon(f"slot {slot} beyond summary")

    def _era_for_time(self, t: float) -> EraSummary:
        for e in self.eras:
            if e.contains_time(t):
                return e
        raise PastHorizon(f"time {t} beyond summary")

    def _era_for_epoch(self, epoch: int) -> EraSummary:
        for e in self.eras:
            if epoch >= e.start.epoch and \
                    (e.end is None or epoch < e.end.epoch):
                return e
        raise PastHorizon(f"epoch {epoch} beyond summary")

    # -- the queries (Qry.hs) ------------------------------------------------
    def slot_to_epoch(self, slot: int) -> tuple[int, int]:
        """(epoch, slot offset within the epoch)."""
        e = self._era_for_slot(slot)
        d = slot - e.start.slot
        return (e.start.epoch + d // e.params.epoch_size,
                d % e.params.epoch_size)

    def epoch_to_first_slot(self, epoch: int) -> int:
        e = self._era_for_epoch(epoch)
        return e.start.slot + (epoch - e.start.epoch) * e.params.epoch_size

    def slot_to_wallclock(self, slot: int) -> float:
        e = self._era_for_slot(slot)
        return e.start.time + (slot - e.start.slot) * e.params.slot_length

    def wallclock_to_slot(self, t: float) -> int:
        e = self._era_for_time(t)
        return e.start.slot + int((t - e.start.time) / e.params.slot_length)

    def slot_length_at(self, slot: int) -> float:
        return self._era_for_slot(slot).params.slot_length

    def era_index_of_slot(self, slot: int) -> int:
        for i, e in enumerate(self.eras):
            if e.contains_slot(slot):
                return i
        raise PastHorizon(f"slot {slot} beyond summary")
