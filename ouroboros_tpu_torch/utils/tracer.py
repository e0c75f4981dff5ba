"""Contravariant tracers + the per-subsystem tracer record.

Reference: the `Tracer m a` threaded through every constructor
(contra-tracer; consensus bundle at Node/Tracers.hs:51-62, ChainDB event
schema in Storage/ChainDB/Impl/Types.hs `TraceAddBlockEvent`).  The
events are TYPED dataclasses — the log schema — so tests assert on
decision events rather than string-matching a debug log.

The default tracers forward into the simulator's dynamic trace
(sim.trace_event), so every event is also visible in `run_trace` output;
`collecting()` returns a tracer+list pair for assertions.

Ported from `ouroboros_tpu/utils/tracer.py` (the port imports nothing of
the JAX package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional


class Tracer:
    """Contravariant event sink (Tracer m a).  nop tracers are free:
    trace() is a no-op when no emit function is attached."""

    __slots__ = ("_emit",)

    def __init__(self, emit: Optional[Callable[[Any], None]] = None):
        self._emit = emit

    def trace(self, ev: Any) -> None:
        if self._emit is not None:
            self._emit(ev)

    def contramap(self, f: Callable[[Any], Any]) -> "Tracer":
        if self._emit is None:
            return self
        return Tracer(lambda ev: self.trace(f(ev)))

    @property
    def active(self) -> bool:
        return self._emit is not None


NOP = Tracer()


def collecting() -> tuple[Tracer, list]:
    """(tracer, events) — events appended in trace order, for tests."""
    out: list = []
    return Tracer(out.append), out


def sim_tracer(label: str) -> Tracer:
    """Tracer into the simulator/runtime dynamic trace (traceM analog)."""
    from .. import simharness as sim
    return Tracer(lambda ev: sim.trace_event(ev, label))


# ---------------------------------------------------------------------------
# Event schemas (the typed log surface)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TraceAddBlock:
    """ChainDB.add_block outcome (TraceAddBlockEvent analog)."""
    kind: str                  # extended | switched | stored | ...
    slot: int
    block_no: int
    hash: bytes


@dataclass(frozen=True)
class TraceSwitchedToFork:
    """Chain selection adopted a fork (SwitchedToAFork)."""
    old_tip_slot: int
    new_tip_slot: int
    rollback_depth: int


@dataclass(frozen=True)
class TraceInvalidBlock:
    hash: bytes
    reason: str


@dataclass(frozen=True)
class TraceForgeEvent:
    """One slot's forging outcome (TraceForgeEvent analog)."""
    slot: int
    outcome: str               # forged | not-leader | error
    detail: str = ""


@dataclass(frozen=True)
class TraceFetchDecision:
    """One BlockFetch governor decision for one peer
    (TraceFetchDecision analog)."""
    peer_id: Any
    n_requested: int
    in_flight_bytes: int
    reason: str                # request | throttled | nothing-to-fetch


@dataclass(frozen=True)
class TraceChainSyncEvent:
    """ChainSync client progress (TraceChainSyncClientEvent analog)."""
    peer_id: Any
    event: str                 # roll-forward | roll-backward | validated
    slot: int
    n: int = 1


@dataclass
class NodeTracers:
    """The per-subsystem tracer bundle handed to the node constructors
    (Node/Tracers.hs:51-62)."""
    chain_db: Tracer = NOP
    forge: Tracer = NOP
    fetch: Tracer = NOP
    chain_sync: Tracer = NOP

    @classmethod
    def nop(cls) -> "NodeTracers":
        return cls()

    @classmethod
    def for_sim(cls, label: str) -> "NodeTracers":
        return cls(chain_db=sim_tracer(f"{label}.chaindb"),
                   forge=sim_tracer(f"{label}.forge"),
                   fetch=sim_tracer(f"{label}.fetch"),
                   chain_sync=sim_tracer(f"{label}.chainsync"))
