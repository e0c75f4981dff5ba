"""Header validation: envelope checks + chain-dep-state update.

Reference: ouroboros-consensus/src/Ouroboros/Consensus/HeaderValidation.hs —
`HeaderState` {tip, chainDep} (:154), envelope checks (blockNo/slot monotone,
prevHash link; :278 `ValidateEnvelope`), `validateHeader` = envelope +
`updateChainDepState` (:413-432), `revalidateHeader` (:436, re-apply without
crypto), `HeaderError` (:351); `HeaderStateHistory.hs` for ChainSync
rollback support.

Ported from `ouroboros_tpu/consensus/header_validation.py` (the port
imports nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from ..chain.block import GENESIS_HASH, Point, point_of
from .protocol import ConsensusProtocol


class HeaderError(Exception):
    """Envelope or protocol-level header validation failure."""


class HeaderEnvelopeError(HeaderError):
    """blockNo / slot / prevHash relation violated (HeaderError:351)."""


@dataclass(frozen=True)
class AnnTip:
    """Annotated tip of the validated header chain (HeaderValidation.hs:97).

    is_ebb mirrors the reference's TipInfoIsEBB: a Byron EBB's successor is
    allowed to occupy the same slot (minimumNextSlotNo)."""
    slot: int
    block_no: int
    hash: bytes
    is_ebb: bool = False

    @property
    def point(self) -> Point:
        return Point(self.slot, self.hash)


@dataclass(frozen=True)
class HeaderState:
    """State needed to validate the next header (HeaderValidation.hs:154)."""
    tip: Optional[AnnTip]          # None = genesis
    chain_dep_state: Any

    @classmethod
    def genesis(cls, protocol: ConsensusProtocol) -> "HeaderState":
        return cls(None, protocol.initial_chain_dep_state())

    @property
    def tip_point(self) -> Point:
        return self.tip.point if self.tip else Point.genesis()


def validate_envelope(header: Any, header_state: HeaderState,
                      protocol: ConsensusProtocol) -> None:
    """The cheap structural checks (HeaderValidation.hs:278-349):
    block number increments, slot strictly increases, prev hash links.

    Epoch-boundary blocks (header field "ebb", the Byron-era quirk of
    Block/EBB.hs + the era-specific `ValidateEnvelope` instances) share
    their predecessor's block number instead of incrementing it; only
    protocols declaring `accepts_ebb` admit them (Shelley-family eras have
    none), and an EBB's successor may share the EBB's slot
    (minimumNextSlotNo)."""
    tip = header_state.tip
    is_ebb = _is_ebb(header)
    if is_ebb and not getattr(protocol, "accepts_ebb", False):
        raise HeaderEnvelopeError(
            "EBB header in an era whose protocol admits no EBBs")
    if tip is None:
        expected_block_no, min_slot, expected_prev = 0, 0, GENESIS_HASH
    else:
        expected_block_no = tip.block_no if is_ebb else tip.block_no + 1
        # only the REAL block following an EBB may share its slot; an EBB
        # can never reuse its predecessor's slot
        min_slot = tip.slot if (tip.is_ebb and not is_ebb) else tip.slot + 1
        expected_prev = tip.hash
    if header.block_no != expected_block_no:
        raise HeaderEnvelopeError(
            f"unexpected block number {header.block_no}, "
            f"expected {expected_block_no}")
    if header.slot < min_slot:
        raise HeaderEnvelopeError(
            f"slot {header.slot} not after tip slot {min_slot - 1}")
    if header.prev_hash != expected_prev:
        raise HeaderEnvelopeError(
            f"prev hash mismatch at slot {header.slot}: "
            f"{header.prev_hash.hex()[:16]} != {expected_prev.hex()[:16]}")


def _is_ebb(header: Any) -> bool:
    return bool(header.get("ebb", 0)) if hasattr(header, "get") else False


def ann_tip_of(header: Any) -> AnnTip:
    return AnnTip(header.slot, header.block_no, header.hash, _is_ebb(header))


def validate_header(protocol: ConsensusProtocol, ledger_view: Any,
                    header: Any, header_state: HeaderState,
                    backend=None) -> HeaderState:
    """Envelope + full crypto chain-dep update (validateHeader, :413-432)."""
    validate_envelope(header, header_state, protocol)
    ticked = protocol.tick_chain_dep_state(
        header_state.chain_dep_state, ledger_view, header.slot)
    try:
        new_dep = protocol.update_chain_dep_state(
            ticked, header, ledger_view, backend=backend)
    except Exception as e:
        raise HeaderError(f"chain-dep update failed: {e}") from e
    return HeaderState(ann_tip_of(header), new_dep)


def revalidate_header(protocol: ConsensusProtocol, ledger_view: Any,
                      header: Any, header_state: HeaderState) -> HeaderState:
    """Re-apply a previously-validated header, no crypto (revalidateHeader,
    :436)."""
    validate_envelope(header, header_state, protocol)
    ticked = protocol.tick_chain_dep_state(
        header_state.chain_dep_state, ledger_view, header.slot)
    new_dep = protocol.reupdate_chain_dep_state(ticked, header, ledger_view)
    return HeaderState(ann_tip_of(header), new_dep)


class HeaderStateHistory:
    """Bounded history of HeaderStates supporting rollback-to-point
    (HeaderStateHistory.hs) — used by the ChainSync client when the server
    rolls back."""

    def __init__(self, k: int, initial: HeaderState):
        self.k = k
        self._states: list[HeaderState] = [initial]   # oldest..newest

    @property
    def current(self) -> HeaderState:
        return self._states[-1]

    def append(self, state: HeaderState) -> None:
        self._states.append(state)
        # keep k states *past* the anchor so any rollback ≤ k succeeds
        if len(self._states) > self.k + 1:
            del self._states[0:len(self._states) - (self.k + 1)]

    def rewind(self, point: Point) -> bool:
        """Roll back so `current` has tip == point. False if too deep."""
        for i in range(len(self._states) - 1, -1, -1):
            if self._states[i].tip_point == point:
                del self._states[i + 1:]
                return True
        return False
