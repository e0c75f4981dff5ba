"""Ledger abstraction and the extended ledger state.

Reference: ouroboros-consensus/src/Ouroboros/Consensus/Ledger/{Basics,
Abstract}.hs (`IsLedger`/`ApplyBlock`: applyChainTick, applyLedgerBlock,
reapplyLedgerBlock), Ledger/Extended.hs:52,142-163 (`ExtLedgerState` =
ledger × header-state and its ApplyBlock instance — "the single seam through
which all block validation flows"), Ledger/SupportsProtocol.hs (ledger-view
projection + forecast), Forecast.hs.

Ported from `ouroboros_tpu/consensus/ledger.py` (the port imports nothing
of the JAX package). Copied whole.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from ..chain.block import Point
from .header_validation import (
    HeaderState, revalidate_header, validate_header,
)
from .protocol import ConsensusProtocol


class LedgerError(Exception):
    """Block failed ledger rules (applyLedgerBlock failure)."""


class OutsideForecastRange(Exception):
    """Requested slot beyond the ledger view forecast horizon
    (Forecast.hs OutsideForecastRange)."""


class LedgerRules:
    """IsLedger + ApplyBlock + LedgerSupportsProtocol in one trait.

    State values are immutable; every method returns a new state.
    """

    def initial_state(self) -> Any:
        raise NotImplementedError

    def tip(self, state: Any) -> Point:
        raise NotImplementedError

    # -- applying blocks ------------------------------------------------------
    def tick(self, state: Any, slot: int) -> Any:
        """Time-based state evolution, no block (applyChainTick)."""
        return state

    def apply_block(self, ticked: Any, block: Any, backend=None) -> Any:
        """Full checks incl. tx witness crypto; raises LedgerError."""
        raise NotImplementedError

    def reapply_block(self, ticked: Any, block: Any) -> Any:
        """Known-valid block, skip expensive checks (reapplyLedgerBlock)."""
        return self.apply_block(ticked, block)

    # -- the batching seam (tx-witness analog of protocol.extract_proofs) ----
    def sequential_checks(self, ticked: Any, block: Any) -> None:
        """Cheap structural body checks that must run even on the batched
        path (e.g. witness presence); raises LedgerError."""

    def extract_proofs(self, ticked: Any, block: Any) -> list:
        """Independent crypto obligations of the block body (the reference's
        BBODY Ed25519 witness multi-verify — Shelley/Ledger/Ledger.hs:279).
        Default: none (mock ledgers check structurally)."""
        return []

    def tx_proofs(self, state: Any, tx: Any) -> Optional[list]:
        """Independent crypto obligations of ONE tx — the mempool
        admission unit (extract_proofs at tx granularity).  The adaptive
        batching service pre-verifies these coalesced with other
        threads' traffic, then apply_tx runs with the verdicts honored
        (Mempool.try_add_txs_async).  None = unknown: witness crypto
        stays inside apply_tx and the service path degrades to the
        plain synchronous admission."""
        return None

    # -- protocol support -----------------------------------------------------
    def ledger_view(self, state: Any) -> Any:
        """Projection consumed by the consensus protocol
        (LedgerSupportsProtocol.protocolLedgerView)."""
        return None

    def forecast_view(self, state: Any, slot: int) -> Any:
        """Ledger view at a *future* slot; raises OutsideForecastRange when
        `slot` is beyond the stability horizon (ledgerViewForecastAt)."""
        return self.ledger_view(state)


@dataclass(frozen=True)
class ExtLedgerState:
    """Ledger state × header state (Ledger/Extended.hs:52)."""
    ledger: Any
    header: HeaderState


class ExtLedgerRules:
    """ApplyBlock for ExtLedgerState (Extended.hs:142-163): ledger apply +
    validateHeader, combined.  All chain validation flows through here."""

    def __init__(self, protocol: ConsensusProtocol, ledger: LedgerRules):
        self.protocol = protocol
        self.ledger = ledger

    def initial_state(self) -> ExtLedgerState:
        return ExtLedgerState(self.ledger.initial_state(),
                              HeaderState.genesis(self.protocol))

    def tip(self, ext: ExtLedgerState) -> Point:
        return ext.header.tip_point

    def tick_then_apply(self, ext: ExtLedgerState, block: Any,
                        backend=None) -> ExtLedgerState:
        """Full validation: header crypto + ledger rules (ApplyVal path).
        The header validates against the view forecast AT ITS SLOT — for
        era-composed ledgers this is the cross-era view when the block
        sits past a transition."""
        ticked_ledger = self.ledger.tick(ext.ledger, block.slot)
        view = self.ledger.forecast_view(ext.ledger, block.slot)
        header = getattr(block, "header", block)
        new_header = validate_header(self.protocol, view, header, ext.header,
                                     backend=backend)
        new_ledger = self.ledger.apply_block(ticked_ledger, block,
                                             backend=backend)
        return ExtLedgerState(new_ledger, new_header)

    def tick_then_reapply(self, ext: ExtLedgerState,
                          block: Any) -> ExtLedgerState:
        """Known-valid block: no crypto (ReapplyVal path; used for replay)."""
        ticked_ledger = self.ledger.tick(ext.ledger, block.slot)
        view = self.ledger.forecast_view(ext.ledger, block.slot)
        header = getattr(block, "header", block)
        new_header = revalidate_header(self.protocol, view, header,
                                       ext.header)
        new_ledger = self.ledger.reapply_block(ticked_ledger, block)
        return ExtLedgerState(new_ledger, new_header)
