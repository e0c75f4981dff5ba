"""ConsensusProtocol — the protocol abstraction.

Reference: ouroboros-consensus/src/Ouroboros/Consensus/Protocol/Abstract.hs:50-178
(`ConsensusProtocol p` with associated types ChainDepState / IsLeader /
CanBeLeader / SelectView / LedgerView / ValidateView; methods checkIsLeader,
tickChainDepState, updateChainDepState, reupdateChainDepState,
protocolSecurityParam; preferCandidate at :178).

TPU-first redesign: associated types become duck-typed values; the crucial
addition is `extract_proofs`, which splits `updateChainDepState` into

    sequential cheap part  (nonce evolution, window bookkeeping — host)
  + independent proofs     (VRF / KES / Ed25519 — device batch)

so a window of headers is verified in ONE batched device call
(consensus/batch.py drives it; SURVEY.md §7 P3: "scan + vmapped-verify").
`update_chain_dep_state` remains the reference-shaped all-in-one entry used
by non-batched callers; it must equal extract_proofs + verify + reupdate.

Ported from `ouroboros_tpu/consensus/protocol.py` (the port imports
nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

from ..crypto.backend import CryptoBackend, default_backend


class ProtocolError(Exception):
    """ValidationErr analog — raised by update_chain_dep_state."""


class ConsensusProtocol:
    """Base class; subclasses are *configured instances* (config is self).

    security_param -- k: max rollback depth (protocolSecurityParam).
    """

    security_param: int = 2160

    # Whether this protocol's era admits epoch-boundary blocks; consulted by
    # validate_envelope (the reference gates EBBs per era via
    # ValidateEnvelope — only Byron has them).
    accepts_ebb: bool = False

    # -- chain-dependent state ------------------------------------------------
    def initial_chain_dep_state(self) -> Any:
        raise NotImplementedError

    def tick_chain_dep_state(self, state: Any, ledger_view: Any,
                             slot: int) -> Any:
        """Advance state to `slot` with no header (tickChainDepState)."""
        return state

    def update_chain_dep_state(self, ticked: Any, header: Any,
                               ledger_view: Any,
                               backend: Optional[CryptoBackend] = None) -> Any:
        """Apply header with full crypto checks (updateChainDepState).

        Default implementation = extract proofs, verify them now (batch of
        one), then reupdate; protocols only override when their check is not
        expressible as independent proofs.
        """
        backend = backend or default_backend()
        self.sequential_checks(ticked, header, ledger_view)
        reqs = self.extract_proofs(ticked, header, ledger_view)
        if reqs:
            ok = _verify_mixed(backend, reqs)
            if not all(ok):
                bad = ok.index(False)
                raise ProtocolError(
                    f"{type(self).__name__}: proof {bad} "
                    f"({type(reqs[bad]).__name__}) failed for header "
                    f"slot={header.slot}")
        return self.reupdate_chain_dep_state(ticked, header, ledger_view)

    def reupdate_chain_dep_state(self, ticked: Any, header: Any,
                                 ledger_view: Any) -> Any:
        """Re-apply a known-valid header, no crypto (reupdateChainDepState)."""
        raise NotImplementedError

    # -- the batching seam ----------------------------------------------------
    def sequential_checks(self, ticked: Any, header: Any,
                          ledger_view: Any) -> None:
        """Cheap host-side state-DEPENDENT checks (e.g. PBFT's windowed
        signer threshold, Praos' leader-value threshold).  Raised errors are
        validation failures.  Runs in the sequential pass of the batch
        driver; must not do expensive crypto."""

    def extract_proofs(self, ticked: Any, header: Any,
                       ledger_view: Any) -> list:
        """Independent proof obligations of this header given ticked state.

        Returns Ed25519Req/VrfReq/KesReq items (crypto/backend.py).  MUST be
        state-independent once `ticked` is known, so a window of headers can
        be verified as one device batch.
        """
        return []

    def vrf_proofs_of(self, headers: Sequence[Any]) -> list:
        """VRF proofs whose outputs (betas) the sequential pass will need
        for these headers.  Drives both prefetch_window and the pipelined
        replay driver (which computes window w+1's betas inside window w's
        device call)."""
        return []

    def prefetch_window(self, headers: Sequence[Any],
                        backend: CryptoBackend) -> None:
        """Hook run by the batch driver before the sequential pass of a
        window: batch-compute the headers' VRF betas in one device call
        instead of per-header host EC math during the fold."""
        from ..crypto.backend import GLOBAL_BETA_CACHE
        proofs = self.vrf_proofs_of(headers)
        if proofs:
            GLOBAL_BETA_CACHE.prefetch(proofs, backend)

    # -- leadership -----------------------------------------------------------
    def check_is_leader(self, can_be_leader: Any, slot: int, ticked: Any,
                        ledger_view: Any) -> Optional[Any]:
        """IsLeader proof if we lead `slot`, else None (checkIsLeader)."""
        return None

    # -- chain ordering -------------------------------------------------------
    def select_view(self, header: Any) -> Any:
        """Projection used to compare chains (SelectView); totally ordered.

        Default: block number — longest chain (Abstract.hs SelectView default
        = BlockNo)."""
        return header.block_no

    def prefer_candidate(self, ours: Any, candidate: Any) -> bool:
        """True iff candidate select-view is strictly better (preferCandidate,
        Abstract.hs:178)."""
        return candidate > ours


class NullProtocol(ConsensusProtocol):
    """Trivial protocol: no leadership checks, no proofs — test scaffolding."""

    def __init__(self, k: int = 5):
        self.security_param = k

    def initial_chain_dep_state(self):
        return ()

    def reupdate_chain_dep_state(self, ticked, header, ledger_view):
        return ()

    def check_is_leader(self, can_be_leader, slot, ticked, ledger_view):
        return True


def _verify_mixed(backend: CryptoBackend, reqs: Sequence) -> list[bool]:
    """Dispatch a mixed list of proof requests through the backend's fused
    mixed-batch path (KES hash-paths reduced to Ed25519 leaves on host, one
    Ed25519 batch + one VRF batch), preserving order."""
    return backend.verify_mixed(reqs)
