"""PBFT: delegate signatures with a windowed per-signer threshold.

Reference: ouroboros-consensus/src/Ouroboros/Consensus/Protocol/PBFT.hs:226-302
(update = verify issuer is a genesis delegate, append signer to a window of
the last `windowSize` signers, reject when one signer exceeds
`threshold × windowSize`), window state in PBFT/State.hs.  The signature
check is the batchable proof; the window arithmetic is the cheap
sequential check.

Ported from `ouroboros_tpu/consensus/protocols/pbft.py` (the port imports
nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

from ...crypto import ed25519_ref
from ...crypto.backend import Ed25519Req
from ..protocol import ConsensusProtocol, ProtocolError

SIG_FIELD = "pbft_sig"


class PBft(ConsensusProtocol):
    """Config: delegate vks, signature threshold, window size.

    ChainDepState = tuple of recent issuer indices (newest last), ≤ window.
    """

    def __init__(self, delegate_vks: list[bytes], threshold: float = 0.22,
                 window: int = 100, k: int = 5):
        self.delegate_vks = list(delegate_vks)
        self.threshold = threshold
        self.window = window
        self.security_param = k

    @property
    def n(self) -> int:
        return len(self.delegate_vks)

    def slot_leader(self, slot: int) -> int:
        return slot % self.n

    def _limit(self) -> int:
        # strictly-greater-than comparison in the reference (PBFT.hs:279)
        return int(self.threshold * self.window)

    # -- state ----------------------------------------------------------------
    def initial_chain_dep_state(self):
        return ()

    def reupdate_chain_dep_state(self, ticked, header, ledger_view):
        signers = ticked + (header.issuer,)
        return signers[-self.window:]

    # -- checks ---------------------------------------------------------------
    def sequential_checks(self, ticked, header, ledger_view):
        if not (0 <= header.issuer < self.n):
            raise ProtocolError(
                f"PBFT: issuer {header.issuer} is not a genesis delegate")
        if header.get(SIG_FIELD) is None:
            raise ProtocolError("PBFT: header missing signature")
        signers = (ticked + (header.issuer,))[-self.window:]
        count = sum(1 for s in signers if s == header.issuer)
        if count > max(1, self._limit()):
            raise ProtocolError(
                f"PBFT: signer {header.issuer} signed {count} of last "
                f"{len(signers)} blocks, exceeds threshold "
                f"{self.threshold}×{self.window}")

    def extract_proofs(self, ticked, header, ledger_view):
        sig = header.get(SIG_FIELD)
        if sig is None:
            return []
        return [Ed25519Req(vk=self.delegate_vks[header.issuer],
                           msg=header.bytes_dropping(SIG_FIELD), sig=sig)]

    # -- leadership -----------------------------------------------------------
    def check_is_leader(self, can_be_leader, slot, ticked, ledger_view):
        return True if self.slot_leader(slot) == can_be_leader else None


def pbft_sign_header(sk: bytes, header):
    sig = ed25519_ref.sign(sk, header.bytes_dropping(SIG_FIELD))
    return header.with_fields(**{SIG_FIELD: sig})
