"""BFT: round-robin leadership with Ed25519 header signatures.

Reference: ouroboros-consensus/src/Ouroboros/Consensus/Protocol/BFT.hs —
leader of slot s is node (s mod n); every header carries a DSIGN signature
by its slot's leader; ChainDepState is trivial.

Ported from `ouroboros_tpu/consensus/protocols/bft.py` (the port imports
nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

from ...crypto import ed25519_ref
from ...crypto.backend import Ed25519Req
from ..protocol import ConsensusProtocol, ProtocolError

SIG_FIELD = "bft_sig"


class Bft(ConsensusProtocol):
    """Config = ordered list of node verification keys."""

    def __init__(self, node_vks: list[bytes], k: int = 5):
        self.node_vks = list(node_vks)
        self.security_param = k

    @property
    def n(self) -> int:
        return len(self.node_vks)

    def slot_leader(self, slot: int) -> int:
        return slot % self.n

    # -- state ----------------------------------------------------------------
    def initial_chain_dep_state(self):
        return ()

    def reupdate_chain_dep_state(self, ticked, header, ledger_view):
        return ()

    # -- checks ---------------------------------------------------------------
    def sequential_checks(self, ticked, header, ledger_view):
        expected = self.slot_leader(header.slot)
        if header.issuer != expected:
            raise ProtocolError(
                f"BFT: slot {header.slot} led by node {expected}, "
                f"header issued by {header.issuer}")
        if header.get(SIG_FIELD) is None:
            raise ProtocolError("BFT: header missing signature")

    def extract_proofs(self, ticked, header, ledger_view):
        sig = header.get(SIG_FIELD)
        if sig is None:
            return []
        return [Ed25519Req(vk=self.node_vks[self.slot_leader(header.slot)],
                           msg=header.bytes_dropping(SIG_FIELD), sig=sig)]

    # -- leadership -----------------------------------------------------------
    def check_is_leader(self, can_be_leader, slot, ticked, ledger_view):
        """can_be_leader = our node index (BftCanBeLeader analog)."""
        return True if self.slot_leader(slot) == can_be_leader else None


def bft_sign_header(sk: bytes, header):
    """Attach the BFT signature (forging side)."""
    sig = ed25519_ref.sign(sk, header.bytes_dropping(SIG_FIELD))
    return header.with_fields(**{SIG_FIELD: sig})
