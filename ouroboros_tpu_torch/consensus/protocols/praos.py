"""Mock Praos: VRF leader election + KES header signatures + epoch nonces.

Reference: ouroboros-consensus-mock/src/Ouroboros/Consensus/Mock/Protocol/
Praos.hs:60-126 (PraosFields {praosCreator, praosRho (VRF cert), praosY,
praosSignature (KES)}; leader iff VRF output below a stake-scaled threshold
φ_f(σ) = 1 − (1−f)^σ; epoch nonce η evolved from the VRF outputs of the
previous epoch).  The KES/VRF verifications are the batched proofs
(SURVEY.md §2 gap); nonce evolution and the threshold comparison are the
cheap sequential pass.

HotKey evolution mirrors ouroboros-consensus-shelley/src/Ouroboros/
Consensus/Shelley/Protocol/HotKey.hs:48-149.

Ported from `ouroboros_tpu/consensus/protocols/praos.py` (the port imports
nothing of the JAX package). Copied whole.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, replace
from typing import Optional, Sequence

from ...crypto import kes as kes_mod, vrf_ref
from ...crypto.backend import KesReq, VrfReq
from ..protocol import ConsensusProtocol, ProtocolError

VRF_FIELD = "praos_rho"
KES_FIELD = "praos_kes_sig"


@dataclass(frozen=True)
class PraosNode:
    """Registered keys + stake for one node (the mock stake distribution)."""
    vrf_vk: bytes
    kes_vk: bytes
    stake: int


@dataclass(frozen=True)
class PraosConfig:
    nodes: tuple
    k: int = 5
    f: float = 0.5                   # active slot coefficient
    epoch_length: int = 50
    kes_depth: int = 7               # Sum7 — 128 periods
    slots_per_kes_period: int = 10

    @property
    def total_stake(self) -> int:
        return sum(n.stake for n in self.nodes)


@dataclass(frozen=True)
class PraosState:
    """ChainDepState: current epoch, its nonce, and the VRF outputs
    accumulated toward the next nonce."""
    epoch: int
    eta: bytes
    pending: tuple                   # β values contributed this epoch

    @classmethod
    def genesis(cls) -> "PraosState":
        return cls(0, hashlib.blake2b(b"praos-eta0", digest_size=32).digest(),
                   ())


def _phi(f: float, stake_frac: float) -> float:
    """Leader probability φ_f(σ) = 1 − (1−f)^σ — independent aggregation
    property of Praos (Mock/Protocol/Praos.hs leader check)."""
    return 1.0 - (1.0 - f) ** stake_frac


def _leader_value(beta: bytes) -> int:
    return int.from_bytes(beta[:32], "big")


def _alpha(eta: bytes, slot: int) -> bytes:
    """VRF input for a slot: H(η ‖ slot)."""
    return hashlib.blake2b(eta + slot.to_bytes(8, "big"),
                           digest_size=32).digest()


class Praos(ConsensusProtocol):
    def __init__(self, config: PraosConfig):
        self.config = config
        self.security_param = config.k
        from ...crypto.backend import GLOBAL_BETA_CACHE
        self._betas = GLOBAL_BETA_CACHE

    # -- epochs ---------------------------------------------------------------
    def epoch_of(self, slot: int) -> int:
        return slot // self.config.epoch_length

    def initial_chain_dep_state(self) -> PraosState:
        return PraosState.genesis()

    def tick_chain_dep_state(self, state: PraosState, ledger_view,
                             slot: int) -> PraosState:
        """Cross epoch boundaries: fold pending β values into the next η."""
        target = self.epoch_of(slot)
        while state.epoch < target:
            h = hashlib.blake2b(digest_size=32)
            h.update(state.eta)
            h.update((state.epoch + 1).to_bytes(8, "big"))
            for beta in state.pending:
                h.update(beta)
            state = PraosState(state.epoch + 1, h.digest(), ())
        return state

    def reupdate_chain_dep_state(self, ticked: PraosState, header,
                                 ledger_view) -> PraosState:
        beta = self._betas.get(header.get(VRF_FIELD))
        return replace(ticked, pending=ticked.pending + (beta[:32],))

    def vrf_proofs_of(self, headers) -> list:
        proofs = [h.get(VRF_FIELD) for h in headers]
        return [p for p in proofs if p is not None]

    # -- validation -----------------------------------------------------------
    def threshold(self, issuer: int) -> int:
        node = self.config.nodes[issuer]
        frac = node.stake / self.config.total_stake
        return int(_phi(self.config.f, frac) * float(1 << 256))

    def kes_period_of(self, slot: int) -> int:
        return slot // self.config.slots_per_kes_period

    def sequential_checks(self, ticked: PraosState, header, ledger_view):
        cfg = self.config
        if not (0 <= header.issuer < len(cfg.nodes)):
            raise ProtocolError(f"Praos: unknown issuer {header.issuer}")
        pi = header.get(VRF_FIELD)
        sig = header.get(KES_FIELD)
        if pi is None or sig is None:
            raise ProtocolError("Praos: header missing VRF proof or KES sig")
        try:
            beta = self._betas.get(pi)
        except Exception as e:
            raise ProtocolError(f"Praos: malformed VRF proof: {e}") from e
        if _leader_value(beta) >= self.threshold(header.issuer):
            raise ProtocolError(
                f"Praos: issuer {header.issuer} VRF output above stake "
                f"threshold at slot {header.slot} — not a slot leader")
        period = self.kes_period_of(header.slot)
        if period >= kes_mod.total_periods(cfg.kes_depth):
            raise ProtocolError(
                f"Praos: KES period {period} beyond key lifetime")

    def extract_proofs(self, ticked: PraosState, header, ledger_view):
        cfg = self.config
        node = cfg.nodes[header.issuer]
        pi = header.get(VRF_FIELD)
        sig = header.get(KES_FIELD)
        if pi is None or sig is None:
            return []
        return [
            VrfReq(vk=node.vrf_vk,
                   alpha=_alpha(ticked.eta, header.slot), proof=pi),
            KesReq(depth=cfg.kes_depth, vk=node.kes_vk,
                   period=self.kes_period_of(header.slot),
                   msg=header.bytes_dropping(KES_FIELD), sig_bytes=sig),
        ]

    # -- leadership -----------------------------------------------------------
    def check_is_leader(self, can_be_leader, slot: int, ticked: PraosState,
                        ledger_view) -> Optional[bytes]:
        """can_be_leader = (issuer_index, vrf_sk).  Returns the VRF proof π
        as the IsLeader evidence (praosRho analog)."""
        issuer, vrf_sk = can_be_leader
        pi = vrf_ref.prove(vrf_sk, _alpha(ticked.eta, slot))
        beta = vrf_ref.proof_to_hash(pi)
        if _leader_value(beta) < self.threshold(issuer):
            return pi
        return None


class HotKey:
    """Evolving KES signing key with period tracking (HotKey.hs:48-149)."""

    def __init__(self, key: kes_mod.KesSignKey):
        self.key = key

    @property
    def period(self) -> int:
        return self.key.period

    def sign_at(self, period: int, msg: bytes) -> bytes:
        """Evolve forward to `period` (forward-secure: never backwards) and
        sign."""
        if period < self.key.period:
            raise ValueError(
                f"KES key already evolved past period {period} "
                f"(at {self.key.period})")
        while self.key.period < period:
            self.key.evolve()
        return self.key.sign(msg).to_bytes()


def praos_forge_fields(protocol: Praos, hot_key: HotKey, is_leader_pi: bytes,
                       header):
    """Attach PraosFields: VRF proof first, then the KES signature over the
    header including the proof (Mock/Protocol/Praos.hs forgePraosFields)."""
    h1 = header.with_fields(**{VRF_FIELD: is_leader_pi})
    period = protocol.kes_period_of(header.slot)
    sig = hot_key.sign_at(period, h1.bytes_dropping(KES_FIELD))
    return h1.with_fields(**{KES_FIELD: sig})
