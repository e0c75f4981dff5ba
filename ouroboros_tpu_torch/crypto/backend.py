"""CryptoBackend — the batched-verification seam, as the port needs it.

Ported from `ouroboros_tpu/crypto/backend.py`: the request types, the
folded `WindowVerdict`, the `CryptoBackend` base with its host split of
mixed request lists, and `CpuRefBackend`, the port's own pure-Python
oracle.  Reference seam: the `StandardCrypto` bundle
(Shelley/Protocol/Crypto.hs:15-23) reached from `updateChainDepState` (VRF
+ KES per header) and `applyLedgerBlock` (Ed25519 witnesses per body).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from . import ed25519_ref, kes as kes_mod, vrf_ref


@dataclass(frozen=True)
class Ed25519Req:
    vk: bytes        # 32B verification key
    msg: bytes
    sig: bytes       # 64B


@dataclass(frozen=True)
class VrfReq:
    vk: bytes        # 32B
    alpha: bytes     # VRF input
    proof: bytes     # 80B


@dataclass(frozen=True)
class KesReq:
    depth: int
    vk: bytes        # 32B root hash
    period: int
    msg: bytes
    sig_bytes: bytes


@dataclass(frozen=True)
class WindowVerdict:
    """What finish_window returns for a window submitted with
    `fold=True`: the index of the FIRST failing request in the submitted
    list (None = every proof held) instead of a per-proof vector.  Owner
    maps are non-decreasing, so the first bad request is also the first
    bad block."""
    n: int
    first_bad: Optional[int] = None

    @property
    def all_ok(self) -> bool:
        return self.first_bad is None


class CryptoBackend:
    """Batch verification interface. Implementations must be bit-exact."""

    name = "abstract"
    # True on backends whose submit_window accepts fold=True
    supports_window_fold = False

    def verify_ed25519_batch(self, reqs: Sequence[Ed25519Req]) -> list[bool]:
        raise NotImplementedError

    def verify_vrf_batch(self, reqs: Sequence[VrfReq]) -> list[bool]:
        raise NotImplementedError

    def verify_kes_batch(self, reqs: Sequence[KesReq]) -> list[bool]:
        """Default: host hash-path check + ed25519 batch on the leaves."""
        ed_reqs, ed_owner, _v, _vo, n = self.split_mixed(reqs)
        out = [False] * n
        if ed_reqs:
            for i, ok in zip(ed_owner, self.verify_ed25519_batch(ed_reqs)):
                out[i] = bool(ok)
        return out

    def split_mixed(self, reqs: Sequence):
        """Host split of a mixed request list: KES requests are reduced to
        their Ed25519 leaf checks (hash path checked here on the host;
        a request whose path fails stays False).

        Returns (ed_reqs, ed_owner, vrf_reqs, vrf_owner, n) where owner
        maps each grouped request back to its index in `reqs`."""
        ed_reqs: list = []
        ed_owner: list[int] = []
        vrf_reqs: list = []
        vrf_owner: list[int] = []
        for i, r in enumerate(reqs):
            if isinstance(r, Ed25519Req):
                ed_reqs.append(r)
                ed_owner.append(i)
            elif isinstance(r, VrfReq):
                vrf_reqs.append(r)
                vrf_owner.append(i)
            elif isinstance(r, KesReq):
                try:
                    sig = kes_mod.KesSig.from_bytes(r.depth, r.sig_bytes)
                except ValueError:
                    continue          # stays False
                leaf = kes_mod.verify_prepare(r.depth, r.vk, r.period, sig)
                if leaf is None:
                    continue          # stays False
                leaf_vk, leaf_sig = leaf
                ed_reqs.append(Ed25519Req(leaf_vk, r.msg, leaf_sig))
                ed_owner.append(i)
            else:
                raise TypeError(f"unknown proof request type {type(r)}")
        return ed_reqs, ed_owner, vrf_reqs, vrf_owner, len(reqs)

    def verify_mixed(self, reqs: Sequence) -> list[bool]:
        """Verify a mixed Ed25519/VRF/KES request list, preserving order."""
        ed_reqs, ed_owner, vrf_reqs, vrf_owner, n = self.split_mixed(reqs)
        out = [False] * n
        for i, ok in zip(ed_owner, self.verify_ed25519_batch(ed_reqs)):
            out[i] = bool(ok)
        for i, ok in zip(vrf_owner, self.verify_vrf_batch(vrf_reqs)):
            out[i] = bool(ok)
        return out

    def vrf_betas_batch(self, proofs: Sequence[bytes]) -> list:
        """Batched proof_to_hash; None where the proof does not decode."""
        out = []
        for pi in proofs:
            try:
                out.append(vrf_ref.proof_to_hash(pi))
            except ValueError:
                out.append(None)
        return out


class CpuRefBackend(CryptoBackend):
    """Pure-Python ground truth."""

    name = "cpu-ref"

    def verify_ed25519_batch(self, reqs):
        return [ed25519_ref.verify(r.vk, r.msg, r.sig) for r in reqs]

    def verify_vrf_batch(self, reqs):
        return [vrf_ref.verify(r.vk, r.alpha, r.proof) for r in reqs]
