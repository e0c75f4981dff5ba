"""CryptoBackend — the batched-verification seam.

Ported from `ouroboros_tpu/crypto/backend.py`: the request types, the
folded `WindowVerdict`, the `CryptoBackend` base with its host splits of
mixed request lists, the process-wide VRF beta cache, `CpuRefBackend`
(the port's pure-Python oracle), `OpensslBackend` and the default
backend.  Reference seam: the `StandardCrypto` bundle
(Shelley/Protocol/Crypto.hs:15-23) reached from `updateChainDepState` (VRF
+ KES per header) and `applyLedgerBlock` (Ed25519 witnesses per body).

Changed from the reference: `default_backend()` is a `TorchBackend` on
the CUDA card, raises without one, and is whatever `set_default_backend`
installed otherwise; it never picks a CPU backend by itself.
`split_mixed_cached` keeps its KES hash-path outcomes in the host-side
KES namespace of `precompute.shared_cache("cpu")` unless given a cache.
This module imports no torch.
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
    """Folded window verdict: what finish_window returns when the window
    was submitted with `fold=True` (device-side verdict reduction).

    Instead of a per-proof boolean vector crossing the host<->device
    link, the fused window program folds ok-flags on device and returns
    only the FIRST failing request's index (None = every proof held).
    `first_bad` indexes the submitted request list, so a replay driver
    maps it through its owner table exactly like `min(owner[j] for bad
    j)` over the old vector — owner maps are non-decreasing, making the
    first bad request also the first bad block."""
    n: int
    first_bad: Optional[int] = None

    @property
    def all_ok(self) -> bool:
        return self.first_bad is None

    def as_bools(self) -> list:
        """Degraded vector view: True everywhere except first_bad.  Only
        exact when at most one request failed — callers needing the full
        vector must submit with fold=False."""
        out = [True] * self.n
        if self.first_bad is not None:
            out[self.first_bad] = False
        return out


class CryptoBackend:
    """Batch verification interface. Implementations must be bit-exact."""

    name = "abstract"
    # True on backends whose submit_window accepts fold=True
    # (device-side verdict reduction — consensus/pipeline.py asks)
    supports_window_fold = False

    def verify_ed25519_batch(self, reqs: Sequence[Ed25519Req]) -> list[bool]:
        raise NotImplementedError

    def verify_vrf_batch(self, reqs: Sequence[VrfReq]) -> list[bool]:
        raise NotImplementedError

    def verify_kes_batch(self, reqs: Sequence[KesReq]) -> list[bool]:
        """Default: host hash-path check + ed25519 batch on the leaves
        (the reduction lives in split_mixed)."""
        ed_reqs, ed_owner, _v, _vo, n = self.split_mixed(reqs)
        out = [False] * n
        if ed_reqs:
            for i, ok in zip(ed_owner, self.verify_ed25519_batch(ed_reqs)):
                out[i] = bool(ok)
        return out

    # -- mixed batches --------------------------------------------------------
    def _split_mixed_loop(self, reqs: Sequence, kes_leaf):
        """Shared dispatch skeleton of the host split variants: group
        Ed25519/VRF requests, reduce each KES request through
        `kes_leaf(req) -> (leaf_vk, leaf_sig) | None` (None = the hash
        path is invalid / known-bad, request stays False)."""
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
                leaf = kes_leaf(r)
                if leaf is None:
                    continue          # stays False
                leaf_vk, leaf_sig = leaf
                ed_reqs.append(Ed25519Req(leaf_vk, r.msg, leaf_sig))
                ed_owner.append(i)
            else:
                raise TypeError(f"unknown proof request type {type(r)}")
        return ed_reqs, ed_owner, vrf_reqs, vrf_owner, len(reqs)

    def split_mixed(self, reqs: Sequence):
        """Host-side split of a mixed request list: KES requests are reduced
        to their Ed25519 leaf checks (hash-path verification happens here)
        and merged into the Ed25519 group, so a mixed window costs ONE
        Ed25519 batch + ONE VRF batch instead of three calls.

        Returns (ed_reqs, ed_owner, vrf_reqs, vrf_owner, n) where owner maps
        each grouped request back to its index in `reqs`."""
        def kes_leaf(r):
            try:
                sig = kes_mod.KesSig.from_bytes(r.depth, r.sig_bytes)
            except ValueError:
                return None
            return kes_mod.verify_prepare(r.depth, r.vk, r.period, sig)
        return self._split_mixed_loop(reqs, kes_leaf)

    def split_mixed_cached(self, reqs: Sequence, cache=None):
        """split_mixed with cross-window KES hash-path memoisation.

        Same return shape as split_mixed, but each KES request's Blake2b
        Merkle walk is looked up in the precomputation cache first
        (keyed by kes.hash_path_key — message-independent): warm paths
        skip the host hashing entirely, cold paths hash once and record
        the outcome.  The sharded mesh backend threads its windows
        through this (TorchBackend goes further and runs cold paths as
        `kes_hash` jobs on the card — torch_backend.py)."""
        if cache is None:
            from .precompute import shared_cache
            cache = shared_cache("cpu")

        def kes_leaf(r):
            key = kes_mod.hash_path_key(r.depth, r.vk, r.period,
                                        r.sig_bytes)
            if key is None:
                return None           # structurally invalid
            ent = cache.kes_get(key)
            if ent is None:
                sig = kes_mod.KesSig.from_bytes(r.depth, r.sig_bytes)
                prep = kes_mod.verify_prepare(r.depth, r.vk, r.period,
                                              sig)
                ent = ((prep[0], True) if prep is not None
                       else (None, False))
                cache.kes_put(key, *ent)
            leaf_vk, path_ok = ent
            if not path_ok:
                return None           # known-bad hash path
            return leaf_vk, r.sig_bytes[:64]
        return self._split_mixed_loop(reqs, kes_leaf)

    def verify_mixed(self, reqs: Sequence) -> list[bool]:
        """Verify a mixed Ed25519/VRF/KES request list, preserving order."""
        ed_reqs, ed_owner, vrf_reqs, vrf_owner, n = self.split_mixed(reqs)
        out = [False] * n
        for i, ok in zip(ed_owner, self.verify_ed25519_batch(ed_reqs)):
            out[i] = bool(ok)
        for i, ok in zip(vrf_owner, self.verify_vrf_batch(vrf_reqs)):
            out[i] = bool(ok)
        return out

    # VRF outputs (beta) for leader election — host-side, cheap
    def vrf_proof_to_hash(self, proof: bytes) -> bytes:
        return vrf_ref.proof_to_hash(proof)

    def vrf_betas_batch(self, proofs: Sequence[bytes]) -> list:
        """Batched proof_to_hash; None where the proof does not decode.
        TorchBackend overrides with one `gamma8` launch (the seq-pass beta
        prefetch of consensus/batch.py rides on this)."""
        out = []
        for pi in proofs:
            try:
                out.append(vrf_ref.proof_to_hash(pi))
            except ValueError:
                out.append(None)
        return out


_MISSING = object()


class VrfBetaCache:
    """proof bytes -> beta (proof_to_hash) memo with batched prefetch.

    The sequential pass of window validation needs the VRF output of every
    header (leader-threshold check, nonce evolution) — per-proof host EC
    math there costs more than the whole device batch.  Protocols own one
    of these; the batch driver prefetches a window's proofs in one
    backend.vrf_betas_batch call before the sequential fold."""

    def __init__(self, max_entries: int = 200_000):
        self._cache: dict = {}
        self.max_entries = max_entries

    def __contains__(self, proof: bytes) -> bool:
        return proof in self._cache

    def get(self, proof: bytes) -> bytes:
        """Beta for the proof; raises ValueError exactly where
        vrf_ref.proof_to_hash does."""
        v = self._cache.get(proof, _MISSING)
        if v is _MISSING:
            try:
                v = vrf_ref.proof_to_hash(proof)
            except ValueError:
                v = None
            self._store(proof, v)
        if v is None:
            raise ValueError("invalid proof")
        return v

    def prefetch(self, proofs: Sequence[bytes],
                 backend: "CryptoBackend") -> None:
        todo = [p for p in dict.fromkeys(proofs) if p not in self._cache]
        if not todo:
            return
        for p, b in zip(todo, backend.vrf_betas_batch(todo)):
            self._store(p, b)

    def _store(self, proof: bytes, beta) -> None:
        if len(self._cache) >= self.max_entries:
            # evict the oldest half (insertion order), never the entries
            # just prefetched for the in-flight window; pop-with-default
            # because the pipelined replay's producer (miss-path get) and
            # consumer (store_many at drain) may both evict concurrently
            # over stale key snapshots
            drop = len(self._cache) // 2
            for k in list(self._cache)[:drop]:
                self._cache.pop(k, None)
        self._cache[proof] = beta

    def clear(self) -> None:
        self._cache.clear()

    def store_many(self, proofs: Sequence[bytes], betas: Sequence) -> None:
        for p, b in zip(proofs, betas):
            self._store(p, b)


# beta = proof_to_hash(proof) is a pure function of the proof bytes, so one
# process-wide cache serves every protocol instance (TPraos, mock Praos,
# and the HFC combinator all read it)
GLOBAL_BETA_CACHE = VrfBetaCache()


class CpuRefBackend(CryptoBackend):
    """Pure-Python ground truth."""

    name = "cpu-ref"

    def verify_ed25519_batch(self, reqs):
        return [ed25519_ref.verify(r.vk, r.msg, r.sig) for r in reqs]

    def verify_vrf_batch(self, reqs):
        return [vrf_ref.verify(r.vk, r.alpha, r.proof) for r in reqs]


class OpensslBackend(CpuRefBackend):
    """Ed25519 via OpenSSL (`cryptography`) — the fast CPU path (the role
    libsodium plays in the reference deployment).  Without the binding,
    as on the card's machine, it degrades to the pure-Python parent
    (identical verdicts: RFC 8032 is deterministic)."""

    name = "cpu-openssl"

    def verify_ed25519_batch(self, reqs):
        try:
            from cryptography.exceptions import InvalidSignature
            from cryptography.hazmat.primitives.asymmetric.ed25519 import (
                Ed25519PublicKey,
            )
        except ImportError:     # absent OR broken binding: degrade
            return super().verify_ed25519_batch(reqs)
        out = []
        for r in reqs:
            try:
                Ed25519PublicKey.from_public_bytes(r.vk).verify(r.sig, r.msg)
                out.append(True)
            except (InvalidSignature, ValueError):
                out.append(False)
        return out


_default: Optional[CryptoBackend] = None


def default_backend() -> CryptoBackend:
    """The backend callers get when they name none: whatever
    `set_default_backend` installed, else a `TorchBackend` on the CUDA
    card (made once).  Raises RuntimeError without a card: no CPU
    backend is chosen silently; install one with `set_default_backend`
    (or pass `backend=`) to run on the host."""
    global _default
    if _default is None:
        from .torch_backend import TorchBackend
        _default = TorchBackend()
    return _default


def set_default_backend(b: Optional[CryptoBackend]) -> None:
    global _default
    _default = b
