"""Sum-composition KES (key-evolving signatures) over Ed25519 + Blake2b-256.

Reference seam: Sum6KES(Ed25519DSIGN, Blake2b_256) in
Shelley/Protocol/Crypto.hs:15-23 and the evolving HotKey in
Protocol/HotKey.hs:48-149 (forging path signs headers with the current KES
period; validation verifies per header — the KES half of CRYPTO HOT SPOT 1,
SURVEY.md §3.3).

Construction (Merkle sum composition, MMM scheme):
- Sum0 = plain Ed25519 over a 32-byte seed.
- Sum(n): seed -> (seed_L, seed_R) via Blake2b-256 domain-separated expansion;
  vk = Blake2b-256(vk_L || vk_R); periods double at each level.
  Signature at period t = (sub-signature, vk_L, vk_R); verify recomputes the
  vk hash and descends into the half indicated by t.

Verification cost per signature = 1 Ed25519 verify + `depth` Blake2b hashes;
the batched device path reuses the Ed25519 kernel for the leaves and checks
the hash chain as Blake2b jobs (verify_walk).

A copy of `ouroboros_tpu/crypto/kes.py` without key evolution (keys
sign at period 0) and the one-shot verify, which the port does not use
(it imports nothing of the JAX package).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

from . import ed25519_ref as dsign

SEED_BYTES = 32
VK_BYTES = 32   # Sum levels use a 32-byte Blake2b hash; Sum0 uses raw ed25519 vk


def _blake2b_256(*chunks: bytes) -> bytes:
    h = hashlib.blake2b(digest_size=32)
    for c in chunks:
        h.update(c)
    return h.digest()


def expand_seed(seed: bytes) -> tuple[bytes, bytes]:
    """Domain-separated split of a seed into two child seeds."""
    return _blake2b_256(b"\x01", seed), _blake2b_256(b"\x02", seed)


def total_periods(depth: int) -> int:
    return 1 << depth


@dataclass
class KesSig:
    """Signature = leaf ed25519 sig + per-level (vk_L, vk_R) pairs, leaf-first."""
    leaf_sig: bytes
    merkle: tuple  # ((vkL, vkR), ...) from leaf level up to the root

    def to_bytes(self) -> bytes:
        out = self.leaf_sig
        for vkl, vkr in self.merkle:
            out += vkl + vkr
        return out

    @classmethod
    def from_bytes(cls, depth: int, raw: bytes) -> "KesSig":
        need = 64 + depth * 64
        if len(raw) != need:
            raise ValueError(f"KES sig must be {need} bytes for depth {depth}")
        leaf = raw[:64]
        merkle = tuple((raw[64 + i * 64:96 + i * 64],
                        raw[96 + i * 64:128 + i * 64])
                       for i in range(depth))
        return cls(leaf, merkle)


class KesSignKey:
    """SumKES signing key at a given depth, at period 0 (the leftmost
    leaf): the per-level vk pairs from the root down, and the leaf's
    Ed25519 seed."""

    def __init__(self, depth: int, seed: bytes):
        if len(seed) != SEED_BYTES:
            raise ValueError("seed must be 32 bytes")
        self.depth = depth
        self._levels: list[dict] = []
        for d in range(depth, 0, -1):
            sl, sr = expand_seed(seed)
            self._levels.append({"vks": (vk_of(d - 1, sl), vk_of(d - 1, sr))})
            seed = sl
        self._leaf_sk = seed   # ed25519 seed is the leaf signing key

    # -- public api ---------------------------------------------------------
    @property
    def verification_key(self) -> bytes:
        if not self._levels:          # depth 0: plain ed25519
            return dsign.public_key(self._leaf_sk)
        vkl, vkr = self._levels[0]["vks"]   # root level
        return _blake2b_256(vkl, vkr)

    def sign(self, msg: bytes) -> KesSig:
        leaf_sig = dsign.sign(self._leaf_sk, msg)
        merkle = tuple(lv["vks"] for lv in reversed(self._levels))
        return KesSig(leaf_sig, merkle)


def vk_of(depth: int, seed: bytes) -> bytes:
    """Verification key of the SumKES tree grown from `seed` at `depth`."""
    if depth == 0:
        return dsign.public_key(seed)
    sl, sr = expand_seed(seed)
    return _blake2b_256(vk_of(depth - 1, sl), vk_of(depth - 1, sr))


def verify_walk(depth: int, vk: bytes, period: int, sig: KesSig):
    """Hash-free structural walk for device-batched verification.

    Returns (leaf_vk, leaf_sig, jobs) where jobs is the list of
    (64-byte message, expected 32-byte digest) Blake2b-256 checks the
    hash path requires — the `kes_hash` kernel verifies them
    all in one batch; the KES signature is valid iff every job checks
    out AND the leaf Ed25519 verify passes.  None if structurally
    invalid (bad period / wrong path length)."""
    if not 0 <= period < total_periods(depth) or len(sig.merkle) != depth:
        return None
    jobs = []
    expect = vk
    t = period
    half = total_periods(depth) // 2
    for vkl, vkr in reversed(sig.merkle):
        jobs.append((vkl + vkr, expect))
        if t < half:
            expect = vkl
        else:
            expect = vkr
            t -= half
        half //= 2
    return expect, sig.leaf_sig, jobs


def hash_path_key(depth: int, vk: bytes, period: int, sig_bytes: bytes):
    """Cache identity of a KES signature's hash-path check.

    The Blake2b Merkle walk (verify_walk's jobs AND the leaf vk it ends
    on) depends only on (depth, period, vk, merkle-path bytes) — NOT on
    the signed message — so a pool's per-period subtree check has one
    answer for every header it signs in that period.  The cross-window
    precomputation cache (crypto/precompute.py) memoises outcomes under
    this key.  Returns None when the request is structurally invalid
    (a root key that is not 32 bytes, a wrong signature length, a period
    out of range), which callers reject directly: no Blake2b digest
    equals a short or long key, and such a key must neither schedule a
    job nor read or write a cache entry.
    """
    if len(vk) != 32 or not 0 <= period < total_periods(depth):
        return None
    if len(sig_bytes) != 64 + depth * 64:
        return None
    return (depth, period, vk, sig_bytes[64:])


def verify_prepare(depth: int, vk: bytes, period: int, sig: KesSig):
    """Host-side half of batched verification: check the hash path and
    return the (leaf_vk, leaf_sig) pair for the device Ed25519 batch, or
    None if the hash path is already invalid."""
    if not 0 <= period < total_periods(depth) or len(sig.merkle) != depth:
        return None
    expect_vk = vk
    t = period
    half = total_periods(depth) // 2
    for vkl, vkr in reversed(sig.merkle):
        if _blake2b_256(vkl, vkr) != expect_vk:
            return None
        if t < half:
            expect_vk = vkl
        else:
            expect_vk = vkr
            t -= half
        half //= 2
    return expect_vk, sig.leaf_sig
