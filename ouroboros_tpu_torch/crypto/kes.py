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

A copy of `ouroboros_tpu/crypto/kes.py` (the port imports nothing of
the JAX package), with key evolution: `KesSignKey.evolve` steps the key
one period, deriving the right subtree from the retained seed and
dropping expired material, as the forging HotKey needs.  The one-shot
`verify` is the conformance oracle; the batched paths split its checks
into `verify_prepare` and `verify_walk`.
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
    """Evolving signing key for SumKES at a given depth."""

    def __init__(self, depth: int, seed: bytes):
        if len(seed) != SEED_BYTES:
            raise ValueError("seed must be 32 bytes")
        self.depth = depth
        self.period = 0
        # Path from root to current leaf: at each level keep the sibling vk
        # pair and (for left positions) the retained seed of the right child.
        self._levels: list[dict] = []
        self._leaf_sk = self._descend(depth, seed)

    def _descend(self, depth: int, seed: bytes) -> bytes:
        """Append the levels from a subtree of `depth` grown from `seed`
        down to its leftmost leaf, keeping each right seed for later
        evolution; returns the leaf's Ed25519 seed."""
        if depth == 0:
            return seed   # ed25519 seed is the leaf signing key
        sl, sr = expand_seed(seed)
        self._levels.append({"depth": depth, "on_right": False,
                             "right_seed": sr,
                             "vks": (vk_of(depth - 1, sl),
                                     vk_of(depth - 1, sr))})
        return self._descend(depth - 1, sl)

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

    def evolve(self) -> None:
        """Advance one period; raises when the key is exhausted."""
        if self.period + 1 >= total_periods(self.depth):
            raise ValueError("KES key exhausted")
        self.period += 1
        # find deepest level where we can move from left to right subtree
        for i in range(len(self._levels) - 1, -1, -1):
            lv = self._levels[i]
            if not lv["on_right"]:
                # move into the right subtree of this level
                seed = lv["right_seed"]
                lv["on_right"] = True
                lv["right_seed"] = None   # forward security: drop it
                self._levels = self._levels[:i + 1]
                self._leaf_sk = self._descend(lv["depth"] - 1, seed)
                return
        raise AssertionError("unreachable: exhaustion checked above")


def vk_of(depth: int, seed: bytes) -> bytes:
    """Verification key of the SumKES tree grown from `seed` at `depth`."""
    if depth == 0:
        return dsign.public_key(seed)
    sl, sr = expand_seed(seed)
    return _blake2b_256(vk_of(depth - 1, sl), vk_of(depth - 1, sr))


def verify(depth: int, vk: bytes, period: int, msg: bytes,
           sig: KesSig) -> bool:
    """Pure KES verify: hash-path check + one ed25519 verify at the leaf."""
    if not 0 <= period < total_periods(depth):
        return False
    if len(sig.merkle) != depth:
        return False
    # walk root -> leaf; sig.merkle is leaf-first, so traverse reversed
    expect_vk = vk
    t = period
    half = total_periods(depth) // 2
    for vkl, vkr in reversed(sig.merkle):
        if _blake2b_256(vkl, vkr) != expect_vk:
            return False
        if t < half:
            expect_vk = vkl
        else:
            expect_vk = vkr
            t -= half
        half //= 2
    return dsign.verify(expect_vk, msg, sig.leaf_sig)


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
    (a negative depth, a root key that is not 32 bytes, a wrong signature
    length, a period out of range), which callers reject directly: no
    Blake2b digest equals a short or long key, and such a key must
    neither schedule a job nor read or write a cache entry.  The depth is
    checked first, since `total_periods` of a negative depth raises.
    """
    if depth < 0 or len(vk) != 32 \
            or not 0 <= period < total_periods(depth):
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
