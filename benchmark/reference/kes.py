"""Sum-composition KES over Ed25519 and Blake2b-256 (Sum6KES at depth 6).

A tree of depth d has 2^d periods.  A seed splits into Blake2b-256(0x01 ||
seed) and Blake2b-256(0x02 || seed); a node's key is Blake2b-256(vk_L ||
vk_R) and a leaf's is the Ed25519 key of its seed.  A signature at period
t is the leaf's Ed25519 signature followed by (vk_L || vk_R) of each level
on the path, leaf level first: 64 + 64 d bytes.
"""
from __future__ import annotations

import functools
import hashlib

from . import ed25519 as ed


def b2b256(*parts: bytes) -> bytes:
    h = hashlib.blake2b(digest_size=32)
    for part in parts:
        h.update(part)
    return h.digest()


def split(seed: bytes) -> tuple[bytes, bytes]:
    return b2b256(b"\x01", seed), b2b256(b"\x02", seed)


@functools.lru_cache(maxsize=4096)
def vk_of(depth: int, seed: bytes) -> bytes:
    if depth == 0:
        return ed.public_key(seed)
    left, right = split(seed)
    return b2b256(vk_of(depth - 1, left), vk_of(depth - 1, right))


def sign(depth: int, seed: bytes, period: int, msg: bytes,
         leaf_sign=ed.sign) -> bytes:
    """The signature of msg at `period` by the key grown from `seed`;
    `leaf_sign(leaf_seed, msg)` makes the leaf's Ed25519 signature."""
    if not 0 <= period < 1 << depth:
        raise ValueError("period outside the key's lifetime")
    path = []
    for level in range(depth, 0, -1):
        left, right = split(seed)
        path.append(vk_of(level - 1, left) + vk_of(level - 1, right))
        half = 1 << (level - 1)
        if period < half:
            seed = left
        else:
            seed, period = right, period - half
    return leaf_sign(seed, msg) + b"".join(reversed(path))


def verify(depth: int, vk: bytes, period: int, msg: bytes,
           sig: bytes) -> bool:
    if not 0 <= period < 1 << depth or len(sig) != 64 + 64 * depth:
        return False
    expect = vk
    for level in range(depth, 0, -1):
        off = 64 + 64 * (level - 1)
        vk_l, vk_r = sig[off:off + 32], sig[off + 32:off + 64]
        if b2b256(vk_l, vk_r) != expect:
            return False
        half = 1 << (level - 1)
        if period < half:
            expect = vk_l
        else:
            expect, period = vk_r, period - half
    return ed.verify(expect, msg, sig[:64])
