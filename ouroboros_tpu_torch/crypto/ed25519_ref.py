"""RFC 8032 Ed25519 sign/verify — pure-Python CPU reference.

Ported from `ouroboros_tpu/crypto/ed25519_ref.py`.  Only the pure
functions are kept: the port's users run where no `cryptography` binding
is installed, and RFC 8032 signing is deterministic, so the pure path
gives the same bytes (`public_key` and `sign` are the pure functions
with a table for the fixed base and the key memoised).  The port's
batched kernels must agree bit-for-bit with `verify`.
"""
from __future__ import annotations

import functools

from . import edwards as ed
from .edwards import BASE, L


def _clamp(k: bytes) -> int:
    a = bytearray(k)
    a[0] &= 248
    a[31] &= 127
    a[31] |= 64
    return int.from_bytes(bytes(a), "little")


def secret_expand(sk: bytes) -> tuple[int, bytes]:
    """seed -> (secret scalar, nonce prefix)."""
    h = ed.sha512(sk)
    return _clamp(h[:32]), h[32:]


def public_key_pure(sk: bytes) -> bytes:
    a, _ = secret_expand(sk)
    return ed.compress(ed.scalar_mult(a, BASE))


def sign_pure(sk: bytes, msg: bytes) -> bytes:
    a, prefix = secret_expand(sk)
    vk = ed.compress(ed.scalar_mult(a, BASE))
    r = ed.sha512_int(prefix, msg) % L
    R = ed.compress(ed.scalar_mult(r, BASE))
    k = ed.sha512_int(R, vk, msg) % L
    s = (r + k * a) % L
    return R + int.to_bytes(s, 32, "little")


# a chain's forger signs with a handful of keys thousands of times (pool
# cold keys, KES leaves, payment keys): `public_key` and `sign` give the
# pure functions' bytes with the fixed-base products from a table and the
# public key derived once per seed
@functools.lru_cache(maxsize=1 << 16)
def public_key(sk: bytes) -> bytes:
    a, _ = secret_expand(sk)
    return ed.compress(ed.scalar_mult_base(a))


def sign(sk: bytes, msg: bytes) -> bytes:
    a, prefix = secret_expand(sk)
    r = ed.sha512_int(prefix, msg) % L
    R = ed.compress(ed.scalar_mult_base(r))
    k = ed.sha512_int(R, public_key(sk), msg) % L
    s = (r + k * a) % L
    return R + int.to_bytes(s, 32, "little")


def verify(vk: bytes, msg: bytes, sig: bytes) -> bool:
    """RFC 8032 verify: [s]B == R + [k]A  (cofactorless, as libsodium)."""
    if len(sig) != 64 or len(vk) != 32:
        return False
    A = ed.decompress(vk)
    R = ed.decompress(sig[:32])
    if A is None or R is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    k = ed.sha512_int(sig[:32], vk, msg) % L
    sB = ed.scalar_mult(s, BASE)
    kA = ed.scalar_mult(k, A)
    return ed.pt_equal(sB, ed.pt_add(R, kA))
