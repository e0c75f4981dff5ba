"""ECVRF-ED25519-SHA512-Elligator2 as in draft-irtf-cfrg-vrf-03.

The form Cardano's PraosVRF uses (libsodium's crypto_vrf_ietfdraft03):
suite byte 0x04, Elligator2 hash-to-curve with the sign bit of the hash
cleared, a 16-byte challenge, proofs Gamma || c || s of 80 bytes and a
64-byte output beta = SHA-512(0x04 || 0x03 || [8]Gamma).
"""
from __future__ import annotations

from . import ed25519 as ed
from .ed25519 import L, P

SUITE = b"\x04"
A = 486662          # the Montgomery curve's coefficient


def hash_to_curve(vk: bytes, alpha: bytes):
    """Elligator2 (draft-03 §5.4.1.2), the cofactor cleared."""
    h = bytearray(ed.sha512(SUITE, b"\x01", vk, alpha)[:32])
    h[31] &= 0x7F
    r = int.from_bytes(bytes(h), "little")
    u = -A * ed.inv(1 + 2 * r * r) % P
    w = u * (u * u + A * u + 1) % P
    if pow(w, (P - 1) // 2, P) != 1:
        u = (-A - u) % P
    y = (u - 1) * ed.inv(u + 1) % P
    pt = ed.decompress(int.to_bytes(y, 32, "little"))
    if pt is None:
        pt = ed.BASE
    return ed.double(ed.double(ed.double(pt)))


def _challenge(*points) -> int:
    data = b"".join(ed.compress(p) for p in points)
    return int.from_bytes(ed.sha512(SUITE, b"\x02", data)[:16], "little")


def public_key(sk: bytes) -> bytes:
    return ed.public_key(sk)


def prove(sk: bytes, alpha: bytes) -> bytes:
    x, prefix = ed.expand(sk)
    vk = ed.compress(ed.mul_base(x))
    h = hash_to_curve(vk, alpha)
    gamma = ed.mul(x, h)
    k = int.from_bytes(ed.sha512(prefix, ed.compress(h)), "little") % L
    c = _challenge(h, gamma, ed.mul_base(k), ed.mul(k, h))
    s = (k + c * x) % L
    return (ed.compress(gamma) + int.to_bytes(c, 16, "little")
            + int.to_bytes(s, 32, "little"))


def _decode_proof(pi: bytes):
    if len(pi) != 80:
        return None
    gamma = ed.decompress(pi[:32])
    s = int.from_bytes(pi[48:], "little")
    if gamma is None or s >= L:
        return None
    return gamma, int.from_bytes(pi[32:48], "little"), s


def verify(vk: bytes, alpha: bytes, pi: bytes) -> bool:
    decoded = _decode_proof(pi)
    y = ed.decompress(vk)
    if decoded is None or y is None:
        return False
    gamma, c, s = decoded
    h = hash_to_curve(vk, alpha)
    u = ed.add(ed.mul_base(s), ed.neg(ed.mul(c, y)))
    v = ed.add(ed.mul(s, h), ed.neg(ed.mul(c, gamma)))
    return _challenge(h, gamma, u, v) == c


def proof_to_hash(pi: bytes):
    """beta, or None for a proof whose Gamma does not decode."""
    decoded = _decode_proof(pi)
    if decoded is None:
        return None
    gamma = decoded[0]
    return ed.sha512(SUITE, b"\x03", ed.compress(
        ed.double(ed.double(ed.double(gamma)))))
