"""ECVRF-ED25519-SHA512-Elligator2 — pure-Python CPU reference.

Ported from `ouroboros_tpu/crypto/vrf_ref.py` without its native-ladder
branch: `prove` is the pure-Python prover, with its fixed-base products
from a table (`edwards.scalar_mult_base`) and the key memoised (the same
bytes).  The VRF used by Praos leader election
(reference seam: PraosVRF / `VRF.evalCertified` in
Shelley/Protocol.hs:366-415; libsodium's crypto_vrf_ietfdraft03
underneath): Elligator2 hash-to-curve, 16-byte challenge, proof = Gamma ||
c || s (80 bytes), beta = 64 bytes.

The port's batched verifier (vrf.py, ../csrc/vrf_verify.cu) offloads the
four scalar multiplications U = [s]B - [c]Y, V = [s]H - [c]Gamma; this
module is its bit-exactness oracle.
"""
from __future__ import annotations

import functools

from . import edwards as ed
from .edwards import BASE, L, P

SUITE = b"\x04"
PROOF_LEN = 80
OUTPUT_LEN = 64


def _hash_to_curve(vk: bytes, alpha: bytes):
    """Elligator2 hash-to-curve (draft-03 §5.4.1.2), incl. cofactor
    clearing."""
    pt = ed.decompress(_hash_to_curve_bytes(vk, alpha))
    if pt is None:   # astronomically unlikely for hash output; be total
        pt = BASE
    return ed.scalar_mult(8, pt)         # clear cofactor


def _hash_points(*pts) -> int:
    data = b"".join(ed.compress(p) for p in pts)
    c = ed.sha512(SUITE, b"\x02", data)[:16]
    return int.from_bytes(c, "little")


def prove(sk: bytes, alpha: bytes) -> bytes:
    x, prefix = _secret_expand(sk)
    Y = public_key(sk)
    H = _hash_to_curve(Y, alpha)
    h_string = ed.compress(H)
    Gamma = ed.scalar_mult(x, H)
    k = ed.sha512_int(prefix, h_string) % L      # RFC8032-style nonce
    c = _hash_points(H, Gamma, ed.scalar_mult_base(k), ed.scalar_mult(k, H))
    s = (k + c * x) % L
    return ed.compress(Gamma) + int.to_bytes(c, 16, "little") \
        + int.to_bytes(s, 32, "little")


def prove_pure(sk: bytes, alpha: bytes) -> bytes:
    """The spec's prover, each product a plain double-and-add ladder:
    the conformance oracle that `prove` (fixed-base products from a
    table) must equal byte for byte."""
    x, prefix = _secret_expand(sk)
    Y = ed.compress(ed.scalar_mult(x, BASE))
    H = _hash_to_curve(Y, alpha)
    Gamma = ed.scalar_mult(x, H)
    k = ed.sha512_int(prefix, ed.compress(H)) % L
    c = _hash_points(H, Gamma, ed.scalar_mult(k, BASE), ed.scalar_mult(k, H))
    s = (k + c * x) % L
    return ed.compress(Gamma) + int.to_bytes(c, 16, "little") \
        + int.to_bytes(s, 32, "little")


def _hash_to_curve_bytes(vk: bytes, alpha: bytes) -> bytes:
    """Compressed Edwards y (sign 0) of the Elligator2 map, BEFORE
    cofactor clearing (Montgomery curve v^2 = u^3 + A u^2 + u, A = 486662;
    non-square w takes the other root; birational map to Edwards y)."""
    h = bytearray(ed.sha512(SUITE, b"\x01", vk, alpha)[:32])
    h[31] &= 0x7F
    r = int.from_bytes(bytes(h), "little")
    A = ed.A24
    u = (-A * ed.inv(1 + 2 * r * r % P)) % P
    w = u * ((u * u + A * u + 1) % P) % P
    if pow(w, (P - 1) // 2, P) != 1:
        u = (-A - u) % P
    y = (u - 1) * ed.inv(u + 1) % P
    return int.to_bytes(y, 32, "little")


@functools.lru_cache(maxsize=1 << 12)
def public_key(sk: bytes) -> bytes:
    """VRF verification key Y = [x]B for the 32-byte secret seed
    (memoised: a forger proves with a few pool keys thousands of
    times)."""
    x, _ = _secret_expand(sk)
    return ed.compress(ed.scalar_mult_base(x))


def _secret_expand(sk: bytes) -> tuple[int, bytes]:
    h = ed.sha512(sk)
    a = bytearray(h[:32])
    a[0] &= 248
    a[31] &= 127
    a[31] |= 64
    return int.from_bytes(bytes(a), "little"), h[32:]


def decode_proof(pi: bytes):
    """pi -> (Gamma, c, s) or None."""
    if len(pi) != PROOF_LEN:
        return None
    Gamma = ed.decompress(pi[:32])
    if Gamma is None:
        return None
    c = int.from_bytes(pi[32:48], "little")
    s = int.from_bytes(pi[48:80], "little")
    if s >= L:
        return None
    return Gamma, c, s


def verify(vk: bytes, alpha: bytes, pi: bytes) -> bool:
    decoded = decode_proof(pi)
    Y = ed.decompress(vk)
    if decoded is None or Y is None:
        return False
    Gamma, c, s = decoded
    H = _hash_to_curve(vk, alpha)
    # U = [s]B - [c]Y ;  V = [s]H - [c]Gamma
    U = ed.pt_add(ed.scalar_mult(s, BASE), ed.pt_neg(ed.scalar_mult(c, Y)))
    V = ed.pt_add(ed.scalar_mult(s, H), ed.pt_neg(ed.scalar_mult(c, Gamma)))
    return _hash_points(H, Gamma, U, V) == c


def proof_to_hash(pi: bytes) -> bytes:
    """beta: the VRF output bytes used for leader-election thresholds."""
    decoded = decode_proof(pi)
    if decoded is None:
        raise ValueError("invalid proof")
    Gamma, _, _ = decoded
    return ed.sha512(SUITE, b"\x03", ed.compress(ed.scalar_mult(8, Gamma)))


def output(sk: bytes, alpha: bytes) -> bytes:
    return proof_to_hash(prove(sk, alpha))
