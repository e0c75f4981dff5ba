"""Edwards25519 curve arithmetic on Python ints — the CPU reference core.

A copy of `ouroboros_tpu/crypto/edwards.py` (the port imports nothing of
the JAX package).  It is the host-side ground truth for the port's plain
PyTorch curve code and CUDA kernels (ed25519.py, vrf.py, ../csrc/), and the
source of every curve constant they use (see SURVEY.md §2 L6 —
Shelley/Protocol/Crypto.hs:15-23 pins Ed25519 + Blake2b + ECVRF).

Implements RFC 8032 curve operations: field arithmetic mod p = 2^255-19,
extended-coordinate point ops, compression/decompression, scalar mult.
"""
from __future__ import annotations

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493   # group order
A24 = 486662   # Montgomery A (for Elligator2)
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)                      # sqrt(-1)

# Base point (RFC 8032)
_g_y = (4 * pow(5, P - 2, P)) % P
_g_x = None  # filled below


def inv(x: int) -> int:
    return pow(x, P - 2, P)


def sqrt_ratio(u: int, v: int):
    """Return x with x^2 = u/v (mod p), or None if no root exists."""
    x = (u * v**3 * pow(u * v**7 % P, (P - 5) // 8, P)) % P
    if (v * x * x - u) % P == 0:
        return x
    x = (x * SQRT_M1) % P
    if (v * x * x - u) % P == 0:
        return x
    return None


# Points are extended homogeneous coordinates (X, Y, Z, T), x=X/Z y=Y/Z xy=T/Z
IDENTITY = (0, 1, 1, 0)


def pt_add(p, q):
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = (Y1 - X1) * (Y2 - X2) % P
    B = (Y1 + X1) * (Y2 + X2) % P
    C = 2 * T1 * T2 * D % P
    Dd = 2 * Z1 * Z2 % P
    E, F, G, H = B - A, Dd - C, Dd + C, B + A
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def pt_double(p):
    # dedicated doubling (RFC 8032 / HWCD08): 4M + 4S
    X1, Y1, Z1, _ = p
    A = X1 * X1 % P
    B = Y1 * Y1 % P
    C = 2 * Z1 * Z1 % P
    H = (A + B) % P
    E = (H - (X1 + Y1) * (X1 + Y1)) % P
    G = (A - B) % P
    F = (C + G) % P
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def pt_neg(p):
    X, Y, Z, T = p
    return ((-X) % P, Y, Z, (-T) % P)


def scalar_mult(s: int, p):
    q = IDENTITY
    while s > 0:
        if s & 1:
            q = pt_add(q, p)
        p = pt_double(p)
        s >>= 1
    return q


_BASE_ROWS = []       # _BASE_ROWS[j][i] = [i * 16^j]B, filled at first use


def scalar_mult_base(s: int):
    """[s]B for 0 <= s < 2^256 from a table of [i 16^j]B: one addition
    per 4-bit digit and no doublings (the same point as
    scalar_mult(s, BASE); the signers' and prover's fixed-base half)."""
    if s >> 256:
        return scalar_mult(s, BASE)
    if not _BASE_ROWS:
        p = BASE
        rows = []
        for _ in range(64):
            row = [IDENTITY]
            for _ in range(15):
                row.append(pt_add(row[-1], p))
            rows.append(row)
            p = pt_double(pt_double(pt_double(pt_double(p))))
        _BASE_ROWS[:] = rows
    q = IDENTITY
    for row in _BASE_ROWS:
        if not s:
            break
        if s & 15:
            q = pt_add(q, row[s & 15])
        s >>= 4
    return q


def pt_equal(p, q) -> bool:
    X1, Y1, Z1, _ = p
    X2, Y2, Z2, _ = q
    return (X1 * Z2 - X2 * Z1) % P == 0 and (Y1 * Z2 - Y2 * Z1) % P == 0


def compress(p) -> bytes:
    X, Y, Z, _ = p
    zi = inv(Z)
    x, y = X * zi % P, Y * zi % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def decompress(s: bytes):
    """Returns the point, or None if s is not a valid encoding."""
    if len(s) != 32:
        return None
    n = int.from_bytes(s, "little")
    sign = n >> 255
    y = n & ((1 << 255) - 1)
    if y >= P:
        return None
    x = sqrt_ratio((y * y - 1) % P, (D * y * y + 1) % P)
    if x is None:
        return None
    if x == 0 and sign == 1:
        return None
    if x & 1 != sign:
        x = P - x
    return (x, y, 1, x * y % P)


def to_affine(p):
    X, Y, Z, _ = p
    zi = inv(Z)
    return X * zi % P, Y * zi % P


def from_affine(x: int, y: int):
    return (x, y, 1, x * y % P)


_g_x = sqrt_ratio((_g_y * _g_y - 1) % P, (D * _g_y * _g_y + 1) % P)
if _g_x & 1:   # base point has even x (sign bit 0 in RFC 8032)
    _g_x = P - _g_x
BASE = from_affine(_g_x, _g_y)


def sha512(*chunks: bytes) -> bytes:
    h = hashlib.sha512()
    for c in chunks:
        h.update(c)
    return h.digest()


def sha512_int(*chunks: bytes) -> int:
    return int.from_bytes(sha512(*chunks), "little")


def is_on_curve(p) -> bool:
    x, y = to_affine(p)
    return (-x * x + y * y - 1 - D * x * x % P * y % P * y) % P == 0
