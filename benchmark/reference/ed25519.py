"""Edwards25519 arithmetic and Ed25519 (RFC 8032) in plain Python.

Points are extended coordinates (X, Y, Z, T) with x = X/Z, y = Y/Z and
xy = T/Z on -x^2 + y^2 = 1 + d x^2 y^2 over GF(2^255 - 19).  Products
with the base point read a table of 16^i * j * B (built once a process),
so keys and signatures cost about 64 point additions; other products
take a 4-bit window.  Verification is RFC 8032 §5.1.7 without the
cofactor: [s]B = R + [k]A.
"""
from __future__ import annotations

import hashlib

P = 2 ** 255 - 19
L = 2 ** 252 + 27742317777372353535851937790883648493
D = -121665 * pow(121666, P - 2, P) % P
D2 = 2 * D % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

IDENTITY = (0, 1, 1, 0)


def inv(x: int) -> int:
    return pow(x, P - 2, P)


def add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * D2 * t2 % P
    dd = 2 * z1 * z2 % P
    e, f, g, h = b - a, dd - c, dd + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def double(p):
    x1, y1, z1, _t = p
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = 2 * z1 * z1 % P
    h = a + b
    e = h - (x1 + y1) * (x1 + y1)
    g = a - b
    f = c + g
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def neg(p):
    x, y, z, t = p
    return (-x % P, y, z, -t % P)


def equal(p, q) -> bool:
    return ((p[0] * q[2] - q[0] * p[2]) % P == 0
            and (p[1] * q[2] - q[1] * p[2]) % P == 0)


def mul(k: int, p):
    """[k]p for any point p, with a 4-bit window."""
    table = [IDENTITY, p]
    for _ in range(14):
        table.append(add(table[-1], p))
    acc = IDENTITY
    for shift in range((max(k.bit_length(), 1) + 3) // 4 * 4 - 4, -4, -4):
        acc = double(double(double(double(acc))))
        nib = (k >> shift) & 15
        if nib:
            acc = add(acc, table[nib])
    return acc


def compress(p) -> bytes:
    x, y, z, _t = p
    zi = inv(z)
    x, y = x * zi % P, y * zi % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def decompress(s: bytes):
    """The point a 32-byte encoding names, or None (RFC 8032 §5.1.3)."""
    if len(s) != 32:
        return None
    y = int.from_bytes(s, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    if y >= P:
        return None
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    x = u * pow(v, 3, P) * pow(u * pow(v, 7, P), (P - 5) // 8, P) % P
    vx2 = v * x * x % P
    if vx2 != u:
        if vx2 != -u % P:
            return None
        x = x * SQRT_M1 % P
    if x == 0 and sign:
        return None
    if x & 1 != sign:
        x = P - x
    return (x, y, 1, x * y % P)


def _base():
    y = 4 * inv(5) % P
    pt = decompress(int.to_bytes(y, 32, "little"))
    assert pt is not None
    return pt


BASE = _base()
_BASE_TABLE: list = []


def _base_table() -> list:
    """_BASE_TABLE[i][j] = [j 16^i]B, for i < 64 and j < 16."""
    if not _BASE_TABLE:
        row_base = BASE
        for _ in range(64):
            row = [IDENTITY, row_base]
            for _ in range(14):
                row.append(add(row[-1], row_base))
            _BASE_TABLE.append(row)
            for _ in range(4):
                row_base = double(row_base)
    return _BASE_TABLE


def mul_base(k: int):
    """[k]B for 0 <= k < 2^256."""
    table = _base_table()
    acc = IDENTITY
    for i in range(64):
        nib = (k >> (4 * i)) & 15
        if nib:
            acc = add(acc, table[i][nib])
    return acc


def sha512(*parts: bytes) -> bytes:
    h = hashlib.sha512()
    for part in parts:
        h.update(part)
    return h.digest()


def expand(sk: bytes) -> tuple[int, bytes]:
    """A 32-byte secret seed -> (clamped scalar, nonce prefix)."""
    h = sha512(sk)
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def public_key(sk: bytes) -> bytes:
    return compress(mul_base(expand(sk)[0]))


def sign(sk: bytes, msg: bytes) -> bytes:
    a, prefix = expand(sk)
    vk = compress(mul_base(a))
    r = int.from_bytes(sha512(prefix, msg), "little") % L
    big_r = compress(mul_base(r))
    k = int.from_bytes(sha512(big_r, vk, msg), "little") % L
    return big_r + int.to_bytes((r + k * a) % L, 32, "little")


def verify(vk: bytes, msg: bytes, sig: bytes) -> bool:
    if len(vk) != 32 or len(sig) != 64:
        return False
    a = decompress(vk)
    big_r = decompress(sig[:32])
    if a is None or big_r is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    k = int.from_bytes(sha512(sig[:32], vk, msg), "little") % L
    return equal(mul_base(s), add(big_r, mul(k, a)))
