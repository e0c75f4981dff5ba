"""Batched Ed25519 verification — host prep and plain PyTorch versions.

Ported from `ouroboros_tpu/crypto/ed25519_jax.py`.  Host side (numpy +
hashlib): byte parsing, canonical-y and s < L checks, k = SHA-512(R || A ||
msg) mod L, packing into (8, N) little-endian uint32 words.  Device side,
two ladders:

- split-128 (the validation window's): decompress R, the 16-entry split
  table over {1, B, B', B+B'} x {1, -A, -A', -A-A'} (B' = [2^128]B
  constant, A' = [2^128]A from the per-key cache) and a 128-step ladder of
  one doubling plus one cached addition;
- full 256-bit (the standalone batch verify's): decompress A and R, the
  16-entry joint table [i]B + [j](-A) and 128 steps of two doublings plus
  one cached addition over 2-bit windows of s and k;

each accepting iff the result equals R projectively.  Beside them, the r3
form the compile-probe entry runs (`prepare_batch`, `verify_core`,
`finalize`, `prepare_bytes_batch`): decompression finished on the host,
the 256-bit ladder over limb arrays and bit rows, torch ops only as in
the JAX package, where it is a jitted jnp program and no Pallas kernel.

`verify_full_split_words_core` is the plain version of the `ed25519_split`
CUDA kernel (../csrc/ed25519_split.cu), `verify_full_words_core` that of
`ed25519_verify` (../csrc/ed25519_verify.cu), and `a128_core` is the
per-key fill, which stays PyTorch ops as in the JAX package.  Every formula
mirrors the JAX one field op for field op, so even lanes with off-curve
garbage give the same bytes.

Accept criterion: libsodium-compatible cofactorless verify, [s]B == R +
[k]A, with s < L enforced and non-canonical A/R rejected (ed25519_ref).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import device as device_mod
from . import edwards as ed
from . import field as F

L = ed.L
_2D = (2 * ed.D) % ed.P

# ---------------------------------------------------------------------------
# Point ops on batched limb tensors: point = (X, Y, Z, T) of (10, N)
# ---------------------------------------------------------------------------


def _cat(*xs):
    return torch.cat(xs, dim=1)


def _split(h, parts: int):
    return h.chunk(parts, dim=1)


def pt_add(p, q):
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A, B, TT, ZZ = _split(F.mul(_cat(F.sub(Y1, X1), F.add(Y1, X1), T1, Z1),
                                _cat(F.sub(Y2, X2), F.add(Y2, X2), T2, Z2)),
                          4)
    C = F.mul(TT, F.const(_2D, TT))
    D = F.add(ZZ, ZZ)
    E, Fv, G, H = F.sub(B, A), F.sub(D, C), F.add(D, C), F.add(B, A)
    return _split(F.mul(_cat(E, G, Fv, E), _cat(Fv, H, G, H)), 4)


def pt_double(p):
    X, Y, Z, _ = p
    A, B, ZZ, XY2 = _split(F.sqr(_cat(X, Y, Z, F.add(X, Y))), 4)
    C = F.add(ZZ, ZZ)
    H = F.add(A, B)
    E = F.sub(H, XY2)
    G = F.sub(A, B)
    Fv = F.add(C, G)
    return _split(F.mul(_cat(E, G, Fv, E), _cat(Fv, H, G, H)), 4)


# -- cached-point form: q as (Y-X, Y+X, 2Z, 2dT), ref10's "ge_cached"

def to_cached(q):
    X2, Y2, Z2, T2 = q
    return (F.sub(Y2, X2), F.add(Y2, X2), F.add(Z2, Z2),
            F.mul(T2, F.const(_2D, T2)))


def const_cached(x: int, y: int, ref):
    """Cached form of a CONSTANT affine point (Z = 1)."""
    return (F.const((y - x) % ed.P, ref), F.const((y + x) % ed.P, ref),
            F.const(2, ref), F.const(2 * ed.D * x * y % ed.P, ref))


def ident_cached(ref):
    """Cached form of the identity (0, 1, 1, 0) -> (1, 1, 2, 0)."""
    return (F.const(1, ref), F.const(1, ref), F.const(2, ref),
            F.const(0, ref))


def pt_add_cached(p, q):
    """p (extended) + q (cached): 8 field muls."""
    X1, Y1, Z1, T1 = p
    c0, c1, z2, t2 = q
    A, B, C, D = _split(F.mul(_cat(F.sub(Y1, X1), F.add(Y1, X1), T1, Z1),
                              _cat(c0, c1, t2, z2)), 4)
    E, Fv, G, H = F.sub(B, A), F.sub(D, C), F.add(D, C), F.add(B, A)
    return _split(F.mul(_cat(E, G, Fv, E), _cat(Fv, H, G, H)), 4)


def _identity_like(ref):
    return (F.const(0, ref), F.const(1, ref), F.const(1, ref),
            F.const(0, ref))


def const_point(x: int, y: int, ref):
    """Extended form of a constant affine point."""
    return (F.const(x, ref), F.const(y, ref), F.const(1, ref),
            F.const(x * y % ed.P, ref))


def stack_table(table):
    """List of k cached points -> (k, 40, N) for `select`."""
    return torch.stack([torch.cat(t) for t in table])


def select(stacked, idx):
    """Per-lane table lookup: entry idx[j] of lane j, as a cached point."""
    _k, rows, n = stacked.shape
    sel = stacked.gather(0, idx.to(torch.int64).view(1, 1, n)
                         .expand(1, rows, n))[0]
    return sel.chunk(4, dim=0)


# the point chain kernels' operations, in the order of their `kind` argument
POINT_OPS = ("dbl", "addc")


def point_chain_core(a: torch.Tensor, b: torch.Tensor, kind: str,
                     k: int) -> torch.Tensor:
    """Plain version of the `point_chain` and `point_chain_x4` kernels
    (experiments/microbench_field.py:186): from P = (a, b, a, b), Q <-
    pt_double(Q) (dbl) or Q <- pt_add(Q, P) (addc), k times; returns the
    unreduced limb sum X + Y + Z + T.  (10, N) carried limbs (any integer
    type) -> (10, N) int32.  P need not be on the curve: the formulas
    alone fix the value."""
    if kind not in POINT_OPS:
        raise ValueError(f"point op {kind!r} is not one of {POINT_OPS}")
    a, b = a.to(torch.int64), b.to(torch.int64)
    P = (a, b, a, b)
    Q = P
    for _ in range(k):
        Q = pt_double(Q) if kind == "dbl" else pt_add(Q, P)
    X, Y, Z, T = Q
    return F.add(F.add(F.add(X, Y), Z), T).to(torch.int32)


# ---------------------------------------------------------------------------
# Decompression (RFC 8032 §5.1.3), device_decompress:469
# ---------------------------------------------------------------------------

def _sqrt_candidate(y):
    """(u, v, x candidate) with x = u*v^3*(u*v^7)^((p-5)/8) for u = y^2-1,
    v = d*y^2+1 (RFC 8032 §5.1.3), in carried limbs."""
    one = F.const(1, y)
    y2 = F.sqr(y)
    u = F.sub(y2, one)
    v = F.add(F.mul(F.const(ed.D, y), y2), one)
    v3 = F.mul(F.sqr(v), v)
    v7 = F.mul(F.sqr(v3), v)
    return u, v, F.mul(F.mul(u, v3), F.pow_p58(F.mul(u, v7)))


def device_decompress(y, sign):
    """y: (10, N) carried limbs of canonical y; sign: (N,) x-parity bit.
    Returns (x, ok): x with the requested parity (carried limbs); ok False
    where no square root exists or x == 0 with sign == 1."""
    u, v, xc = _sqrt_candidate(y)
    vx2 = F.mul(v, F.sqr(xc))
    root_direct = F.is_zero(F.sub(vx2, u))
    root_twist = F.is_zero(F.add(vx2, u))
    ok = root_direct | root_twist
    x_twist = F.mul(xc, F.const(ed.SQRT_M1, y))
    x = F.canon(torch.where(root_direct, xc, x_twist))
    sign = sign.to(torch.int64)
    x_is_zero = (x == 0).all(dim=0)
    ok = ok & ~(x_is_zero & (sign == 1))
    x = torch.where(F.parity(x) != sign, -x, x)
    return F.carry_round(x), ok


# ---------------------------------------------------------------------------
# Split-128 ladder: s = s_lo + 2^128 s_hi, k = k_lo + 2^128 k_hi, so
#   Q = [s_lo]B + [s_hi]B' + [k_lo](-A) + [k_hi](-A')
# ---------------------------------------------------------------------------

_GX_AFF, _GY_AFF = ed.to_affine(ed.BASE)
_B128X, _B128Y = ed.to_affine(ed.scalar_mult(1 << 128, ed.BASE))
_BB128X, _BB128Y = ed.to_affine(ed.scalar_mult((1 << 128) + 1, ed.BASE))
SPLIT_CONSTS = ((_GX_AFF, _GY_AFF), (_B128X, _B128Y), (_BB128X, _BB128Y))


def split_table_16(negA, negA128):
    """16 cached-form entries T[c + 4v]: c indexes the constant half
    {1, B, B', B+B'}, v the variable half {1, -A, -A', -A-A'}."""
    ref = negA[0]
    consts_aff = (None,) + SPLIT_CONSTS
    var_ext = (None, negA, negA128, pt_add(negA, negA128))
    table = []
    for v in range(4):
        for c in range(4):
            if v == 0 and c == 0:
                table.append(ident_cached(ref))
            elif v == 0:
                table.append(const_cached(*consts_aff[c], ref))
            elif c == 0:
                table.append(to_cached(var_ext[v]))
            else:
                table.append(to_cached(pt_add(
                    var_ext[v], const_point(*consts_aff[c], ref))))
    return table


def split_idx_rows(s_words, k_words):
    """(8, N) uint32 scalar words -> (128, N) joint window digits: row i =
    s_lo + 2·s_hi + 4·k_lo + 8·k_hi at ladder iteration i (MSB-first
    within each 128-bit half)."""
    rows = []
    for i in range(128):
        rows.append(F.bit_from_words(s_words, 127 - i)
                    + 2 * F.bit_from_words(s_words, 255 - i)
                    + 4 * F.bit_from_words(k_words, 127 - i)
                    + 8 * F.bit_from_words(k_words, 255 - i))
    return torch.stack(rows)


def verify_full_split_words_core(Aw, xAw, A128xw, A128yw, Rw, signR,
                                 s_words, k_words):
    """Plain version of the `ed25519_split` kernel.  All 256-bit inputs
    are (8, N) uint32 words; A's affine x and [2^128]A come from the
    per-key cache, so callers MUST mask lanes whose key the cache did not
    know.  Returns (N,) int32 0/1."""
    yA = F.limbs_from_words(Aw)
    xA = F.limbs_from_words(xAw)
    yR = F.limbs_from_words(Rw)
    xA128 = F.limbs_from_words(A128xw)
    yA128 = F.limbs_from_words(A128yw)
    xR, okR = device_decompress(yR, signR.reshape(-1))
    one = F.const(1, yA)
    nax = F.sub(F.const(0, yA), xA)
    negA = (nax, yA, one, F.mul(nax, yA))
    nax128 = F.sub(F.const(0, yA), xA128)
    negA128 = (nax128, yA128, one, F.mul(nax128, yA128))
    table = stack_table(split_table_16(negA, negA128))
    idx = split_idx_rows(s_words, k_words)
    Q = _identity_like(yA)
    for i in range(128):
        Q = pt_add_cached(pt_double(Q), select(table, idx[i]))
    X, Y, Z, _ = Q
    d1 = F.sub(F.mul(xR, Z), X)
    d2 = F.sub(F.mul(yR, Z), Y)
    return (okR & F.is_zero(d1) & F.is_zero(d2)).to(torch.int32)


# ---------------------------------------------------------------------------
# Full 256-bit ladder (pallas_kernels._ed25519_verify_kernel): decompress A
# and R, Q = [s]B + [k](-A) over 2-bit windows of s and k, MSB first
# ---------------------------------------------------------------------------

_BASE_SMALLS = tuple(ed.to_affine(ed.scalar_mult(k, ed.BASE))
                     for k in (1, 2, 3))


def joint_table_16(negA):
    """16 cached-form entries T[4j + i] = [i]B + [j](-A) (ed25519_jax
    joint_table_16 in cached form): [i]B are affine constants, [j](-A) is
    -A, its double and double plus itself; the nine entries with both
    halves non-trivial cost one addition each."""
    ref = negA[0]
    A2 = pt_double(negA)
    var_ext = (None, negA, A2, pt_add(A2, negA))
    table = []
    for j in range(4):
        for i in range(4):
            if i == 0 and j == 0:
                table.append(ident_cached(ref))
            elif j == 0:
                table.append(const_cached(*_BASE_SMALLS[i - 1], ref))
            elif i == 0:
                table.append(to_cached(var_ext[j]))
            else:
                table.append(to_cached(pt_add(
                    var_ext[j], const_point(*_BASE_SMALLS[i - 1], ref))))
    return table


def _bits_msb_first(w):
    """(8, N) uint32 words -> (256, N) int64 bit rows, row r = bit 255 - r
    (the layout of ed25519_jax.prepare_bytes_batch's s_bits / k_bits)."""
    shifts = torch.arange(32, device=w.device)[None, :, None]
    bits = (w.to(torch.int64)[:, None, :] >> shifts) & 1
    return bits.reshape(256, -1).flip(0)


def full_idx_rows(s_words, k_words):
    """(8, N) uint32 scalar words -> (128, N) joint window digits: row i =
    (2·s[255-2i] + s[254-2i]) + 4·(2·k[255-2i] + k[254-2i])."""
    s, k = _bits_msb_first(s_words), _bits_msb_first(k_words)
    return (2 * s[0::2] + s[1::2]) + 4 * (2 * k[0::2] + k[1::2])


def verify_full_words_core(Aw, signA, Rw, signR, s_words, k_words):
    """Plain version of the `ed25519_verify` kernel: the whole verify from
    the packed words `prepare_words_batch` returns ((8, N) uint32 y_A, y_R,
    s, k with the sign bits cleared; (N,) int32 signs).  Returns (N,)
    int32 0/1; callers mask the host parse (`parse_ok`)."""
    yA = F.limbs_from_words(Aw)
    yR = F.limbs_from_words(Rw)
    xA, okA = device_decompress(yA, signA.reshape(-1))
    xR, okR = device_decompress(yR, signR.reshape(-1))
    nax = F.sub(F.const(0, yA), xA)
    negA = (nax, yA, F.const(1, yA), F.mul(nax, yA))
    table = stack_table(joint_table_16(negA))
    idx = full_idx_rows(s_words, k_words)
    Q = _identity_like(yA)
    for i in range(128):
        Q = pt_add_cached(pt_double(pt_double(Q)), select(table, idx[i]))
    X, Y, Z, _ = Q
    d1 = F.sub(F.mul(xR, Z), X)
    d2 = F.sub(F.mul(yR, Z), Y)
    return (okA & okR & F.is_zero(d1) & F.is_zero(d2)).to(torch.int32)


def batch_verify(vks, msgs, sigs, pad_to: int | None = None,
                 device=None) -> list[bool]:
    """End-to-end batched verify through the `ed25519_verify` kernel
    (ed25519_jax.batch_verify); the same function as
    `kernels.batch_verify_ed25519`."""
    from .kernels import batch_verify_ed25519     # kernels imports this
    return batch_verify_ed25519(vks, msgs, sigs, pad_to=pad_to,
                                device=device)


def a128_core(yA, signA):
    """Per-key precompute: decompress A, then [2^128]A by 128 doublings
    and one inversion to canonical affine.  Returns (xA, x128, y128, ok),
    the first three as canonical digits."""
    xA, ok = device_decompress(yA, signA)
    one = F.const(1, yA)
    P = (xA, yA, one, F.mul(xA, yA))
    for _ in range(128):
        P = pt_double(P)
    Zi = F.pow_inv(P[2])
    return (F.canon(xA), F.canon(F.mul(P[0], Zi)),
            F.canon(F.mul(P[1], Zi)), ok)


# ---------------------------------------------------------------------------
# Host prep (numpy; ed25519_jax.py:389-752)
# ---------------------------------------------------------------------------

def _words_of_int(v: int) -> np.ndarray:
    return np.frombuffer(int(v).to_bytes(32, "little"),
                         dtype=np.uint32).copy()


# filler for padding / undecodable keys: any valid point works, such
# lanes are masked invalid before the result is read
_B128X_W = _words_of_int(_B128X)
_B128Y_W = _words_of_int(_B128Y)
_GX_W = _words_of_int(_GX_AFF)


def words_from_bytes_rows(arr: np.ndarray) -> np.ndarray:
    """(N, 32) uint8 little-endian byte rows -> (8, N) uint32 words."""
    return np.ascontiguousarray(
        arr.reshape(-1, 8, 4).view(np.uint32)[:, :, 0].T)


def _bytes_rows(items, width) -> tuple[np.ndarray, np.ndarray]:
    """Stack byte strings into an (N, width) uint8 array; wrong-length rows
    become zeros with ok=False."""
    n = len(items)
    ok = np.ones(n, dtype=bool)
    bad = [j for j, b in enumerate(items) if len(b) != width]
    if bad:
        items = list(items)
        for j in bad:
            items[j] = b"\x00" * width
            ok[j] = False
    arr = np.frombuffer(b"".join(items), dtype=np.uint8).reshape(n, width)
    return arr, ok


def _decode_compressed(arr: np.ndarray):
    """(N, 32) little-endian compressed points -> (y words (8, N) uint32
    with the sign bit cleared, sign (N,) int32, ok (N,) canonical-y
    mask).  The port's form of ed25519_jax._decode_compressed, which
    returned radix-2^13 limbs; the words carry the same value."""
    sign = (arr[:, 31] >> 7).astype(np.int32)
    clear = arr.copy()
    clear[:, 31] &= 0x7F
    return words_from_bytes_rows(clear), sign, _y_canonical(arr)


def _scalar_lt_L(s_rows: np.ndarray) -> np.ndarray:
    """(N, 32) little-endian scalars: mask of s < L."""
    top = s_rows[:, 31]
    ok = top < 0x10
    borderline = np.nonzero(top == 0x10)[0]
    for j in borderline:
        s = int.from_bytes(s_rows[j].tobytes(), "little")
        ok[j] = s < L
    return ok


def _y_canonical(arr: np.ndarray) -> np.ndarray:
    """(N, 32) little-endian point rows: mask of y < p with the sign bit
    ignored (y >= p iff the 255 low bits are all-ones down to byte 1 and
    byte 0 >= 0xED, since p = 2^255 - 19)."""
    return ~(((arr[:, 31] & 0x7F) == 0x7F)
             & (arr[:, 1:31] == 0xFF).all(axis=1)
             & (arr[:, 0] >= 0xED))


def prepare_words_batch(vks, msgs, sigs):
    """Packed-words host prep for verify_full_split_words_core (which
    takes A's x from the per-key cache instead of signA) and
    verify_full_words_core.

    Returns ((Aw, signA, Rw, signR, sw, kw), parse_ok): the 256-bit
    inputs as (8, N) uint32 word rows (sign bits cleared out of Aw/Rw
    into the (N,) int32 sign vectors)."""
    n = len(vks)
    vk_arr, vk_ok = _bytes_rows(vks, 32)
    sig_arr, sig_ok = _bytes_rows(sigs, 64)
    signA = (vk_arr[:, 31] >> 7).astype(np.int32)
    signR = (sig_arr[:, 31] >> 7).astype(np.int32)
    a_ok = _y_canonical(vk_arr)
    r_ok = _y_canonical(sig_arr[:, :32])
    s_rows = np.ascontiguousarray(sig_arr[:, 32:])
    s_ok = _scalar_lt_L(s_rows)
    parse_ok = vk_ok & sig_ok & a_ok & r_ok & s_ok
    vk_clear = vk_arr.copy()
    vk_clear[:, 31] &= 0x7F
    r_clear = sig_arr[:, :32].copy()
    r_clear[:, 31] &= 0x7F
    k_bytes = bytearray()
    for j in range(n):
        if parse_ok[j]:
            k = ed.sha512_int(bytes(sig_arr[j, :32]), bytes(vk_arr[j]),
                              msgs[j]) % L
        else:
            k = 0
        k_bytes += k.to_bytes(32, "little")
    k_rows = np.frombuffer(bytes(k_bytes), dtype=np.uint8).reshape(n, 32)
    return ((words_from_bytes_rows(vk_clear), signA,
             words_from_bytes_rows(r_clear), signR,
             words_from_bytes_rows(s_rows),
             words_from_bytes_rows(k_rows)), parse_ok)


# ---------------------------------------------------------------------------
# The r3 form (ed25519_jax.py:190-232, 451-466, 531-630, 680-710): the
# square root of decompression on the device, its cheap tail in Python
# ints, then the 256-bit ladder over limb arrays and bit rows, its (d1, d2)
# reduced on the host.  The compile-probe entry (graft_entry.py) runs it;
# it is the JAX form's parity surface there and no user path runs it (the
# ed25519_verify kernel verifies ~400x faster).  The JAX package's limbs
# are 20 of radix 2^13 and these are the port's 10, so only the bit rows,
# the valid mask and `prepare_bytes_batch` come out byte for byte the JAX
# package's; the limbs agree on their integers (`limbs_from_jax`).
# ---------------------------------------------------------------------------


def limbs_from_jax(arr, device=None) -> torch.Tensor:
    """(20, N) limbs of the JAX package's field (radix 2^13, e.g.
    ed25519_jax.prepare_batch's) -> the port's (10, N) carried limbs of
    the same integers mod p, on `device` (the card by default)."""
    dev = device_mod.resolve(device)
    return F.limbs_from_radix13(np.asarray(arr)).to(dev)


def decompress_kernel(y):
    """Batched candidate square root for point decompression: (10, N)
    carried limbs of canonical y -> x = u*v^3*(u*v^7)^((p-5)/8) for
    u = y^2-1, v = d*y^2+1.  The host applies the cheap final steps
    (`_finish_decompress`)."""
    return _sqrt_candidate(y)[2]


def _finish_decompress(y: int, sign: int, x_cand: int):
    """Cheap host tail of decompression given the device sqrt candidate."""
    u = (y * y - 1) % ed.P
    v = (ed.D * y * y + 1) % ed.P
    vx2 = v * x_cand * x_cand % ed.P
    if vx2 == u:
        x = x_cand
    elif vx2 == ed.P - u:
        x = x_cand * ed.SQRT_M1 % ed.P
    else:
        return None
    if x == 0 and sign == 1:
        return None
    if x & 1 != sign:
        x = ed.P - x
    return x


def _int_bits_msb_first(x: int, nbits: int = 256) -> np.ndarray:
    raw = np.frombuffer(x.to_bytes(nbits // 8, "big"), dtype=np.uint8)
    return np.unpackbits(raw).astype(np.int32)


def prepare_batch(vks, msgs, sigs, device=None):
    """Host prep of the r3 form: decode and hash every (vk, msg, sig).

    The square roots of decompression run batched on `device` (the card
    by default; raises without one unless given "cpu")
    (`decompress_kernel`, A's ys and R's in one call); the host does the
    parsing, SHA-512, the root check and sign fix, and packing.

    Returns ((nax, nay, nat, rx, ry, s_bits, k_bits), valid): -A's x, y and
    x*y and R's x and y as (10, N) carried limbs, s and k as (256, N)
    int32 MSB-first bit rows, all on `device`; `valid` an (N,) numpy bool
    mask.  Invalid entries (bad point encoding, s >= L, wrong length) get
    zero inputs and are masked False."""
    device = device_mod.resolve(device)
    n = len(vks)
    y_A = [0] * n
    y_R = [0] * n
    sign_A = [0] * n
    sign_R = [0] * n
    ss = [0] * n
    ks = [0] * n
    parse_ok = np.zeros(n, dtype=bool)
    mask255 = (1 << 255) - 1
    for j in range(n):
        vk, msg, sig = vks[j], msgs[j], sigs[j]
        if len(sig) != 64 or len(vk) != 32:
            continue
        na = int.from_bytes(vk, "little")
        nr = int.from_bytes(sig[:32], "little")
        ya, yr = na & mask255, nr & mask255
        if ya >= ed.P or yr >= ed.P:
            continue
        s = int.from_bytes(sig[32:], "little")
        if s >= L:
            continue
        y_A[j], sign_A[j] = ya, na >> 255
        y_R[j], sign_R[j] = yr, nr >> 255
        ss[j] = s
        ks[j] = ed.sha512_int(sig[:32], vk, msg) % L
        parse_ok[j] = True
    xs = F.unpack(decompress_kernel(F.pack(y_A + y_R, device=device)))
    vals = {name: [0] * n for name in ("nax", "nay", "nat", "rx", "ry")}
    s_bits = np.zeros((256, n), np.int32)
    k_bits = np.zeros((256, n), np.int32)
    valid = np.zeros(n, dtype=bool)
    for j in range(n):
        if not parse_ok[j]:
            continue
        ax = _finish_decompress(y_A[j], sign_A[j], xs[j])
        rx = _finish_decompress(y_R[j], sign_R[j], xs[n + j])
        if ax is None or rx is None:
            continue
        nax = (ed.P - ax) % ed.P
        vals["nax"][j] = nax
        vals["nay"][j] = y_A[j]
        vals["nat"][j] = nax * y_A[j] % ed.P
        vals["rx"][j] = rx
        vals["ry"][j] = y_R[j]
        s_bits[:, j] = _int_bits_msb_first(ss[j])
        k_bits[:, j] = _int_bits_msb_first(ks[j])
        valid[j] = True
    limbs = tuple(F.pack(vals[k], device=device)
                  for k in ("nax", "nay", "nat", "rx", "ry"))
    bits = tuple(torch.from_numpy(b).to(device) for b in (s_bits, k_bits))
    return limbs + bits, valid


def verify_core(negA_x, negA_y, negA_t, Rx, Ry, s_bits, k_bits,
                nbits: int = 256):
    """Q = [s]B + [k](-A); the projective differences from affine R.

    Inputs: (10, N) carried limbs; (nbits, N) MSB-first bit rows.  Returns
    (d1, d2) = (Rx*Z_Q - X_Q, Ry*Z_Q - Y_Q) as (10, N) limbs on the
    inputs' device: the signature holds iff both are 0 mod p
    (`finalize`).  Windowed Strauss-Shamir with w = 2: nbits/2 steps of
    two doublings and one addition of T[s digit + 4 k digit] from the
    joint table [i]B + [j](-A).  The table's cached entries and the
    cached addition give the JAX form's extended-coordinate values mod p
    step for step, so d1 and d2 equal its own mod p even where the
    signature fails."""
    negA = (negA_x, negA_y, F.const(1, negA_x), negA_t)
    table = stack_table(joint_table_16(negA))
    s = torch.as_tensor(s_bits, device=negA_x.device).to(torch.int64)
    k = torch.as_tensor(k_bits, device=negA_x.device).to(torch.int64)
    idx = (2 * s[0:nbits:2] + s[1:nbits:2]) \
        + 4 * (2 * k[0:nbits:2] + k[1:nbits:2])
    Q = _identity_like(negA_x)
    for i in range(nbits // 2):
        Q = pt_add_cached(pt_double(pt_double(Q)), select(table, idx[i]))
    X, Y, Z, _ = Q
    return F.sub(F.mul(Rx, Z), X), F.sub(F.mul(Ry, Z), Y)


# the JAX package jits verify_core with nbits static; here it is the same
# function, nbits a plain argument
verify_kernel = verify_core

_LIMB_WEIGHTS = np.array([1 << o for o in F.OFFSETS], dtype=object)


def finalize(d1, d2, valid) -> list[bool]:
    """Reduce the (uncarried, possibly negative) limb differences to ints
    mod p on the host and accept where both vanish."""
    v1 = (_LIMB_WEIGHTS @ d1.cpu().numpy().astype(object)) % ed.P
    v2 = (_LIMB_WEIGHTS @ d2.cpu().numpy().astype(object)) % ed.P
    ok = (v1 == 0) & (v2 == 0) & np.asarray(valid, dtype=bool)
    return [bool(b) for b in ok]


_RADIX13_W = (1 << np.arange(13)).astype(np.int32)


def _byte_rows_of_words(w: np.ndarray) -> np.ndarray:
    """(8, N) uint32 words -> (N, 32) uint8 little-endian byte rows."""
    return np.ascontiguousarray(w.T).view(np.uint8)


def _radix13_of_words(w: np.ndarray) -> np.ndarray:
    """(8, N) uint32 words of values below 2^255 -> (20, N) int32 digits
    of radix 2^13, the JAX package's limbs."""
    bits = np.unpackbits(_byte_rows_of_words(w), axis=1, bitorder="little")
    padded = np.pad(bits, ((0, 0), (0, 20 * 13 - 256)))
    limbs = padded.reshape(-1, 20, 13).astype(np.int32) @ _RADIX13_W
    return np.ascontiguousarray(limbs.T)


def _msb_bits_of_words(w: np.ndarray) -> np.ndarray:
    """(8, N) uint32 words -> (256, N) int32 MSB-first bit rows."""
    bits = np.unpackbits(_byte_rows_of_words(w)[:, ::-1], axis=1,
                         bitorder="big")
    return np.ascontiguousarray(bits.T).astype(np.int32)


def prepare_bytes_batch(vks, msgs, sigs):
    """Numpy-only host prep of the JAX package's fused full verify,
    byte for byte ed25519_jax.prepare_bytes_batch: `prepare_words_batch`
    (the parse, the s < L check and k's hash) in the JAX layout.

    Returns ((yA, signA, yR, signR, s_bits, k_bits), parse_ok): yA and yR
    as (20, N) int32 radix-2^13 limbs (`limbs_from_jax` gives the port's),
    the signs (N,) int32, s and k as (256, N) int32 MSB-first bit rows."""
    (Aw, signA, Rw, signR, sw, kw), parse_ok = \
        prepare_words_batch(vks, msgs, sigs)
    return ((_radix13_of_words(Aw), signA, _radix13_of_words(Rw), signR,
             _msb_bits_of_words(sw), _msb_bits_of_words(kw)), parse_ok)
