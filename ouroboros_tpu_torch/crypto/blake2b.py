"""Batched BLAKE2b-256 — the KES hash-path check, plain PyTorch version.

Ported from `ouroboros_tpu/crypto/blake2b_jax.py`.  Verifying one Sum6KES
signature (Shelley/Protocol/Crypto.hs:15-23) checks a depth-long chain of
Blake2b-256 hashes over 64-byte (vk_L || vk_R) pairs; a cold window turns
every path into `depth` jobs of one compression each.  This module holds
the host word packing and the plain version of the check; the CUDA kernel
is ../csrc/kes_hash.cu (wrapper: kernels.kes_hash).

64-bit words are (lo, hi) pairs of int64 tensors holding 32-bit values,
as in blake2b_jax (`_add64`, `_rotr64`): torch has no unsigned 64-bit
arithmetic, and signed overflow is avoided by masking after every add.

Oracle: hashlib.blake2b(digest_size=32).
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF

# BLAKE2b IV (64-bit words)
IV = (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B,
    0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
)

SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)
ROUNDS = tuple(SIGMA[r % 10] for r in range(12))

# h0 with parameter block for digest_size=32, no key, fanout=depth=1
H0 = (IV[0] ^ 0x01010020,) + IV[1:]


# -- host packing (blake2b_jax.msg_words / digest_words) -------------------

def msg_words(msgs64: np.ndarray) -> np.ndarray:
    """(N, 64) uint8 rows -> (16, N) uint32 interleaved word rows."""
    return np.ascontiguousarray(
        msgs64.reshape(-1, 16, 4).view(np.uint32)[:, :, 0].T)


def digest_words(digs32: np.ndarray) -> np.ndarray:
    """(N, 32) uint8 digest rows -> (8, N) uint32 interleaved word rows."""
    return np.ascontiguousarray(
        digs32.reshape(-1, 8, 4).view(np.uint32)[:, :, 0].T)


# -- (lo, hi) 64-bit arithmetic on int64 tensors of 32-bit values ---------

def add64(a, b):
    lo = a[0] + b[0]
    return lo & M32, (a[1] + b[1] + (lo >> 32)) & M32


def xor64(a, b):
    return a[0] ^ b[0], a[1] ^ b[1]


def and64(a, b):
    return a[0] & b[0], a[1] & b[1]


def not64(a):
    return a[0] ^ M32, a[1] ^ M32


def rotr64(a, r: int):
    lo, hi = a
    if r == 32:
        return hi, lo
    if r > 32:
        lo, hi, r = hi, lo, r - 32
    return (((lo >> r) | (hi << (32 - r))) & M32,
            ((hi >> r) | (lo << (32 - r))) & M32)


def shr64(a, r: int):
    lo, hi = a
    if r >= 32:
        return hi >> (r - 32), hi * 0
    return ((lo >> r) | (hi << (32 - r))) & M32, hi >> r


def c64(x: int, ref):
    """64-bit constant as a (lo, hi) pair broadcast to ref's lane shape."""
    return (torch.full_like(ref, x & M32), torch.full_like(ref, x >> 32))


def _g(v, a, b, c, d, mx, my):
    v[a] = add64(add64(v[a], v[b]), mx)
    v[d] = rotr64(xor64(v[d], v[a]), 32)
    v[c] = add64(v[c], v[d])
    v[b] = rotr64(xor64(v[b], v[c]), 24)
    v[a] = add64(add64(v[a], v[b]), my)
    v[d] = rotr64(xor64(v[d], v[a]), 16)
    v[c] = add64(v[c], v[d])
    v[b] = rotr64(xor64(v[b], v[c]), 63)


def compress_block64(m_words: torch.Tensor) -> torch.Tensor:
    """One final-block BLAKE2b-256 compression over 64-byte messages.

    m_words: (16, N) uint32 — message words 0..7 as (lo, hi) interleaved
    rows; words 8..15 are implicit zero.  Returns (8, N) int64 holding the
    32-byte digest as interleaved (lo, hi) 32-bit values."""
    mw = m_words.to(torch.int64) & M32
    ref = mw[0]
    zero = ref * 0
    h = [c64(x, ref) for x in H0]
    v = list(h + [c64(x, ref) for x in IV])
    v[12] = xor64(v[12], c64(64, ref))                   # t0 = 64 bytes
    v[14] = xor64(v[14], c64(0xFFFFFFFFFFFFFFFF, ref))   # final block
    m = [(mw[2 * i], mw[2 * i + 1]) for i in range(8)] + [(zero, zero)] * 8
    for s in ROUNDS:
        mm = [m[j] for j in s]
        _g(v, 0, 4, 8, 12, mm[0], mm[1])
        _g(v, 1, 5, 9, 13, mm[2], mm[3])
        _g(v, 2, 6, 10, 14, mm[4], mm[5])
        _g(v, 3, 7, 11, 15, mm[6], mm[7])
        _g(v, 0, 5, 10, 15, mm[8], mm[9])
        _g(v, 1, 6, 11, 12, mm[10], mm[11])
        _g(v, 2, 7, 8, 13, mm[12], mm[13])
        _g(v, 3, 4, 9, 14, mm[14], mm[15])
    out = []
    for i in range(4):
        lo, hi = xor64(xor64(h[i], v[i]), v[i + 8])
        out.extend((lo, hi))
    return torch.stack(out)


def check_block64(m_words: torch.Tensor,
                  expect_words: torch.Tensor) -> torch.Tensor:
    """(16, N) message words + (8, N) expected digest words -> (N,) int32
    equality mask.  Plain version of the `kes_hash` kernel."""
    d = compress_block64(m_words)
    e = expect_words.to(torch.int64) & M32
    return (d == e).all(dim=0).to(torch.int32)
