"""Batched SHA-512 in PyTorch ops — the VRF challenge fold.

Ported from `ouroboros_tpu/crypto/sha512_jax.py`.  The ECVRF verdict is
c == SHA512(suite || 0x02 || H || Gamma || U || V)[:16], where H, U, V are
device-computed points; hashing next to the ladder output lets only the
first failing request index leave the device (torch_backend's fold).
The JAX package keeps this as plain array code with no Pallas kernel, and
so does the port.

64-bit words are (lo, hi) pairs of int64 tensors holding 32-bit values,
as in blake2b.py.  Messages are fixed-length per call site (the 130-byte
challenge preimage), so padding is a static concatenation.

Oracle: hashlib.sha512.
"""
from __future__ import annotations

import torch

from .blake2b import M32, add64, and64, not64, rotr64, shr64, xor64

H0 = (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B,
    0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
)

K = (
    0x428A2F98D728AE22, 0x7137449123EF65CD, 0xB5C0FBCFEC4D3B2F,
    0xE9B5DBA58189DBBC, 0x3956C25BF348B538, 0x59F111F1B605D019,
    0x923F82A4AF194F9B, 0xAB1C5ED5DA6D8118, 0xD807AA98A3030242,
    0x12835B0145706FBE, 0x243185BE4EE4B28C, 0x550C7DC3D5FFB4E2,
    0x72BE5D74F27B896F, 0x80DEB1FE3B1696B1, 0x9BDC06A725C71235,
    0xC19BF174CF692694, 0xE49B69C19EF14AD2, 0xEFBE4786384F25E3,
    0x0FC19DC68B8CD5B5, 0x240CA1CC77AC9C65, 0x2DE92C6F592B0275,
    0x4A7484AA6EA6E483, 0x5CB0A9DCBD41FBD4, 0x76F988DA831153B5,
    0x983E5152EE66DFAB, 0xA831C66D2DB43210, 0xB00327C898FB213F,
    0xBF597FC7BEEF0EE4, 0xC6E00BF33DA88FC2, 0xD5A79147930AA725,
    0x06CA6351E003826F, 0x142929670A0E6E70, 0x27B70A8546D22FFC,
    0x2E1B21385C26C926, 0x4D2C6DFC5AC42AED, 0x53380D139D95B3DF,
    0x650A73548BAF63DE, 0x766A0ABB3C77B2A8, 0x81C2C92E47EDAEE6,
    0x92722C851482353B, 0xA2BFE8A14CF10364, 0xA81A664BBC423001,
    0xC24B8B70D0F89791, 0xC76C51A30654BE30, 0xD192E819D6EF5218,
    0xD69906245565A910, 0xF40E35855771202A, 0x106AA07032BBD1B8,
    0x19A4C116B8D2D0C8, 0x1E376C085141AB53, 0x2748774CDF8EEB99,
    0x34B0BCB5E19B48A8, 0x391C0CB3C5C95A63, 0x4ED8AA4AE3418ACB,
    0x5B9CCA4F7763E373, 0x682E6FF3D6B2B8A3, 0x748F82EE5DEFB2FC,
    0x78A5636F43172F60, 0x84C87814A1F0AB72, 0x8CC702081A6439EC,
    0x90BEFFFA23631E28, 0xA4506CEBDE82BDE9, 0xBEF9A3F7B2C67915,
    0xC67178F2E372532B, 0xCA273ECEEA26619C, 0xD186B8C721C0C207,
    0xEADA7DD6CDE0EB1E, 0xF57D4F7FEE6ED178, 0x06F067AA72176FBA,
    0x0A637DC5A2C898A6, 0x113F9804BEF90DAE, 0x1B710B35131C471B,
    0x28DB77F523047D84, 0x32CAAB7B40C72493, 0x3C9EBE0A15C9BEBC,
    0x431D67C49C100D4C, 0x4CC5D4BECB3E42B6, 0x597F299CFC657E2A,
    0x5FCB6FAB3AD6FAEC, 0x6C44198C4A475817,
)


def _pad_tail(length: int) -> bytes:
    """SHA-512 pad bytes for a fixed message length (0x80, zeros, 16-byte
    big-endian bit length)."""
    n_blocks = (length + 17 + 127) // 128
    tail = bytearray(n_blocks * 128 - length)
    tail[0] = 0x80
    tail[-16:] = (length * 8).to_bytes(16, "big")
    return bytes(tail)


def _sigma(x, r1: int, r2: int, shift: int):
    """σ0/σ1: ROTR(r1) ^ ROTR(r2) ^ SHR(shift)."""
    return xor64(xor64(rotr64(x, r1), rotr64(x, r2)), shr64(x, shift))


def _big_sigma(x, r1: int, r2: int, r3: int):
    """Σ0/Σ1: three rotations."""
    return xor64(xor64(rotr64(x, r1), rotr64(x, r2)), rotr64(x, r3))


def _const64(x: int, ref):
    return ref * 0 + (x & M32), ref * 0 + (x >> 32)


def digest_words(msg_u8: torch.Tensor, length: int):
    """SHA-512 of (N, length) uint8 rows.  Returns (lo, hi): two lists of
    eight (N,) int64 tensors — the digest as big-endian 64-bit words in
    32-bit halves."""
    n = msg_u8.shape[0]
    tail = torch.tensor(list(_pad_tail(length)), dtype=torch.int64,
                        device=msg_u8.device)
    padded = torch.cat([msg_u8.to(torch.int64),
                        tail[None, :].expand(n, tail.shape[0])], dim=1)
    b = padded.reshape(n, -1, 16, 8)
    hi_w = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    lo_w = (b[..., 4] << 24) | (b[..., 5] << 16) | (b[..., 6] << 8) | b[..., 7]
    ref = lo_w[:, 0, 0]
    h = [_const64(x, ref) for x in H0]
    for blk in range(lo_w.shape[1]):
        w = [(lo_w[:, blk, i], hi_w[:, blk, i]) for i in range(16)]
        a, bb, c, d, e, f, g, hh = h
        for t in range(80):
            if t >= 16:
                w.append(add64(
                    add64(_sigma(w[t - 2], 19, 61, 6), w[t - 7]),
                    add64(_sigma(w[t - 15], 1, 8, 7), w[t - 16])))
            ch = xor64(and64(e, f), and64(not64(e), g))
            t1 = add64(add64(add64(hh, _big_sigma(e, 14, 18, 41)),
                             add64(ch, _const64(K[t], ref))), w[t])
            maj = xor64(xor64(and64(a, bb), and64(a, c)), and64(bb, c))
            t2 = add64(_big_sigma(a, 28, 34, 39), maj)
            a, bb, c, d, e, f, g, hh = (add64(t1, t2), a, bb, c,
                                        add64(d, t1), e, f, g)
        h = [add64(x, y) for x, y in zip(h, (a, bb, c, d, e, f, g, hh))]
    return [x[0] for x in h], [x[1] for x in h]


def prefix16_eq(msg_u8: torch.Tensor, length: int,
                c_u8: torch.Tensor) -> torch.Tensor:
    """digest(msg)[:16] == c: (N,) bool.  `c_u8` is (N, 16) uint8; only the
    first two 64-bit digest words are compared, as big-endian halves."""
    lo, hi = digest_words(msg_u8, length)
    c = c_u8.to(torch.int64)

    def be32(o):
        return (c[:, o] << 24) | (c[:, o + 1] << 16) | (c[:, o + 2] << 8) \
            | c[:, o + 3]
    return ((hi[0] == be32(0)) & (lo[0] == be32(4))
            & (hi[1] == be32(8)) & (lo[1] == be32(12)))
