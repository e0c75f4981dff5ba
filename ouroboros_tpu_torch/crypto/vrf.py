"""Batched ECVRF-ED25519-SHA512-Elligator2 verification — host prep and
plain PyTorch versions.

Ported from `ouroboros_tpu/crypto/vrf_jax.py` (the PraosVRF of
Shelley/Protocol.hs:366-415, libsodium crypto_vrf_ietfdraft03):

  host (numpy/hashlib): byte parsing, canonical-y and s < L checks, the
      Elligator input r = SHA512(suite || 0x01 || Y || alpha)[:32], the
      beta hashes;
  device: decompress Gamma, the Elligator2 map in projective form,
      cofactor clearing, [8]Gamma for beta, U = [s]B - [c]Y and V = [s]H -
      [c]Gamma as 128-step split triple ladders, affine conversion and
      compression to bytes, then (fold) the SHA-512 challenge check.

`vrf_verify_words_core` is the plain version of the `vrf_verify` CUDA
kernel and `gamma8_words_core` of `gamma8` (../csrc/), which the
standalone `batch_verify_vrf` and `batch_betas` launch; every formula
mirrors the JAX one field op for field op, so lanes with off-curve
garbage give the same bytes.  `challenge_ok_device` stays PyTorch ops, as
it stays jnp in the JAX package.

vrf_ref is the bit-exactness oracle.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import device as device_mod
from . import ed25519 as E
from . import edwards as ed
from . import field as F
from .precompute import shared_cache
from .vrf_ref import PROOF_LEN, SUITE

_GX, _GY = ed.to_affine(ed.BASE)
# [2^128]B — constant for the split-scalar ladder
_G2X, _G2Y = ed.to_affine(ed.scalar_mult(1 << 128, ed.BASE))
_A = ed.A24                           # Montgomery A = 486662
# reference fallback for the measure-zero Elligator edge case 1+2r^2 == 0:
# the host path yields u = -A, y = (-A-1)/(1-A)
_Y_W0 = (ed.P - _A - 1) * ed.inv((1 - _A) % ed.P) % ed.P


def _triple_table_cached(P1, P1p, P2):
    """8-entry cached-form table over bit combinations lo + 2·hi + 4·c of
    Q += [lo]P1 + [hi]P1' + [c]P2."""
    t3 = E.pt_add(P1, P1p)
    t5 = E.pt_add(P1, P2)
    t6 = E.pt_add(P1p, P2)
    t7 = E.pt_add(t3, P2)
    ext = (P1, P1p, t3, P2, t5, t6, t7)
    return [E.ident_cached(P1[0])] + [E.to_cached(p) for p in ext]


def _triple_ladder_idx(P1, P1p, P2, idx_rows):
    """Q = [lo]P1 + [hi]P1' + [c]P2 in 128 iterations; idx_rows (128, N)
    digits lo + 2·hi + 4·c, MSB-first.  Returns projective (X, Y, Z)."""
    table = E.stack_table(_triple_table_cached(P1, P1p, P2))
    Q = E._identity_like(P1[0])
    for i in range(128):
        Q = E.pt_add_cached(E.pt_double(Q), E.select(table, idx_rows[i]))
    return Q[0], Q[1], Q[2]


def _sqrt_ratio(u, v):
    """x with x^2 = u/v (RFC 8032 §5.1.3 candidate + twist), plus ok mask.
    x is the even-parity affine root — the sign-0 decompression choice."""
    v3 = F.mul(F.mul(v, v), v)
    v7 = F.mul(F.mul(v3, v3), v)
    xc = F.mul(F.mul(u, v3), F.pow_p58(F.mul(u, v7)))
    vx2 = F.mul(v, F.mul(xc, xc))
    root_direct = F.is_zero(F.sub(vx2, u))
    root_twist = F.is_zero(F.add(vx2, u))
    ok = root_direct | root_twist
    x = F.canon(torch.where(root_direct, xc,
                            F.mul(xc, F.const(ed.SQRT_M1, u))))
    return F.carry_round(torch.where(F.parity(x) == 1, -x, x)), ok


def elligator2_fraction(r):
    """Projective Elligator2: r -> Edwards point, inversion-free.

    u = U/W with W = 1 + 2r^2 and U = -A or -2Ar^2, chi(w) = chi(-A * c1 *
    W) with c1 = W^2 - 2A^2 r^2, and y = (U-W)/(U+W) kept as a fraction
    into the square root ratio (vrf_jax.elligator2_fraction).  Returns
    extended (X, Y, Z, T) with Z = U+W."""
    one = F.const(1, r)
    zero = F.const(0, r)
    Ac = F.const(_A, r)
    r2 = F.mul(r, r)
    two_r2 = F.add(r2, r2)
    W = F.add(two_r2, one)                          # 1 + 2r^2
    c1 = F.sub(F.mul(W, W), F.mul(F.mul(Ac, Ac), two_r2))
    chi_in = F.sub(zero, F.mul(Ac, F.mul(c1, W)))
    is_sq = F.is_zero(F.sub(F.pow_chi(chi_in), one))
    negA = F.sub(zero, Ac)
    U = torch.where(is_sq, negA, F.mul(negA, two_r2))   # -A  |  -2A r^2
    Yn = F.sub(U, W)
    Yd = F.add(U, W)
    # measure-zero reference edge cases (vrf_jax module docstring)
    w_zero = F.is_zero(W)
    Yn = torch.where(w_zero, F.const(_Y_W0, r), Yn)
    Yd = torch.where(w_zero, one, Yd)
    d_zero = F.is_zero(Yd)
    Yn = torch.where(d_zero, zero, Yn)
    Yd = torch.where(d_zero, one, Yd)
    # decompress y = Yn/Yd with sign 0: x^2 = (y^2-1)/(d y^2+1)
    Yn2 = F.mul(Yn, Yn)
    Yd2 = F.mul(Yd, Yd)
    u_num = F.sub(Yn2, Yd2)
    v_num = F.add(F.mul(F.const(ed.D, r), Yn2), Yd2)
    x, ok = _sqrt_ratio(u_num, v_num)
    # x == 0 with sign 0 is fine; failure -> BASE (vrf_ref._hash_to_curve)
    X = torch.where(ok, F.mul(x, Yd), F.const(_GX, r))
    Y = torch.where(ok, Yn, F.const(_GY, r))
    Z = torch.where(ok, Yd, one)
    T = torch.where(ok, F.mul(x, Yn), F.const(_GX * _GY % ed.P, r))
    return (X, Y, Z, T)


def _double3(pt):
    return E.pt_double(E.pt_double(E.pt_double(pt)))


def compress(X, Y, Z):
    """Projective points -> (32, N) int64 byte values of the compressed
    encoding (y little-endian, x parity in bit 255)."""
    Zi = F.pow_inv(Z)
    xc = F.canon(F.mul(X, Zi))
    out = F.bytes_from_canon(F.canon(F.mul(Y, Zi)))
    return torch.cat([out[:31], (out[31] | (F.parity(xc) << 7))[None]])


def _vrf_idx_rows(c_words, s_words):
    """(4, N) challenge words + (8, N) scalar words -> (128, N) digits."""
    rows = []
    for i in range(128):
        rows.append(F.bit_from_words(s_words, 127 - i)
                    + 2 * F.bit_from_words(s_words, 255 - i)
                    + 4 * F.bit_from_words(c_words, 127 - i))
    return torch.stack(rows)


def vrf_verify_words_core(Yw, xYw, Gw, signG, rw, cw, sw):
    """Plain version of the `vrf_verify` kernel (vrf_jax
    vrf_verify_idx_xy_core over packed words): Y's affine x comes from the
    per-key cache.  Returns (N, 130) uint8 per lane: compressed H, U, V,
    [8]Gamma (32 bytes each), then okY (constant 1: the host folds the
    cache mask) and okG."""
    yY = F.limbs_from_words(Yw)
    xY = F.limbs_from_words(xYw)
    yG = F.limbs_from_words(Gw)
    r = F.limbs_from_words(rw)
    idx = _vrf_idx_rows(cw, sw)
    one = F.const(1, yY)
    zero = F.const(0, yY)
    xG, okG = E.device_decompress(yG, signG.reshape(-1))
    H = _double3(elligator2_fraction(r))             # cofactor clearing
    G8 = _double3((xG, yG, one, F.mul(xG, yG)))      # for beta
    nYx = F.sub(zero, xY)
    nGx = F.sub(zero, xG)
    B = E.const_point(_GX, _GY, yY)
    Bp = E.const_point(_G2X, _G2Y, yY)
    Hp = H
    for _ in range(128):
        Hp = E.pt_double(Hp)
    negY = (nYx, yY, one, F.mul(nYx, yY))
    negG = (nGx, yG, one, F.mul(nGx, yG))
    U = _triple_ladder_idx(B, Bp, negY, idx)
    V = _triple_ladder_idx(H, Hp, negG, idx)
    n = yY.shape[1]
    comp = compress(torch.cat([H[0], U[0], V[0], G8[0]], dim=1),
                    torch.cat([H[1], U[1], V[1], G8[1]], dim=1),
                    torch.cat([H[2], U[2], V[2], G8[2]], dim=1))
    rows = torch.cat([comp[:, :n], comp[:, n:2 * n], comp[:, 2 * n:3 * n],
                      comp[:, 3 * n:], torch.ones_like(okG)[None].long(),
                      okG[None].long()])
    return rows.T.to(torch.uint8).contiguous()


def gamma8_words_core(Gw, signG):
    """Plain version of the `gamma8` kernel: [8]Gamma compressed for beta.
    Returns (N, 33) uint8: compressed [8]Gamma + okG."""
    yG = F.limbs_from_words(Gw)
    one = F.const(1, yG)
    xG, okG = E.device_decompress(yG, signG.reshape(-1))
    G8 = _double3((xG, yG, one, F.mul(xG, yG)))
    comp = compress(G8[0], G8[1], G8[2])
    rows = torch.cat([comp, okG[None].long()])
    return rows.T.to(torch.uint8).contiguous()


# challenge preimage prefix bytes (suite || 0x02)
_SUITE2 = tuple(SUITE + b"\x02")


def challenge_ok_device(rows, gamma_bytes, c_bytes):
    """ECVRF challenge verdict from the kernel's (N, 130) rows: c ==
    SHA512(suite || 0x02 || H || Gamma || U || V)[:16], folded with the
    rows' decompression flags.  `gamma_bytes` (N, 32) and `c_bytes`
    (N, 16) uint8 are the proof's bytes 0:32 and 32:48.  (N,) bool."""
    from . import sha512 as S
    n = rows.shape[0]
    prefix = torch.tensor(_SUITE2, dtype=torch.uint8,
                          device=rows.device).expand(n, 2)
    msg = torch.cat([prefix, rows[:, 0:32], gamma_bytes.to(torch.uint8),
                     rows[:, 32:96]], dim=1)
    c_match = S.prefix16_eq(msg, 130, c_bytes)
    return c_match & rows[:, 128].bool() & rows[:, 129].bool()


# ---------------------------------------------------------------------------
# Host prep and finish (numpy; vrf_jax.py:373-564)
# ---------------------------------------------------------------------------

def _prepare_betas_words(proofs):
    """Packed-words host parse of a gamma8 batch: ((Gw, signG), ok)."""
    pf_arr, pf_ok = E._bytes_rows(proofs, PROOF_LEN)
    signG = (pf_arr[:, 31] >> 7).astype(np.int32)
    okGc = E._y_canonical(pf_arr[:, :32])
    s_ok = E._scalar_lt_L(np.ascontiguousarray(pf_arr[:, 48:80]))
    g_clear = pf_arr[:, :32].copy()
    g_clear[:, 31] &= 0x7F
    return ((E.words_from_bytes_rows(g_clear), signG),
            pf_ok & okGc & s_ok)


def _r_rows(vks, alphas) -> np.ndarray:
    """Elligator2 input byte rows: r = SHA512(suite || 0x01 || vk ||
    alpha)[:32] with the top bit masked."""
    rows = bytearray()
    for vk, alpha in zip(vks, alphas):
        rows += hashlib.sha512(SUITE + b"\x01" + vk + alpha).digest()[:32]
    arr = np.frombuffer(bytes(rows), dtype=np.uint8).reshape(len(vks), 32)
    arr = arr.copy()
    arr[:, 31] &= 0x7F
    return arr


def _prepare_words(vks, alphas, proofs):
    """Packed-words host prep.  Returns (kernel_args, parse_ok, gamma_ok,
    s_ok, pf_arr) with kernel_args = (Yw, signY, Gw, signG, rw, cw, sw)."""
    vk_arr, vk_ok = E._bytes_rows(vks, 32)
    pf_arr, pf_ok = E._bytes_rows(proofs, PROOF_LEN)
    signY = (vk_arr[:, 31] >> 7).astype(np.int32)
    signG = (pf_arr[:, 31] >> 7).astype(np.int32)
    okYc = E._y_canonical(vk_arr)
    okGc = E._y_canonical(pf_arr[:, :32])
    s_rows = np.ascontiguousarray(pf_arr[:, 48:80])
    s_ok = E._scalar_lt_L(s_rows)
    gamma_ok = pf_ok & okGc
    parse_ok = vk_ok & okYc & gamma_ok & s_ok
    vk_clear = vk_arr.copy()
    vk_clear[:, 31] &= 0x7F
    g_clear = pf_arr[:, :32].copy()
    g_clear[:, 31] &= 0x7F
    c_rows = np.ascontiguousarray(pf_arr[:, 32:48])
    cw = np.ascontiguousarray(
        c_rows.reshape(-1, 4, 4).view(np.uint32)[:, :, 0].T)
    args = (E.words_from_bytes_rows(vk_clear), signY,
            E.words_from_bytes_rows(g_clear), signG,
            E.words_from_bytes_rows(_r_rows(vks, alphas)), cw,
            E.words_from_bytes_rows(s_rows))
    return args, parse_ok, gamma_ok, s_ok, pf_arr


def _finish(rows, parse_ok, gamma_ok, s_ok, pf_arr, n):
    """Host verdicts and betas from (N, 130) uint8 rows."""
    rows = np.asarray(rows)
    okY = rows[:, 128].astype(bool)
    okG = rows[:, 129].astype(bool)
    oks: list[bool] = []
    betas: list = []
    for j in range(n):
        row = rows[j]
        if gamma_ok[j] and s_ok[j] and okG[j]:
            betas.append(hashlib.sha512(
                SUITE + b"\x03" + row[96:128].tobytes()).digest())
        else:
            betas.append(None)
        if not (parse_ok[j] and okY[j] and okG[j]):
            oks.append(False)
            continue
        c_prime = hashlib.sha512(
            SUITE + b"\x02" + row[0:32].tobytes() + bytes(pf_arr[j, :32])
            + row[32:64].tobytes() + row[64:96].tobytes()).digest()[:16]
        oks.append(c_prime == bytes(pf_arr[j, 32:48]))
    return oks, betas


def _finish_betas(rows: np.ndarray, decode_ok, n: int) -> list:
    ok = rows[:, 32].astype(bool) & decode_ok
    return [hashlib.sha512(SUITE + b"\x03" + rows[j, :32].tobytes()).digest()
            if ok[j] else None
            for j in range(n)]


# ---------------------------------------------------------------------------
# Standalone batch API (vrf_jax.batch_verify_vrf / batch_betas)
# ---------------------------------------------------------------------------

def batch_verify_vrf(vks, alphas, proofs, pad_to: int | None = None,
                     device=None) -> tuple[list, list]:
    """Batched VRF verify through the `vrf_verify` kernel; returns (ok
    list[bool], beta list[bytes | None]), beta[j] whenever proof j decodes
    (vrf_ref.proof_to_hash's totality).  Y's affine x comes from the
    device's shared per-key cache; keys it cannot decompress fail.
    `device`: None for the card (raises without one) or "cpu"."""
    from . import kernels as K                  # kernels imports this module
    dev = device_mod.resolve(device)
    n = len(vks)
    if n == 0:
        return [], []
    m = pad_to if pad_to and pad_to >= n else n
    vks = list(vks) + [b"\x00" * 32] * (m - n)
    alphas = list(alphas) + [b""] * (m - n)
    proofs = list(proofs) + [b"\x00" * PROOF_LEN] * (m - n)
    args, parse_ok, gamma_ok, s_ok, pf_arr = _prepare_words(vks, alphas,
                                                            proofs)
    Yw, _signY, Gw, signG, rw, cw, sw = args
    xa, _x128, _y128, known = shared_cache(dev).assemble(vks)
    rows = K.vrf_verify(*device_mod.stage((Yw, xa, Gw, signG, rw, cw, sw),
                                          dev))
    return _finish(rows.cpu().numpy(), parse_ok & known, gamma_ok, s_ok,
                   pf_arr, n)


def batch_betas(proofs, pad_to: int | None = None, device=None) -> list:
    """Batched proof_to_hash through the `gamma8` kernel: beta bytes per
    proof, None where the proof does not decode.  `device` as in
    `batch_verify_vrf`."""
    from . import kernels as K
    dev = device_mod.resolve(device)
    n = len(proofs)
    if n == 0:
        return []
    m = pad_to if pad_to and pad_to >= n else n
    proofs = list(proofs) + [b"\x00" * PROOF_LEN] * (m - n)
    (Gw, signG), decode_ok = _prepare_betas_words(proofs)
    rows = K.gamma8(*device_mod.stage((Gw, signG), dev))
    return _finish_betas(rows.cpu().numpy(), decode_ok, n)
