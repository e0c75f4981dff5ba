"""The port's plain field core (radix 2^25.5, int64 limbs) against Python
ints through the JAX package's `edwards.py`, at edge values and at the
limb bounds its invariants allow; and the CUDA header's constant table
against the same values.  Every comparison is exact.
"""
import os
import re

import numpy as np
import pytest
import torch

from ouroboros_tpu.crypto import edwards as jed
from ouroboros_tpu.crypto import vrf_jax as JV
from ouroboros_tpu_torch.crypto import ed25519 as E
from ouroboros_tpu_torch.crypto import field as F

P = jed.P
# the plain versions run many small ops: one thread per test worker
# avoids oversubscribing the cores the other workers share
torch.set_num_threads(1)
RNG = np.random.default_rng(7)
EDGES = [0, 1, 2, 19, P - 1, P - 2, P - 19, 2**255 - 20, 2**254,
         2**128, 2**26 - 1, 2**51]


def _rand(n):
    return [int.from_bytes(bytes(RNG.integers(0, 256, 32, dtype=np.uint8)),
                           "little") % P for _ in range(n)]


def _words(xs):
    rows = np.frombuffer(b"".join(x.to_bytes(32, "little") for x in xs),
                         np.uint8).reshape(-1, 32)
    return torch.from_numpy(E.words_from_bytes_rows(rows).copy())


def test_mul_sqr_add_sub_match_python_ints():
    xs = EDGES + _rand(20)
    ys = _rand(len(EDGES)) + EDGES + _rand(20 - len(EDGES))
    a, b = F.pack(xs), F.pack(ys)
    assert F.unpack(F.mul(a, b)) == [x * y % P for x, y in zip(xs, ys)]
    assert F.unpack(F.sqr(a)) == [x * x % P for x in xs]
    assert F.unpack(F.canon(F.add(a, b))) == [(x + y) % P
                                              for x, y in zip(xs, ys)]
    assert F.unpack(F.canon(F.sub(a, b))) == [(x - y) % P
                                              for x, y in zip(xs, ys)]


def test_canon_is_canonical_and_is_zero_exact():
    xs = EDGES + _rand(8)
    a = F.pack(xs)
    for h in (a, F.sub(F.const(0, a), a), F.add(a, a)):
        c = F.canon(h)
        assert bool((c >= 0).all())
        for k, w in enumerate(F.WIDTHS):
            assert bool((c[k] < (1 << w)).all())
        assert F.unpack(c) == [F.limbs_to_int(c[:, j].tolist())
                               for j in range(c.shape[1])]
    z = F.sub(a, a)
    assert bool(F.is_zero(z).all())
    assert F.is_zero(a).tolist() == [x == 0 for x in xs]


@pytest.mark.parametrize("x", [P, P + 1, P + 18, 2**255 - 1, 2**255 - 20])
def test_non_canonical_words_reduce(x):
    """Words of values in [p, 2^255) (non-canonical encodings) unpack to
    the value mod p."""
    h = F.limbs_from_words(_words([x]))
    assert F.unpack(F.canon(h)) == [x % P]
    assert F.bytes_from_canon(F.canon(h))[:, 0].tolist() == \
        list((x % P).to_bytes(32, "little"))


def test_mul_at_the_limb_bound_stays_exact():
    """Inputs at the bound mul accepts (sums of four carried elements,
    |limb| <= 2^27 + 2^10) must not overflow int64."""
    bound = (1 << 27) + (1 << 10)
    cols = [[bound] * 10, [-bound] * 10,
            [bound if k % 2 else -bound for k in range(10)]]
    f = torch.tensor(cols, dtype=torch.int64).T.contiguous()
    vals = [F.limbs_to_int(c) for c in cols]
    got = F.unpack(F.mul(f, f.flip(1)))
    assert got == [x * y % P for x, y in zip(vals, vals[::-1])]
    out = F.mul(f, f)
    for k, w in enumerate(F.WIDTHS):
        assert bool((out[k].abs() <= (1 << (w - 1)) + 256).all())


def _fits(x, bits):
    assert -(1 << (bits - 1)) <= x < 1 << (bits - 1), (x, bits)
    return x


def _lp_mul_plan(f, g):
    """csrc/fe25519_lp.cuh's lp_mul_i in Python ints, owner by owner: each
    value the header keeps in 32 bits must fit them, each 64-bit one 64."""
    fits = _fits
    t = {}
    for r in range(5):
        G = [g[(m + 2 * r) % 10] for m in range(10)]
        for c in (0, 1):
            S = H = 0
            for m in range(10):
                i = (c - m) % 10
                fi = fits(2 * f[i] if i & 1 and m & 1 else f[i], 32)
                S += fi * G[m]
                if (m == 1 and c == 0) or (m >= 2 and 2 * r + m < 10):
                    H += fi * G[m]
            t[r, c] = fits(fits(S, 64) + 18 * fits(H, 64), 64)
    out = [0] * 10
    k19 = [19, 1, 1, 1, 1]
    prev = [4, 0, 1, 2, 3]          # the owner a carry comes from
    c0 = {r: (t[r, 0] + (1 << 25)) >> 26 for r in range(5)}
    c1 = {r: (t[r, 1] + (1 << 24)) >> 25 for r in range(5)}
    a0 = {r: fits(t[r, 0] - (c0[r] << 26), 32) + c1[prev[r]] * k19[r]
          for r in range(5)}
    a1 = {r: fits(t[r, 1] - (c1[r] << 25), 32) + c0[r] for r in range(5)}
    d0 = {r: fits((a0[r] + (1 << 25)) >> 26, 32) for r in range(5)}
    d1 = {r: fits((a1[r] + (1 << 24)) >> 25, 32) for r in range(5)}
    b0 = {r: fits(fits(a0[r] - (d0[r] << 26), 32)
                  + d1[prev[r]] * k19[r], 32) for r in range(5)}
    b1 = {r: fits(fits(a1[r] - (d1[r] << 25), 32) + d0[r], 32)
          for r in range(5)}
    for r in range(5):
        e0, e1, ein = ((b0[r] + (1 << 25)) >> 26, (b1[r] + (1 << 24)) >> 25,
                       (b1[prev[r]] + (1 << 24)) >> 25)
        out[2 * r] = fits(b0[r] - (e0 << 26) + ein * k19[r], 32)
        out[2 * r + 1] = fits(b1[r] - (e1 << 25) + e0, 32)
    return out


def test_limb_parallel_product_plan_equals_mul():
    """gamma8's limb-parallel product (five owners of two columns, g
    rotated by the owner's base, wrapped terms summed apart, carries
    narrowed to 32 bits after round 1) gives mul's limbs exactly, at the
    limb bound mul accepts and on random carried and uncarried limbs."""
    bound = (1 << 27) + (1 << 10)
    cols = [[bound] * 10, [-bound] * 10,
            [bound if k % 2 else -bound for k in range(10)]]
    cols += [[int(RNG.choice((-bound, bound))) for _ in range(10)]
             for _ in range(20)]
    cols += RNG.integers(-bound, bound + 1, (40, 10)).tolist()
    cols += F.pack(_rand(40)).T.tolist()
    f = torch.tensor(cols, dtype=torch.int64).T.contiguous()
    g = f.roll(1, dims=1)
    want = torch.cat([F.mul(f, g), F.sqr(f)], dim=1).T.tolist()
    got = [_lp_mul_plan(a, b) for a, b in zip(f.T.tolist(), g.T.tolist())]
    got += [_lp_mul_plan(a, a) for a in f.T.tolist()]
    assert got == want


def _one_thread_product_plan(f, g, square=False):
    """csrc/fe25519.cuh's fe_mul_i (or fe_sq_i) and fe_finish_product in
    Python ints: each value the header keeps in 32 bits must fit them,
    each 64-bit one 64.  Columns start at the rounding offset 2^(W-1);
    round 1's carry is 64 bits and its remainder the low W bits; rounds
    2 and 3 are 32-bit after round 2's 64-bit sum u = v + c."""
    W = F.WIDTHS
    half = [1 << (w - 1) for w in W]
    mask = [(1 << w) - 1 for w in W]
    lo, hi = list(half), [0] * 10
    for i in range(10):
        for j in range(i if square else 0, 10):
            m = 2 if i & 1 and j & 1 else 1
            if square and i != j:
                m *= 2
            p = _fits(m * f[i], 32) * g[j]
            if i + j < 10:
                lo[i + j] = _fits(lo[i + j] + p, 64)
            else:
                hi[i + j - 10] = _fits(hi[i + j - 10] + p, 64)
    s = [_fits(lo[k] + 19 * hi[k], 64) for k in range(10)]
    c = [s[k] >> W[k] for k in range(10)]
    v = [_fits(s[k] & mask[k], 32) for k in range(10)]
    u = [_fits(v[k] + (19 * c[9] if k == 0 else c[k - 1]), 64)
         for k in range(10)]
    d = [_fits(u[k] >> W[k], 32) for k in range(10)]
    w = [_fits(u[k] & mask[k], 32) for k in range(10)]
    x = [_fits(w[k] + (_fits(19 * d[9], 32) if k == 0 else d[k - 1]), 32)
         for k in range(10)]
    e = [x[k] >> W[k] for k in range(10)]
    y = [x[k] & mask[k] for k in range(10)]
    return [_fits(y[k] - half[k] + (_fits(19 * e[9], 32) if k == 0
                                     else e[k - 1]), 32) for k in range(10)]


def test_one_thread_product_plan_equals_mul_and_sqr():
    """fe_mul / fe_sq's narrow carry plan (round 1's carry in 64 bits and
    its remainder from the low word, rounds 2-3 in 32 bits) gives mul's
    and sqr's limbs exactly, at the limb bound they accept (sums of four
    carried elements, |limb| <= 2^27 + 2^10) and on random carried and
    uncarried limbs."""
    bound = (1 << 27) + (1 << 10)
    cols = [[bound] * 10, [-bound] * 10,
            [bound if k % 2 else -bound for k in range(10)]]
    cols += [[int(RNG.choice((-bound, bound))) for _ in range(10)]
             for _ in range(20)]
    cols += RNG.integers(-bound, bound + 1, (40, 10)).tolist()
    cols += F.pack(_rand(40)).T.tolist()
    f = torch.tensor(cols, dtype=torch.int64).T.contiguous()
    g = f.roll(1, dims=1)
    want = torch.cat([F.mul(f, g), F.sqr(f)], dim=1).T.tolist()
    got = [_one_thread_product_plan(a, b)
           for a, b in zip(f.T.tolist(), g.T.tolist())]
    got += [_one_thread_product_plan(a, a, square=True)
            for a in f.T.tolist()]
    assert got == want


def test_one_thread_carry_round_in_32_bits_equals_carry_round():
    """fe_carry's 32-bit round (carry = f >> W plus bit W-1 of f, the
    remainder wrapped to 32 bits) is field.carry_round on any int32
    limbs, the extremes included."""
    cols = [[-(1 << 31)] * 10, [(1 << 31) - 1] * 10,
            [(1 << 31) - 1 if k % 2 else -(1 << 31) for k in range(10)]]
    cols += RNG.integers(-(1 << 31), 1 << 31, (60, 10)).tolist()
    cols += F.pack(_rand(20)).T.tolist()
    want = F.carry_round(torch.tensor(cols, dtype=torch.int64).T).T.tolist()
    got = []
    for f in cols:
        c = [_fits((v >> w) + ((v >> (w - 1)) & 1), 32)
             for v, w in zip(f, F.WIDTHS)]
        r = [(v - (ci << w)) & 0xFFFFFFFF for v, ci, w in zip(f, c, F.WIDTHS)]
        r = [_fits(x - (1 << 32) if x >> 31 else x, 32) for x in r]
        got.append([_fits(r[0] + 19 * c[9], 32)]
                   + [_fits(r[k] + c[k - 1], 32) for k in range(1, 10)])
    assert got == want


def test_pow_chains_match_python_ints():
    xs = [0, 1, P - 1, 2, 9] + _rand(6)
    a = F.pack(xs)
    assert F.unpack(F.pow_inv(a)) == [pow(x, P - 2, P) for x in xs]
    assert F.unpack(F.pow_p58(a)) == [pow(x, (P - 5) // 8, P) for x in xs]
    assert F.unpack(F.pow_chi(a)) == [pow(x, (P - 1) // 2, P) for x in xs]


def test_words_limbs_bytes_roundtrip():
    xs = EDGES + _rand(10)
    h = F.limbs_from_words(_words(xs))
    assert F.unpack(h) == [x % P for x in xs]
    b = F.bytes_from_canon(F.canon(h)).T.to(torch.uint8).numpy()
    assert [bytes(r) for r in b] == [(x % P).to_bytes(32, "little")
                                     for x in xs]
    for j in (0, 1, 100, 254, 255):
        got = F.bit_from_words(_words(xs), j).tolist()
        assert got == [(x >> j) & 1 for x in xs]


def test_cuda_header_constants_match_the_curve():
    """Every FE_CONST in csrc/fe25519.cuh is the carried-limb form of the
    value its name says, from the JAX package's edwards.py."""
    path = os.path.join(os.path.dirname(F.__file__), os.pardir, "csrc",
                        "fe25519.cuh")
    text = open(path).read()
    table = {m.group(1): [int(v) for v in m.group(2).split(",")]
             for m in re.finditer(r"FE_CONST\((K_\w+),([^;]*)\);", text)}
    D = jed.D
    want = {"K_D": D, "K_D2": 2 * D % P, "K_SQRTM1": jed.SQRT_M1,
            "K_ELL_A": jed.A24, "K_YW0": JV._Y_W0}
    pts = [jed.to_affine(jed.BASE),
           jed.to_affine(jed.scalar_mult(1 << 128, jed.BASE)),
           jed.to_affine(jed.scalar_mult((1 << 128) + 1, jed.BASE))]
    smalls = [jed.to_affine(jed.scalar_mult(k, jed.BASE)) for k in (2, 3)]
    named = [(f"K_S{c}", pt) for c, pt in enumerate(pts, 1)] + \
        [(f"K_B{k}", pt) for k, pt in zip((2, 3), smalls)]
    for stem, (x, y) in named:
        want.update({f"{stem}_X": x, f"{stem}_Y": y, f"{stem}_XY": x * y % P,
                     f"{stem}_YMX": (y - x) % P, f"{stem}_YPX": (y + x) % P,
                     f"{stem}_T2D": 2 * D * x * y % P})
    assert set(table) == set(want)
    for name, value in want.items():
        assert table[name] == F.balanced_limbs(value), name
        assert F.limbs_to_int(table[name]) == value % P, name
