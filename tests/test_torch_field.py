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
