"""GF(2^255-19) on batched int64 limb tensors — the port's plain field core.

Ported from `ouroboros_tpu/crypto/field_jax.py` (plus the pow chains of
`ed25519_jax.py:410-449`), with another radix.  The TPU form is radix
2^13 x 20 int32 limbs, because the TPU's lanes have no 64-bit product.
Here a field element batch is a (10, N) int64 tensor in ref10's radix
2^25.5: limb k weighs 2^OFFSETS[k], even limbs hold 26 bits and odd limbs
25.  The CUDA kernels (../csrc/fe25519.cuh) use the same limbs as int32
with 32x32->64 products, and the same carry schedule, so a kernel and
this module agree limb for limb.

Invariants (every op keeps them; int64 never overflows):
- a "carried" element has |limb k| <= 2^(WIDTHS[k]-1) + 2^8.  `mul` and
  `sqr` return carried elements, and every input below is carried after
  `limbs_from_words` or `const`.
- `mul`/`sqr` accept sums and differences of up to four carried
  elements (|limb| <= 2^27 + 2^10): each of the ten terms of an output
  limb is at most 2 * 19 * (2^27 + 2^10)^2, so a limb sum stays below
  2^62.6.  `add`/`sub` therefore do not carry.
- `canon` returns the canonical digits of the value mod p.

Bit-exactness oracle: `edwards.py` (Python ints).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

P = 2**255 - 19
NLIMBS = 10
WIDTHS = (26, 25, 26, 25, 26, 25, 26, 25, 26, 25)
OFFSETS = (0, 26, 51, 77, 102, 128, 153, 179, 204, 230)

# calls to mul/sqr weighted by lanes: the field-product count of a run
# (divided by its lane count it gives the per-lane work that bounds the
# CUDA kernels' time — see kernels.py)
COUNTS = {"mul": 0, "sqr": 0}


def balanced_limbs(x: int) -> list[int]:
    """x mod p as carried limbs: digit k in [-2^(w-1), 2^(w-1)), carries
    moved up (the top carry re-enters limb 0 times 19).  Constants use
    this form in both this module and the CUDA header."""
    x %= P
    d = [(x >> o) & ((1 << w) - 1) for o, w in zip(OFFSETS, WIDTHS)]
    for k in range(NLIMBS):
        w = WIDTHS[k]
        if d[k] >= 1 << (w - 1):
            d[k] -= 1 << w
            if k + 1 < NLIMBS:
                d[k + 1] += 1
            else:
                d[0] += 19
    return d


def limbs_to_int(limbs) -> int:
    """Value mod p of one lane's limbs (any carried or uncarried form)."""
    return sum(int(v) << o for v, o in zip(limbs, OFFSETS)) % P


def pack(ints, device="cpu") -> torch.Tensor:
    """List of N field ints -> (10, N) carried limbs."""
    cols = [balanced_limbs(x) for x in ints]
    return torch.tensor(cols, dtype=torch.int64, device=device).T.contiguous()


def unpack(h: torch.Tensor) -> list[int]:
    """(10, N) limbs -> N ints mod p."""
    rows = h.cpu().tolist()
    return [limbs_to_int([rows[k][j] for k in range(NLIMBS)])
            for j in range(h.shape[1])]


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> dict:
    i64 = dict(dtype=torch.int64, device=device)
    width = torch.tensor(WIDTHS, **i64)[:, None]
    # product terms f_i * g_j land in limb (i + j) mod 10; weight
    # 2^(OFF_i + OFF_j) = 2^OFF_(i+j) times 2 when i and j are both odd,
    # times 19 when i + j >= 10 (2^255 = 19 mod p)
    idx_i = [[0] * NLIMBS for _ in range(NLIMBS)]
    idx_j = [[0] * NLIMBS for _ in range(NLIMBS)]
    coef = [[0] * NLIMBS for _ in range(NLIMBS)]
    for k in range(NLIMBS):
        for i in range(NLIMBS):
            j = (k - i) % NLIMBS
            idx_i[k][i], idx_j[k][i] = i, j
            coef[k][i] = ((2 if (i & 1) and (j & 1) else 1)
                          * (19 if i + j >= NLIMBS else 1))
    return {
        "width": width,
        "half": 1 << (width - 1),
        "radix": 1 << width,
        "idx_i": torch.tensor(idx_i, **i64),
        "idx_j": torch.tensor(idx_j, **i64),
        "coef": torch.tensor(coef, **i64)[:, :, None],
        "p": torch.tensor([(P >> o) & ((1 << w) - 1)
                           for o, w in zip(OFFSETS, WIDTHS)], **i64)[:, None],
    }


def const(x: int, like: torch.Tensor) -> torch.Tensor:
    """(10, N) broadcast constant with `like`'s lane count and device."""
    col = torch.tensor(balanced_limbs(x), dtype=torch.int64,
                       device=like.device)[:, None]
    return col.expand(NLIMBS, like.shape[-1])


def carry_round(h: torch.Tensor) -> torch.Tensor:
    """One parallel carry round: limb k keeps its low WIDTHS[k] bits,
    rounded to [-2^(w-1), 2^(w-1)), and passes the rest up; limb 9's carry
    re-enters limb 0 times 19."""
    c = _consts(h.device)
    carry = (h + c["half"]) >> c["width"]
    h = h - carry * c["radix"]
    return h + torch.cat([carry[NLIMBS - 1:] * 19, carry[:NLIMBS - 1]])


def _product(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    c = _consts(f.device)
    h = (f[c["idx_i"]] * g[c["idx_j"]] * c["coef"]).sum(dim=1)
    # three rounds bring |limb| < 2^62.6 back to the carried bound
    return carry_round(carry_round(carry_round(h)))


def mul(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    COUNTS["mul"] += f.shape[-1]
    return _product(f, g)


def sqr(f: torch.Tensor) -> torch.Tensor:
    COUNTS["sqr"] += f.shape[-1]
    return _product(f, f)


def add(a, b):
    return a + b


def sub(a, b):
    return a - b


def _seq_carry(rows: list) -> list:
    """Exact floor carry from limb 0 up to limb 9; limb 9 keeps its
    excess (rows are (N,) tensors; the pass mutates the list)."""
    for k in range(NLIMBS - 1):
        w = WIDTHS[k]
        c = rows[k] >> w
        rows[k] = rows[k] & ((1 << w) - 1)
        rows[k + 1] = rows[k + 1] + c
    return rows


def canon(h: torch.Tensor) -> torch.Tensor:
    """Canonical digits (limb k in [0, 2^WIDTHS[k])) of the value mod p.

    Accepts sums of up to eight carried elements: one carry round brings
    |value| below p, adding p makes it positive and below 2p, and one
    conditional subtraction of p (v >= p iff v + 19 reaches bit 255)
    finishes."""
    h = carry_round(h) + _consts(h.device)["p"]
    d = _seq_carry(list(h.unbind(0)))
    t = list(d)
    t[0] = t[0] + 19
    t = _seq_carry(t)
    top = t[NLIMBS - 1] >> 25
    t[NLIMBS - 1] = t[NLIMBS - 1] & ((1 << 25) - 1)
    return torch.where(top.bool(), torch.stack(t), torch.stack(d))


def is_zero(h: torch.Tensor) -> torch.Tensor:
    """(N,) bool: value(h) = 0 mod p."""
    return (canon(h) == 0).all(dim=0)


def parity(canonical: torch.Tensor) -> torch.Tensor:
    """(N,) int64 low bit of canonical digits."""
    return canonical[0] & 1


# -- packed I/O: 256-bit values travel as (8, N) little-endian uint32 words
#    (field_jax.words_from_bytes_rows / limbs_from_words contract)

def limbs_from_words(w: torch.Tensor) -> torch.Tensor:
    """(8, N) uint32 words -> (10, N) carried limbs.  Bit 255 must be
    clear (every caller clears the sign bit or masks it first)."""
    w = w.to(torch.int64) & 0xFFFFFFFF
    rows = []
    for o, wd in zip(OFFSETS, WIDTHS):
        i, s = divmod(o, 32)
        v = w[i] >> s
        if s + wd > 32:
            v = v | (w[i + 1] << (32 - s))
        rows.append(v & ((1 << wd) - 1))
    return carry_round(torch.stack(rows))


def limbs_from_radix13(r: np.ndarray) -> torch.Tensor:
    """(20, N) int32 limbs of the JAX package's field (radix 2^13: limb i
    weighs 2^(13 i), so digits in [0, 2^13) stand for a value below
    2^260) -> (10, N) carried limbs of the same value mod p.

    It converts by value: digit i lands at bit 13 i of the port limb that
    holds that bit, and three carry rounds bring the sums (below 2^59)
    to the carried bound.  Port and JAX limbs agree only on the value."""
    r = torch.from_numpy(np.asarray(r, dtype=np.int64))
    rows = [torch.zeros_like(r[0]) for _ in range(NLIMBS)]
    for i in range(r.shape[0]):
        bit = 13 * i
        k = max(j for j in range(NLIMBS) if OFFSETS[j] <= bit)
        rows[k] = rows[k] + (r[i] << (bit - OFFSETS[k]))
    return carry_round(carry_round(carry_round(torch.stack(rows))))


def bytes_from_canon(c: torch.Tensor) -> torch.Tensor:
    """(10, N) canonical digits -> (32, N) int64 little-endian byte values
    (a byte spans at most two limbs)."""
    rows = []
    for b in range(32):
        bit = 8 * b
        k = max(i for i in range(NLIMBS) if OFFSETS[i] <= bit)
        v = c[k] >> (bit - OFFSETS[k])
        if bit + 8 > OFFSETS[k] + WIDTHS[k] and k + 1 < NLIMBS:
            v = v | (c[k + 1] << (OFFSETS[k + 1] - bit))
        rows.append(v & 0xFF)
    return torch.stack(rows)


def bit_from_words(w: torch.Tensor, j: int) -> torch.Tensor:
    """Bit j (0 = LSB) of each lane's 256-bit value: (N,) int64."""
    return (w[j // 32].to(torch.int64) >> (j % 32)) & 1


# -- pow chains (ed25519_jax._chain250 / pow_p58 / pow_inv / pow_chi)

def _sq_n(x, n):
    for _ in range(n):
        x = sqr(x)
    return x


def _chain250(z):
    """Shared ref10 ladder prefix: returns (z^(2^250-1), z^11, z^2)."""
    z2 = sqr(z)                         # 2
    z9 = mul(z, _sq_n(z2, 2))           # 9
    z11 = mul(z2, z9)                   # 11
    t0 = mul(z9, mul(z11, z11))         # 31 = 2^5 - 1
    t0 = mul(_sq_n(t0, 5), t0)          # 2^10 - 1
    t1 = mul(_sq_n(t0, 10), t0)         # 2^20 - 1
    t1 = mul(_sq_n(t1, 20), t1)         # 2^40 - 1
    t0 = mul(_sq_n(t1, 10), t0)         # 2^50 - 1
    t1 = mul(_sq_n(t0, 50), t0)         # 2^100 - 1
    t1 = mul(_sq_n(t1, 100), t1)        # 2^200 - 1
    t0 = mul(_sq_n(t1, 50), t0)         # 2^250 - 1
    return t0, z11, z2


def pow_p58(z):
    """z^((p-5)/8) = z^(2^252 - 3)."""
    t250, _z11, _z2 = _chain250(z)
    return mul(_sq_n(t250, 2), z)


def pow_inv(z):
    """z^(p-2): batched inversion, inv(0) = 0 (edwards.inv semantics)."""
    t250, z11, _z2 = _chain250(z)
    return mul(_sq_n(t250, 5), z11)


def pow_chi(z):
    """z^((p-1)/2): Legendre symbol (1 / p-1 / 0)."""
    t250, _z11, z2 = _chain250(z)
    z4 = mul(z2, z2)
    z6 = mul(z4, z2)
    return mul(_sq_n(t250, 4), z6)


# -- the per-operation probe (experiments/microbench_field.py:160) ----------

# the `field_chain` kernel's operations, in the order of its `op` argument
FIELD_OPS = ("mul", "sqr", "add", "carry")
# those of `field_chain_lp` (the limb-parallel product): mul and sqr, at
# the same indices
FIELD_LP_OPS = FIELD_OPS[:2]


def field_chain_core(a: torch.Tensor, b: torch.Tensor, op: str,
                     k: int) -> torch.Tensor:
    """Plain version of the `field_chain` kernel: a <- op(a, b), k times.
    (10, N) carried limbs (any integer type) -> (10, N) int32.

    mul is `mul(a, b)` and sqr `sqr(a)` (the JAX chain's mul(a, a): the
    same value, by the squaring the port's kernels run); add is
    `carry_round(add(a, b))`, because the JAX field's add carries and this
    one does not (192 uncarried adds would leave int32); carry is
    `carry_round(a)`."""
    if op not in FIELD_OPS:
        raise ValueError(f"field op {op!r} is not one of {FIELD_OPS}")
    a, b = a.to(torch.int64), b.to(torch.int64)
    for _ in range(k):
        if op == "mul":
            a = mul(a, b)
        elif op == "sqr":
            a = sqr(a)
        elif op == "add":
            a = carry_round(add(a, b))
        else:
            a = carry_round(a)
    return a.to(torch.int32)
