"""Deterministic fixed-point exp/ln — the leader-threshold arithmetic.

Reference seam: `checkLeaderValue` (ouroboros-consensus-shelley/src/
Ouroboros/Consensus/Shelley/Protocol.hs:472-491) delegates to the ledger's
`NonIntegral` fixed-point exp/ln so that the Praos leader check

    certNat/2^512  <  1 - (1-f)^sigma

is evaluated *identically on every node* — floating point would be a
consensus hazard.  Same design here: 34-decimal-digit fixed point over
Python ints (the reference's FixedPoint precision), ln via the artanh
series, exp via range-reduced Taylor, all loops terminating on exact
fixed-point zero so results are platform-independent.

Ported from `ouroboros_tpu/eras/nonintegral.py` (the port imports nothing
of the JAX package). Copied whole.
"""
from __future__ import annotations

from fractions import Fraction
from functools import lru_cache

DIGITS = 34
SCALE = 10 ** DIGITS
ONE = SCALE


def _tdiv(a: int, b: int) -> int:
    """Divide truncating toward zero — mandatory for series convergence:
    floor division leaves negative terms stuck at -1 forever."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def from_fraction(x: Fraction) -> int:
    """Fraction -> fixed point (truncated)."""
    return _tdiv(x.numerator * SCALE, x.denominator)


def fp_mul(a: int, b: int) -> int:
    return _tdiv(a * b, SCALE)


def fp_div(a: int, b: int) -> int:
    return _tdiv(a * SCALE, b)


def fp_ln(x: int) -> int:
    """ln(x) for x > 0 in fixed point.

    ln(x) = 2·artanh(z), z = (x-1)/(x+1); the series z + z^3/3 + z^5/5 + ...
    converges for every positive x and terminates when a term underflows
    the fixed-point grid.
    """
    if x <= 0:
        raise ValueError("fp_ln: non-positive argument")
    z = fp_div(x - ONE, x + ONE)
    z2 = fp_mul(z, z)
    term = z
    total = 0
    k = 1
    while term != 0:
        total += _tdiv(term, k)
        term = fp_mul(term, z2)
        k += 2
    return 2 * total


def fp_exp(x: int) -> int:
    """e^x in fixed point via Taylor with range reduction.

    |x| is halved until < 1 so the series converges in few exactly-computed
    terms, then the result is squared back up.
    """
    halvings = 0
    while abs(x) > ONE:
        x = _tdiv(x, 2)
        halvings += 1
    total, term, k = ONE, ONE, 1
    while term != 0:
        term = _tdiv(fp_mul(term, x), k)
        total += term
        k += 1
    for _ in range(halvings):
        total = fp_mul(total, total)
    return total


@lru_cache(maxsize=1024)
def _leader_threshold(sigma: Fraction, f: Fraction) -> int:
    """exp(-sigma·ln(1-f)) in fixed point — depends only on the pool's
    relative stake and the active-slot coefficient, which are constant for
    a whole epoch, so the expensive series arithmetic runs once per
    (pool, epoch) instead of once per header (it was ~half the replay's
    host pass)."""
    return fp_exp(-fp_mul(from_fraction(sigma), fp_ln(from_fraction(1 - f))))


def check_leader_value(cert_nat: int, cert_bits: int,
                       sigma: Fraction, f: Fraction) -> bool:
    """Praos leader check: cert_nat/2^cert_bits < 1 - (1-f)^sigma.

    Evaluated as  1/q < exp(-sigma·ln(1-f))  with q = 1 - p, exactly the
    form of the reference's `checkLeaderValue` (Protocol.hs:472-491).
    sigma is the pool's relative stake; f the active-slot coefficient.
    """
    if sigma == 0:
        return False
    # q = 1 - cert_nat/2^bits in fixed point, truncated — identical to
    # from_fraction(1 - Fraction(cert_nat, 2^bits)) without Fraction gcds
    q_fp = _tdiv(((1 << cert_bits) - cert_nat) * SCALE, 1 << cert_bits)
    if q_fp <= 0:        # q underflows the fixed-point grid: never a leader
        return False
    lhs = fp_div(ONE, q_fp)                  # 1/q
    return lhs < _leader_threshold(sigma, f)
