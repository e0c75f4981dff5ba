// GF(2^255-19) with limb-parallel products: one field element spread over
// a group of LP_WIDTH threads -- the field core of gamma8.cu, whose
// critical path is one chain of dependent products (a square root, then an
// inversion), so the parallelism has to come from inside each product.
// fe25519.cuh's fe_mul / fe_sq (one thread a product) stay the core of the
// other kernels.
//
// Split: owner slot r = min(s, 4) of thread s of the group holds limbs 2r
// and 2r + 1 (an `fd`), and computes output columns 2r and 2r + 1 of every
// product.  Ten limbs over five owners: every owner starts at an even limb,
// so a limb's parity, and with it fe_mul's doubling of odd x odd terms, is
// the same at every owner.  Slots 5-7 repeat slot 4's work: the group is a
// power of two for the shuffles, and its spare threads cost nothing while
// the card holds about one warp a scheduler.
//
// A product f g gathers f's ten limbs in order (F[m] = f_m) and g's rotated
// by the owner's base (G[m] = g_(m + 2r) mod 10), one shuffle a limb each:
// the rotation is the choice of source thread, so column 2r + c is
// sum_m F[(c - m) mod 10] G[m] with indices fixed at compile time (a
// register array indexed by r would go to local memory).  Term m wraps past
// limb 9 (times 19) iff c < m < 10 - 2r: those are summed apart, H, beside
// the whole column S = lo + hi, and t = S + 18 H = lo + 19 hi.  Integer sums
// are exact in any order, so t is fe_mul's column to the bit (each partial
// sum below 2^58.4, |t| below 2^62.8), and the three carry rounds are
// field.carry_round's, one shuffle a round: a first-round carry reaches 2^38
// and moves as 64 bits, later ones stay below 2^17 and move as 32, and
// every limb after round 1 is computed in 32 bits.  So lp_mul returns
// fe_mul's limbs exactly, on any input fe_mul takes (sums of up to four
// carried elements).
//
// Every thread of a warp must reach every shuffle: kernels built on these
// functions never return early, and lanes past the end run on clamped
// inputs.
#pragma once
#include "fe25519.cuh"

#define LP_WIDTH 8
#define LP_OWNERS 5
#define LP_ALL 0xffffffffu

// limbs 2r and 2r + 1 of a field element, r the thread's owner slot
struct fd {
    int32_t v[2];
};

__device__ __forceinline__ int lp_owner() {
    const int s = threadIdx.x % LP_WIDTH;
    return s < LP_OWNERS ? s : LP_OWNERS - 1;
}

__device__ __forceinline__ fd fd_add(const fd &f, const fd &g) {
    return fd{{f.v[0] + g.v[0], f.v[1] + g.v[1]}};
}

__device__ __forceinline__ fd fd_sub(const fd &f, const fd &g) {
    return fd{{f.v[0] - g.v[0], f.v[1] - g.v[1]}};
}

__device__ __forceinline__ fd fd_sel(bool c, const fd &a, const fd &b) {
    return c ? a : b;
}

__device__ __forceinline__ fd fd_small(int32_t x) {
    return fd{{lp_owner() == 0 ? x : 0, 0}};
}

__device__ __forceinline__ fd fd_load(const int32_t *k) {
    const int r = lp_owner();
    return fd{{k[2 * r], k[2 * r + 1]}};
}

// this thread's share of a whole element every thread of the group holds
__device__ __forceinline__ fd fd_of(const fe &a) {
    const int r = lp_owner();
    fd h{{a.v[0], a.v[1]}};
#pragma unroll
    for (int o = 1; o < LP_OWNERS; o++)
        if (r == o) h = fd{{a.v[2 * o], a.v[2 * o + 1]}};
    return h;
}

// the whole element, in every thread of the group
__device__ __forceinline__ fe fd_gather(const fd &a) {
    fe h;
#pragma unroll
    for (int m = 0; m < 10; m++)
        h.v[m] = __shfl_sync(LP_ALL, a.v[m & 1], m >> 1, LP_WIDTH);
    return h;
}

// h = f * g, limb for limb fe_mul's (inlined into lp_sq_n's loop, where
// most of a chain's products are; lp_mul is the call for the rest)
__device__ __forceinline__ fd lp_mul_i(const fd f, const fd g) {
    const int r = lp_owner();
    int32_t F[10], G[10], GH[10];
#pragma unroll
    for (int m = 0; m < 10; m++) {
        const int q = (m >> 1) + r;
        F[m] = __shfl_sync(LP_ALL, f.v[m & 1], m >> 1, LP_WIDTH);
        G[m] = __shfl_sync(LP_ALL, g.v[m & 1],
                           q < LP_OWNERS ? q : q - LP_OWNERS, LP_WIDTH);
        GH[m] = 2 * r + m < 10 ? G[m] : 0;  // read for m >= 2 only
    }
    int64_t t[2];
#pragma unroll
    for (int c = 0; c < 2; c++) {
        int64_t S = 0, H = 0;
#pragma unroll
        for (int m = 0; m < 10; m++) {
            const int i = (c - m + 10) % 10;
            const int32_t fi = ((i & 1) && (m & 1)) ? 2 * F[i] : F[i];
            S += (int64_t)fi * G[m];
            if (m == 1 && c == 0)
                H += (int64_t)fi * G[m];
            else if (m >= 2)
                H += (int64_t)fi * GH[m];
        }
        t[c] = S + 18 * H;
    }
    // field.carry_round three times: limb 2r takes the carry of limb 2r - 1
    // from the owner before it, limb 0 19 times limb 9's; a residue below
    // 2^26 is the low 32 bits of the difference
    const int src = r == 0 ? LP_OWNERS - 1 : r - 1;
    const int32_t k19 = r == 0 ? 19 : 1;
    // round 1: carries up to 2^38
    const int64_t c0 = (t[0] + (int64_t(1) << 25)) >> 26;
    const int64_t c1 = (t[1] + (int64_t(1) << 24)) >> 25;
    const int32_t l0 = (int32_t)((uint32_t)t[0] - ((uint32_t)c0 << 26));
    const int32_t l1 = (int32_t)((uint32_t)t[1] - ((uint32_t)c1 << 25));
    const int64_t cin = __shfl_sync(LP_ALL, (long long)c1, src, LP_WIDTH);
    const int64_t a0 = l0 + cin * k19, a1 = l1 + c0;
    // round 2: carries below 2^17
    const int32_t d0 = (int32_t)((a0 + (int64_t(1) << 25)) >> 26);
    const int32_t d1 = (int32_t)((a1 + (int64_t(1) << 24)) >> 25);
    const int32_t m0 = (int32_t)((uint32_t)a0 - ((uint32_t)d0 << 26));
    const int32_t m1 = (int32_t)((uint32_t)a1 - ((uint32_t)d1 << 25));
    const int32_t din = __shfl_sync(LP_ALL, d1, src, LP_WIDTH);
    const int32_t b0 = m0 + din * k19, b1 = m1 + d0;
    // round 3
    const int32_t e0 = (b0 + (1 << 25)) >> 26;
    const int32_t e1 = (b1 + (1 << 24)) >> 25;
    const int32_t ein = __shfl_sync(LP_ALL, e1, src, LP_WIDTH);
    return fd{{b0 - e0 * (1 << 26) + ein * k19, b1 - e1 * (1 << 25) + e0}};
}

static __device__ __noinline__ fd lp_mul(const fd f, const fd g) {
    return lp_mul_i(f, g);
}

// h = f^2: fe_sq's columns are fe_mul(f, f)'s, summed the other way
__device__ __forceinline__ fd lp_sq(const fd &f) { return lp_mul(f, f); }

// x^(2^n)
static __device__ __noinline__ fd lp_sq_n(fd x, int n) {
    for (int i = 0; i < n; i++) x = lp_mul_i(x, x);
    return x;
}

// fe_chain250, product for product
__device__ __forceinline__ void lp_chain250(const fd &z, fd &t250, fd &z11,
                                            fd &z2) {
    z2 = lp_sq(z);
    const fd z9 = lp_mul(z, lp_sq_n(z2, 2));
    z11 = lp_mul(z2, z9);
    fd t0 = lp_mul(z9, lp_mul(z11, z11));
    t0 = lp_mul(lp_sq_n(t0, 5), t0);
    fd t1 = lp_mul(lp_sq_n(t0, 10), t0);
    t1 = lp_mul(lp_sq_n(t1, 20), t1);
    t0 = lp_mul(lp_sq_n(t1, 10), t0);
    t1 = lp_mul(lp_sq_n(t0, 50), t0);
    t1 = lp_mul(lp_sq_n(t1, 100), t1);
    t250 = lp_mul(lp_sq_n(t1, 50), t0);
}

// z^((p-5)/8), as fe_pow_p58
__device__ __forceinline__ fd lp_pow_p58(const fd &z) {
    fd t250, z11, z2;
    lp_chain250(z, t250, z11, z2);
    return lp_mul(lp_sq_n(t250, 2), z);
}

// z^(p-2), as fe_inv
__device__ __forceinline__ fd lp_inv(const fd &z) {
    fd t250, z11, z2;
    lp_chain250(z, t250, z11, z2);
    return lp_mul(lp_sq_n(t250, 5), z11);
}
