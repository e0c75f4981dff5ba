// Edwards25519 point ops over four threads a point, one thread a
// coordinate: the multi-thread core of ed25519_split.cu and vrf_verify.cu.
//
// A point's four threads are an aligned group of four lanes of the warp;
// slot t (0..3) holds coordinate t of the extended point (X, Y, Z, T).
// A doubling, a cached addition and an addition (ed25519.pt_double,
// pt_add_cached, pt_add; ge25519.cuh's ge_dbl and ge_add) are each two
// rounds of four independent field products with additions between (the
// addition has one more product, C = TT 2d, between its rounds).  In a
// round slot t computes the t-th product, picking its operands with fe_sel
// so that one fe_mul / fe_sq call serves all four slots; the four results
// are exchanged with __shfl_sync of width 4, and every slot forms the next
// round's operands from all four with the same additions as the plain
// version.  Round 2 leaves coordinate t of the result in slot t, so no
// exchange closes an op: the next op gathers what it needs (X and Y)
// first.  Every field operation is the plain version's on the same
// operands: only the thread that computes it changes, so the results stay
// bit-exact, garbage lanes included.
//
// The three point ops are calls (__noinline__) with their products inline
// (fe_mul_i / fe_sq_i): one call a point op, where a call a product moved
// twenty limbs through the call ABI two or three times an op: 4.6-6.7 %
// off ed25519_split, ed25519_verify and vrf_verify on the H100.  Inlining
// the products into every call site instead took ed25519_split and
// ed25519_verify to 255 registers with 100 and 88 bytes of spill, for
// 2 % at most (csrc_compare, PERF.md).
//
// A cached point (ymx, ypx, z2, t2d) is held one column a slot too, in the
// order of pt_add_cached's round-1 products: slot 0 ymx (times Y - X),
// slot 1 ypx (times Y + X), slot 2 z2 (times Z, slot 2's own coordinate),
// slot 3 t2d (times T, slot 3's own).  A table of them lies in shared
// memory as [entry][limb][thread of the block]: each thread reads back only
// its own column, so a warp's lookups hit 32 banks whatever the digits.
//
// Every thread of a warp must reach every shuffle: kernels built on these
// ops never return early, and lanes past the end run on clamped inputs.
#pragma once
#include "ge25519.cuh"

// threads a block of the multi-thread kernels: small, so that 2048 and
// 4096 lanes spread over all 132 SMs
#define X4_BLOCK 64
#define X4_ALL 0xffffffffu

// slot t's one of (a0, a1, a2, a3), t in 0..3
__device__ __forceinline__ fe fe_pick4(int t, const fe &a0, const fe &a1,
                                       const fe &a2, const fe &a3) {
    return fe_sel(t < 2, fe_sel(t == 0, a0, a1), fe_sel(t == 2, a2, a3));
}

// a as held by lane `src` of this thread's aligned group of `width` lanes
__device__ __forceinline__ fe fe_shfl(const fe &a, int src, int width) {
    fe h;
#pragma unroll
    for (int k = 0; k < 10; k++)
        h.v[k] = __shfl_sync(X4_ALL, a.v[k], src, width);
    return h;
}

// round 2 of all three formulas: (E F, G H, F G, E H) -> coordinate t
__device__ __forceinline__ fe ge_round2_x4(int t, const fe &E, const fe &F,
                                           const fe &G, const fe &H) {
    return fe_mul_i(fe_pick4(t, E, G, F, E), fe_pick4(t, F, H, G, H));
}

// ge_dbl: coordinate t of p -> coordinate t of 2p
static __device__ __noinline__ fe ge_dbl_x4(int t, const fe c) {
    const fe X = fe_shfl(c, 0, 4), Y = fe_shfl(c, 1, 4);
    // round 1: X^2, Y^2, Z^2, (X + Y)^2
    const fe r = fe_sq_i(fe_sel(t == 3, fe_add(X, Y), c));
    const fe A = fe_shfl(r, 0, 4), B = fe_shfl(r, 1, 4);
    const fe ZZ = fe_shfl(r, 2, 4), XY2 = fe_shfl(r, 3, 4);
    const fe C = fe_add(ZZ, ZZ);
    const fe H = fe_add(A, B);
    const fe E = fe_sub(H, XY2);
    const fe G = fe_sub(A, B);
    const fe F = fe_add(C, G);
    return ge_round2_x4(t, E, F, G, H);
}

// pt_add_cached: coordinate t of p, column t of q -> coordinate t of p + q
static __device__ __noinline__ fe ge_add_cached_x4(int t, const fe c,
                                                  const fe q) {
    const fe X = fe_shfl(c, 0, 4), Y = fe_shfl(c, 1, 4);
    // round 1: (Y - X) ymx, (Y + X) ypx, Z z2, T t2d
    const fe r = fe_mul_i(fe_pick4(t, fe_sub(Y, X), fe_add(Y, X), c, c), q);
    const fe A = fe_shfl(r, 0, 4), B = fe_shfl(r, 1, 4);
    const fe D = fe_shfl(r, 2, 4), C = fe_shfl(r, 3, 4);
    return ge_round2_x4(t, fe_sub(B, A), fe_sub(D, C), fe_add(D, C),
                        fe_add(B, A));
}

// ge_add: coordinate t of p and of q -> coordinate t of p + q
static __device__ __noinline__ fe ge_add_x4(int t, const fe c, const fe d) {
    const fe X1 = fe_shfl(c, 0, 4), Y1 = fe_shfl(c, 1, 4);
    const fe X2 = fe_shfl(d, 0, 4), Y2 = fe_shfl(d, 1, 4);
    // round 1: (Y1 - X1)(Y2 - X2), (Y1 + X1)(Y2 + X2), Z1 Z2, T1 T2
    const fe r = fe_mul_i(fe_pick4(t, fe_sub(Y1, X1), fe_add(Y1, X1), c, c),
                          fe_pick4(t, fe_sub(Y2, X2), fe_add(Y2, X2), d, d));
    const fe A = fe_shfl(r, 0, 4), B = fe_shfl(r, 1, 4);
    const fe ZZ = fe_shfl(r, 2, 4), TT = fe_shfl(r, 3, 4);
    const fe C = fe_mul_i(TT, fe_load(K_D2));
    const fe D = fe_add(ZZ, ZZ);
    return ge_round2_x4(t, fe_sub(B, A), fe_sub(D, C), fe_add(D, C),
                        fe_add(B, A));
}

// to_cached: coordinate t of q -> column t of its cached form
__device__ __forceinline__ fe ge_cached_x4(int t, const fe &c) {
    const fe X = fe_shfl(c, 0, 4), Y = fe_shfl(c, 1, 4);
    return fe_pick4(t, fe_sub(Y, X), fe_add(Y, X), fe_add(c, c),
                    fe_mul(c, fe_load(K_D2)));
}

// coordinate t of the identity (0, 1, 1, 0) and of an affine constant
// (x, y, 1, xy); column t of the cached identity (1, 1, 2, 0) and of a
// cached constant (y - x, y + x, 2, 2dxy)
__device__ __forceinline__ fe ge_identity_x4(int t) {
    return fe_pick4(t, fe_small(0), fe_small(1), fe_small(1), fe_small(0));
}

__device__ __forceinline__ fe ge_const_x4(int t, const ge_const_pt &k) {
    return fe_pick4(t, fe_load(k.x), fe_load(k.y), fe_small(1),
                    fe_load(k.xy));
}

__device__ __forceinline__ fe gc_identity_x4(int t) {
    return fe_pick4(t, fe_small(1), fe_small(1), fe_small(2), fe_small(0));
}

__device__ __forceinline__ fe gc_const_x4(int t, const ge_const_pt &k) {
    return fe_pick4(t, fe_load(k.ymx), fe_load(k.ypx), fe_small(2),
                    fe_load(k.t2d));
}

// entry e of a shared-memory table of cached columns
__device__ __forceinline__ void gc_put_x4(int32_t *tab, int e, const fe &q) {
#pragma unroll
    for (int k = 0; k < 10; k++)
        tab[(e * 10 + k) * X4_BLOCK + threadIdx.x] = q.v[k];
}

__device__ __forceinline__ fe gc_get_x4(const int32_t *tab, int e) {
    fe q;
#pragma unroll
    for (int k = 0; k < 10; k++)
        q.v[k] = tab[(e * 10 + k) * X4_BLOCK + threadIdx.x];
    return q;
}

// the 16-entry cached table of both Ed25519 ladders (ed25519.split_table_16
// / joint_table_16), slot t's column of each entry: T[c + 4v] = C[c] +
// V[v], var[1..3] the variable half (coordinate t), cst[1..3] the constant
// half, C[0] and V[0] the identity
__device__ __forceinline__ void gc_table16_x4(int32_t *tab, int t,
                                              const fe var[4],
                                              const ge_const_pt cst[4]) {
#pragma unroll
    for (int v = 0; v < 4; v++) {
#pragma unroll
        for (int c = 0; c < 4; c++) {
            if (v == 0 && c == 0)
                gc_put_x4(tab, 0, gc_identity_x4(t));
            else if (v == 0)
                gc_put_x4(tab, c, gc_const_x4(t, cst[c]));
            else if (c == 0)
                gc_put_x4(tab, 4 * v, ge_cached_x4(t, var[v]));
            else
                gc_put_x4(tab, c + 4 * v,
                          ge_cached_x4(t, ge_add_x4(t, var[v],
                                                    ge_const_x4(t, cst[c]))));
        }
    }
}
