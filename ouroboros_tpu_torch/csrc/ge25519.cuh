// Edwards25519 point ops for one lane per thread: decompress, double,
// add, compress.  Every formula is the one of the plain PyTorch version
// (ouroboros_tpu_torch/crypto/ed25519.py and vrf.py, which mirror
// ouroboros_tpu/crypto/ed25519_jax.py), field op for field op, so lanes
// holding off-curve garbage give the same bytes too.
#pragma once
#include "fe25519.cuh"

// extended coordinates: x = X/Z, y = Y/Z, xy = T/Z
struct ge {
    fe X, Y, Z, T;
};

// an affine constant point in both forms a table needs: x, y, xy and the
// cached (y-x, y+x, 2dxy); GE_CONST_PT(K_S1) names the K_S1_* constants
struct ge_const_pt {
    const int32_t *x, *y, *xy, *ymx, *ypx, *t2d;
};
#define GE_CONST_PT(stem)                                                   \
    ge_const_pt { stem##_X, stem##_Y, stem##_XY, stem##_YMX, stem##_YPX,    \
                  stem##_T2D }

// ed25519.pt_add.  Its products are calls: inline, the nine of them took
// point_chain to 255 registers and its addition to 1.3x the time of the
// calls on the H100 (csrc_compare, PERF.md).
__device__ __forceinline__ ge ge_add(const ge &p, const ge &q) {
    const fe A = fe_mul(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X));
    const fe B = fe_mul(fe_add(p.Y, p.X), fe_add(q.Y, q.X));
    const fe TT = fe_mul(p.T, q.T);
    const fe ZZ = fe_mul(p.Z, q.Z);
    const fe C = fe_mul(TT, fe_load(K_D2));
    const fe D = fe_add(ZZ, ZZ);
    const fe E = fe_sub(B, A), F = fe_sub(D, C), G = fe_add(D, C),
             H = fe_add(B, A);
    return ge{fe_mul(E, F), fe_mul(G, H), fe_mul(F, G), fe_mul(E, H)};
}

// ed25519.pt_double.  Its products are inline, so that nvcc interleaves
// the four squares and the four products (a lone warp on an SM waits out
// part of each product's latency otherwise): 0.87x the time of product
// calls at one warp an SM, 0.93x at sixteen, at 168 registers.
__device__ __forceinline__ ge ge_dbl(const ge &p) {
    const fe A = fe_sq_i(p.X);
    const fe B = fe_sq_i(p.Y);
    const fe ZZ = fe_sq_i(p.Z);
    const fe XY2 = fe_sq_i(fe_add(p.X, p.Y));
    const fe C = fe_add(ZZ, ZZ);
    const fe H = fe_add(A, B);
    const fe E = fe_sub(H, XY2);
    const fe G = fe_sub(A, B);
    const fe F = fe_add(C, G);
    return ge{fe_mul_i(E, F), fe_mul_i(G, H), fe_mul_i(F, G),
              fe_mul_i(E, H)};
}

// ed25519.device_decompress (RFC 8032 §5.1.3): x with the requested
// parity for canonical y; ok false where no root exists or x == 0 with
// sign 1
__device__ __forceinline__ fe ge_decompress(const fe &y, int sign, bool &ok) {
    const fe one = fe_small(1);
    const fe y2 = fe_sq(y);
    const fe u = fe_sub(y2, one);
    const fe v = fe_add(fe_mul(fe_load(K_D), y2), one);
    const fe v3 = fe_mul(fe_sq(v), v);
    const fe v7 = fe_mul(fe_sq(v3), v);
    const fe xc = fe_mul(fe_mul(u, v3), fe_pow_p58(fe_mul(u, v7)));
    const fe vx2 = fe_mul(v, fe_sq(xc));
    const bool root_direct = fe_is_zero(fe_sub(vx2, u));
    const bool root_twist = fe_is_zero(fe_add(vx2, u));
    const fe x_twist = fe_mul(xc, fe_load(K_SQRTM1));
    const fe x = fe_canon(fe_sel(root_direct, xc, x_twist));
    int32_t acc = 0;
#pragma unroll
    for (int k = 0; k < 10; k++) acc |= x.v[k];
    ok = (root_direct || root_twist) && !(acc == 0 && sign == 1);
    return fe_carry(fe_sel((x.v[0] & 1) != sign, fe_neg(x), x));
}

// projective -> 32 compressed bytes (vrf.compress): y little-endian with
// the x parity in bit 255
__device__ __forceinline__ void ge_compress(uint8_t out[32], const fe &X,
                                            const fe &Y, const fe &Z) {
    const fe zi = fe_inv(Z);
    const fe xc = fe_canon(fe_mul(X, zi));
    fe_bytes(out, fe_canon(fe_mul(Y, zi)));
    out[31] |= (uint8_t)((xc.v[0] & 1) << 7);
}

// one block of 32 lanes keeps every SM's work to a single warp at the
// main path's lane counts (4096 lanes fill 128 of 132 SMs)
#define OURO_BLOCK 32

#define OURO_LAUNCH_CHECK() return (int)cudaGetLastError()
