// [8]Gamma for VRF betas, eight threads a lane, limb-parallel products.
//
// Replaces the TPU kernel _gamma8_kernel
// (ouroboros_tpu/crypto/pallas_kernels.py:407).  Plain version:
// ouroboros_tpu_torch/crypto/vrf.py:gamma8_words_core.
//
// Per lane: decompress Gamma, three doublings, one inversion, compress.
// Output row (33 bytes): compressed [8]Gamma, okG.  The host hashes the
// row into beta = SHA512(suite || 0x03 || [8]Gamma).
//
// Bound on this card: operations (~560 field products a lane, 33k 32-bit
// multiply-adds; 36 bytes in, 33 out): ~0.004 ms at 2048 lanes.
// What the one-thread design lost: nearly all of a lane's products form
// one dependent chain (the square root of the decompression, ~265
// products, then the inversion, ~265), and 2048 lanes at one thread a
// lane were one warp an SM on 64 of 132 SMs, one scheduler in eight busy,
// each product paying its whole latency (~1060 cycles, about 1/3 of it
// waiting).  Splitting a point's coordinates (ge25519_x4.cuh) cannot
// shorten a serial chain; splitting each product can.
// Design: eight threads a lane, each product spread over them
// (fe25519_lp.cuh): five owners of two limbs and two output columns each
// (limbs 2r, 2r + 1), slots 5-7 repeating slot 4; a thread's share of a
// product is 20 column terms plus 17 for the wrapped part, 20 shuffles to
// gather the operands and one a carry round.  2048 lanes make 512 warps,
// about one a scheduler.  Additions, subtractions and selects run on the
// owner's two limbs; the few whole-element steps (canonical form, zero
// tests, bytes) gather the element and run fe25519.cuh's code in every
// thread alike.  Every field operation of ge_decompress, ge_dbl and
// ge_compress runs on the same operands, so each limb equals the
// one-thread kernel's and the plain version's, garbage lanes included;
// ge_dbl's T, which neither the next doubling nor the compression reads,
// is not computed.  Launch: blocks of X4_BLOCK (64) threads, eight lanes a
// block; no shared memory.  Lanes past n run lane n - 1's inputs and skip
// only the store.
#include <cuda_runtime.h>

#include "fe25519_lp.cuh"
#include "ge25519_x4.cuh"

#define GAMMA8_THREADS_PER_LANE 8
static_assert(GAMMA8_THREADS_PER_LANE == LP_WIDTH, "one lane a group");

// ge_decompress on limb-parallel products
__device__ __forceinline__ fd lp_decompress(const fd &y, int sign, bool &ok) {
    const fd one = fd_small(1);
    const fd y2 = lp_sq(y);
    const fd u = fd_sub(y2, one);
    const fd v = fd_add(lp_mul(fd_load(K_D), y2), one);
    const fd v3 = lp_mul(lp_sq(v), v);
    const fd v7 = lp_mul(lp_sq(v3), v);
    const fd xc = lp_mul(lp_mul(u, v3), lp_pow_p58(lp_mul(u, v7)));
    const fd vx2 = lp_mul(v, lp_sq(xc));
    const bool root_direct = fe_is_zero(fd_gather(fd_sub(vx2, u)));
    const bool root_twist = fe_is_zero(fd_gather(fd_add(vx2, u)));
    const fd x_twist = lp_mul(xc, fd_load(K_SQRTM1));
    const fe x = fe_canon(fd_gather(fd_sel(root_direct, xc, x_twist)));
    int32_t acc = 0;
#pragma unroll
    for (int k = 0; k < 10; k++) acc |= x.v[k];
    ok = (root_direct || root_twist) && !(acc == 0 && sign == 1);
    return fd_of(fe_carry(fe_sel((x.v[0] & 1) != sign, fe_neg(x), x)));
}

// ge_dbl's X, Y, Z
__device__ __forceinline__ void lp_dbl(fd &X, fd &Y, fd &Z) {
    const fd A = lp_sq(X);
    const fd B = lp_sq(Y);
    const fd ZZ = lp_sq(Z);
    const fd XY2 = lp_sq(fd_add(X, Y));
    const fd C = fd_add(ZZ, ZZ);
    const fd H = fd_add(A, B);
    const fd E = fd_sub(H, XY2);
    const fd G = fd_sub(A, B);
    const fd F = fd_add(C, G);
    X = lp_mul(E, F);
    Y = lp_mul(G, H);
    Z = lp_mul(F, G);
}

// ge_compress
__device__ __forceinline__ void lp_compress(uint8_t out[32], const fd &X,
                                            const fd &Y, const fd &Z) {
    const fd zi = lp_inv(Z);
    const fe xc = fe_canon(fd_gather(lp_mul(X, zi)));
    fe_bytes(out, fe_canon(fd_gather(lp_mul(Y, zi))));
    out[31] |= (uint8_t)((xc.v[0] & 1) << 7);
}

__global__ void __launch_bounds__(X4_BLOCK)
gamma8_kernel(const uint32_t *__restrict__ Gw,
              const int32_t *__restrict__ signG, uint8_t *__restrict__ out,
              int n) {
    const int lane = blockIdx.x * (X4_BLOCK / GAMMA8_THREADS_PER_LANE) +
                     threadIdx.x / GAMMA8_THREADS_PER_LANE;
    const int s = threadIdx.x % GAMMA8_THREADS_PER_LANE;
    // lanes past the end run the last lane's inputs and store nothing
    const int j = lane < n ? lane : n - 1;
    const fd yG = fd_of(fe_from_words(Gw, n, j));
    bool okG;
    fd X = lp_decompress(yG, signG[j], okG);
    fd Y = yG, Z = fd_small(1);
    for (int i = 0; i < 3; i++) lp_dbl(X, Y, Z);
    uint8_t row[32];
    lp_compress(row, X, Y, Z);
    if (s == 0 && lane < n) {
        uint8_t *o = out + (size_t)lane * 33;
        for (int b = 0; b < 32; b++) o[b] = row[b];
        o[32] = okG ? 1 : 0;
    }
}

extern "C" int ouro_gamma8(const void *Gw, const void *signG, void *out,
                           int n, void *stream) {
    if (n <= 0) return 0;
    const int per_block = X4_BLOCK / GAMMA8_THREADS_PER_LANE;
    const int blocks = (n + per_block - 1) / per_block;
    gamma8_kernel<<<blocks, X4_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)Gw, (const int32_t *)signG, (uint8_t *)out, n);
    OURO_LAUNCH_CHECK();
}
