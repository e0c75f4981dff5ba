// k point operations a lane: the per-operation probe of both point-op
// implementations of the port.
//
// Replaces the TPU kernel make_pt_chain.<locals>.kernel of
// experiments/microbench_field.py:186 (its pallas_call at :200): from
// P = (a, b, a, b) in extended coordinates, Q <- pt_double(Q) (kind 0,
// dbl) or Q <- pt_add(Q, P) (kind 1, addc) k times, and the unreduced limb
// sum X + Y + Z + T is stored.  P is not on the curve; the formulas alone
// fix the value.  Plain version (of both launchers):
// ouroboros_tpu_torch/crypto/ed25519.py:point_chain_core.
//
// Two launchers, one for each point-op form of the port:
// - ouro_point_chain: one thread a lane, ge_dbl / ge_add of ge25519.cuh,
//   in blocks of OURO_BLOCK (32);
// - ouro_point_chain_x4: four threads a lane, one a coordinate, ge_dbl_x4 /
//   ge_add_x4 of ge25519_x4.cuh, as ed25519_split, ed25519_verify and
//   vrf_verify run them, in blocks of X4_BLOCK (64).  The four slots'
//   coordinates meet in slot 0 by __shfl_sync of width 4 for the sum.
//   Lanes past n run lane n - 1's inputs and skip only the store: every
//   thread reaches every shuffle.
// Every field operation is the plain version's on the same operands, so
// both launchers equal it limb for limb.
//
// Bound on this card: operations.  A lane reads 80 bytes and writes 40; a
// dbl is 4 squares and 4 products (4 x 55 + 4 x 100 multiply-adds), an
// addc 9 products (900).  Design: fe25519.cuh's products carry in 32 bits
// after round 1; ge_dbl's eight products are inline, so that nvcc
// interleaves the independent ones, while ge_add keeps product calls
// (inline, its nine took the kernel to 255 registers and ran slower); a
// four-thread op is one call with its products inline.  kind and k are
// runtime arguments, as in field_chain.cu; at 4096 lanes the one-thread
// form is one warp an SM and the four-thread form four, one a scheduler.
#include <cuda_runtime.h>

#include "ge25519_x4.cuh"

#define PTX4_THREADS_PER_LANE 4

__global__ void __launch_bounds__(OURO_BLOCK)
point_chain_kernel(const int32_t *__restrict__ a,
                   const int32_t *__restrict__ b, int32_t *__restrict__ out,
                   int kind, int k, int n) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n) return;
    const fe x = fe_from_limbs(a, n, j);
    const fe y = fe_from_limbs(b, n, j);
    const ge p{x, y, x, y};
    ge q = p;
    if (kind == 0) {
        for (int i = 0; i < k; i++) q = ge_dbl(q);
    } else {
        for (int i = 0; i < k; i++) q = ge_add(q, p);
    }
    fe_to_limbs(out, n, j, fe_add(fe_add(fe_add(q.X, q.Y), q.Z), q.T));
}

__global__ void __launch_bounds__(X4_BLOCK)
point_chain_x4_kernel(const int32_t *__restrict__ a,
                      const int32_t *__restrict__ b,
                      int32_t *__restrict__ out, int kind, int k, int n) {
    const int lane = blockIdx.x * (X4_BLOCK / PTX4_THREADS_PER_LANE) +
                     threadIdx.x / PTX4_THREADS_PER_LANE;
    const int t = threadIdx.x % PTX4_THREADS_PER_LANE;
    // lanes past the end run the last lane's inputs and store nothing
    const int j = lane < n ? lane : n - 1;
    const fe x = fe_from_limbs(a, n, j);
    const fe y = fe_from_limbs(b, n, j);
    const fe p = fe_pick4(t, x, y, x, y);  // coordinate t of (a, b, a, b)
    fe q = p;
    if (kind == 0) {
        for (int i = 0; i < k; i++) q = ge_dbl_x4(t, q);
    } else {
        for (int i = 0; i < k; i++) q = ge_add_x4(t, q, p);
    }
    const fe X = fe_shfl(q, 0, 4), Y = fe_shfl(q, 1, 4);
    const fe Z = fe_shfl(q, 2, 4), T = fe_shfl(q, 3, 4);
    if (t == 0 && lane < n)
        fe_to_limbs(out, n, lane, fe_add(fe_add(fe_add(X, Y), Z), T));
}

extern "C" int ouro_point_chain(const void *a, const void *b, void *out,
                                int kind, int k, int n, void *stream) {
    if (n <= 0) return 0;
    const int blocks = (n + OURO_BLOCK - 1) / OURO_BLOCK;
    point_chain_kernel<<<blocks, OURO_BLOCK, 0, (cudaStream_t)stream>>>(
        (const int32_t *)a, (const int32_t *)b, (int32_t *)out, kind, k, n);
    OURO_LAUNCH_CHECK();
}

extern "C" int ouro_point_chain_x4(const void *a, const void *b, void *out,
                                   int kind, int k, int n, void *stream) {
    if (n <= 0) return 0;
    const int per_block = X4_BLOCK / PTX4_THREADS_PER_LANE;
    const int blocks = (n + per_block - 1) / per_block;
    point_chain_x4_kernel<<<blocks, X4_BLOCK, 0, (cudaStream_t)stream>>>(
        (const int32_t *)a, (const int32_t *)b, (int32_t *)out, kind, k, n);
    OURO_LAUNCH_CHECK();
}
