// k field operations a lane: the per-operation probe of both field
// products the kernels run.
//
// Replaces the TPU kernel make_chain.<locals>.kernel of
// experiments/microbench_field.py:160 (its pallas_call at :179), which runs
// a <- op(a, b) k times per lane so that two chain lengths, differenced,
// give the cost of one field operation inside a kernel.  Plain version (of
// both launchers): ouroboros_tpu_torch/crypto/field.py:field_chain_core.
//
// Operations, by their index in field.FIELD_OPS:
//   0 mul    a <- a * b
//   1 sqr    a <- a^2           (the JAX chain's mul(a, a), same value)
//   2 add    a <- fe_carry(fe_add(a, b))  (the JAX field's add carries;
//                                 fe_add alone leaves int32 within ~64 steps)
//   3 carry  a <- fe_carry(a)     (one carry round)
//
// Two launchers, one for each field product of the port:
// - ouro_field_chain: one thread a lane, fe25519.cuh's product, every
//   operation.  mul is the fe_mul call and sqr one fe_sq_n call (a loop of
//   inline squares), as the one-thread and four-thread kernels run them.
//   Blocks of OURO_BLOCK (32).
// - ouro_field_chain_lp: eight threads a lane, fe25519_lp.cuh's
//   limb-parallel product, gamma8's: mul is the lp_mul call, sqr one
//   lp_sq_n call (inline products), as gamma8 runs them.  mul and sqr
//   only: add and carry have no limb-parallel form (gamma8 runs them on
//   an owner's two limbs, with no carry).  Blocks of X4_BLOCK (64), eight
//   lanes a block; lanes past n run lane n - 1's inputs and skip only the
//   store, so every thread reaches every shuffle.
// op and k are runtime arguments: one build serves every chain, the loop
// stays a loop, and the result is stored, so nvcc cannot shorten a chain
// that converges (carry does after a round or two).
//
// Bound on this card: operations.  A lane reads 80 bytes and writes 40; a
// step is 100 32x32->64 multiply-adds (mul), 55 (sqr), or, for add and
// carry, a carry round's 41 simple operations (four a limb and the 19x)
// plus fe_add's 10 adds (add).  Design: fe25519.cuh's products carry in
// 32 bits after round 1 (a product is 250 SASS instructions where it was
// 332, 110 of them IMAD.WIDE).  At 4096 lanes the one-thread form
// is one warp an SM and 65536 lanes sixteen, so the two lane counts tell
// the product chain's latency (a per-operation time that stays flat as
// warps are added) from issue (one that grows with them); the
// limb-parallel form runs eight times the warps, and shortens a serial
// chain only where the schedulers idle.  Limbs are (10, N) int32, lane
// last.
#include <cuda_runtime.h>

#include "fe25519_lp.cuh"
#include "ge25519_x4.cuh"

#define FIELD_LP_THREADS_PER_LANE 8
static_assert(FIELD_LP_THREADS_PER_LANE == LP_WIDTH, "one lane a group");

__global__ void __launch_bounds__(OURO_BLOCK)
field_chain_kernel(const int32_t *__restrict__ a,
                   const int32_t *__restrict__ b, int32_t *__restrict__ out,
                   int op, int k, int n) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n) return;
    fe x = fe_from_limbs(a, n, j);
    const fe y = fe_from_limbs(b, n, j);
    if (op == 0) {
        for (int i = 0; i < k; i++) x = fe_mul(x, y);
    } else if (op == 1) {
        x = fe_sq_n(x, k);
    } else if (op == 2) {
        for (int i = 0; i < k; i++) x = fe_carry(fe_add(x, y));
    } else {
        for (int i = 0; i < k; i++) x = fe_carry(x);
    }
    fe_to_limbs(out, n, j, x);
}

__global__ void __launch_bounds__(X4_BLOCK)
field_chain_lp_kernel(const int32_t *__restrict__ a,
                      const int32_t *__restrict__ b,
                      int32_t *__restrict__ out, int op, int k, int n) {
    const int lane = blockIdx.x * (X4_BLOCK / FIELD_LP_THREADS_PER_LANE) +
                     threadIdx.x / FIELD_LP_THREADS_PER_LANE;
    const int r = lp_owner();
    // lanes past the end run the last lane's inputs and store nothing
    const int j = lane < n ? lane : n - 1;
    fd x{{a[(size_t)(2 * r) * n + j], a[(size_t)(2 * r + 1) * n + j]}};
    const fd y{{b[(size_t)(2 * r) * n + j], b[(size_t)(2 * r + 1) * n + j]}};
    if (op == 0) {
        for (int i = 0; i < k; i++) x = lp_mul(x, y);
    } else {
        x = lp_sq_n(x, k);
    }
    if (lane < n && threadIdx.x % FIELD_LP_THREADS_PER_LANE < LP_OWNERS) {
        out[(size_t)(2 * r) * n + lane] = x.v[0];
        out[(size_t)(2 * r + 1) * n + lane] = x.v[1];
    }
}

extern "C" int ouro_field_chain(const void *a, const void *b, void *out,
                                int op, int k, int n, void *stream) {
    if (n <= 0) return 0;
    const int blocks = (n + OURO_BLOCK - 1) / OURO_BLOCK;
    field_chain_kernel<<<blocks, OURO_BLOCK, 0, (cudaStream_t)stream>>>(
        (const int32_t *)a, (const int32_t *)b, (int32_t *)out, op, k, n);
    OURO_LAUNCH_CHECK();
}

extern "C" int ouro_field_chain_lp(const void *a, const void *b, void *out,
                                   int op, int k, int n, void *stream) {
    if (n <= 0) return 0;
    if (op != 0 && op != 1) return (int)cudaErrorInvalidValue;
    const int per_block = X4_BLOCK / FIELD_LP_THREADS_PER_LANE;
    const int blocks = (n + per_block - 1) / per_block;
    field_chain_lp_kernel<<<blocks, X4_BLOCK, 0, (cudaStream_t)stream>>>(
        (const int32_t *)a, (const int32_t *)b, (int32_t *)out, op, k, n);
    OURO_LAUNCH_CHECK();
}
