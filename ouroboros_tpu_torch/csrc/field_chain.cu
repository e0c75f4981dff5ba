// k field operations a lane, one thread a lane: the per-operation probe.
//
// Replaces the TPU kernel make_chain.<locals>.kernel of
// experiments/microbench_field.py:160 (its pallas_call at :179), which runs
// a <- op(a, b) k times per lane so that two chain lengths, differenced,
// give the cost of one field operation inside a kernel.  Plain version:
// ouroboros_tpu_torch/crypto/field.py:field_chain_core.
//
// Operations, by their index in field.FIELD_OPS:
//   0 mul    a <- fe_mul(a, b)
//   1 sqr    a <- fe_sq(a)        (the JAX chain's mul(a, a), same value)
//   2 add    a <- fe_carry(fe_add(a, b))  (the JAX field's add carries;
//                                 fe_add alone leaves int32 within ~64 steps)
//   3 carry  a <- fe_carry(a)     (one carry_round64)
// Each is the header's own (fe25519.cuh), fe_mul and fe_sq __noinline__
// included, so a chain times what the window kernels run.  op and k are
// runtime arguments: one build serves every chain, the loop stays a loop,
// and the result is stored, so nvcc cannot shorten a chain that converges
// (carry does after a round or two).
//
// Bound on this card: operations.  A lane reads 80 bytes and writes 40; a
// step is 100 32x32->64 multiply-adds (mul), 55 (sqr), or, for add and
// carry, carry_round64's 51 64-bit adds, shifts, subtractions and its one
// multiply by 19 (102 32-bit operations) plus fe_add's 10 adds (add).
// Design: one thread a lane in blocks of OURO_BLOCK (32), as gamma8 and
// ed25519_verify run: 4096 lanes are one warp an SM and 65536 lanes
// sixteen, so the two lane counts tell the product chain's latency (a
// per-operation time that stays flat as warps are added) from issue (one
// that grows with them).  Limbs are (10, N) int32, lane last, read and
// written coalesced.
#include <cuda_runtime.h>

#include "ge25519.cuh"

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
        for (int i = 0; i < k; i++) x = fe_sq(x);
    } else if (op == 2) {
        for (int i = 0; i < k; i++) x = fe_carry(fe_add(x, y));
    } else {
        for (int i = 0; i < k; i++) x = fe_carry(x);
    }
    fe_to_limbs(out, n, j, x);
}

extern "C" int ouro_field_chain(const void *a, const void *b, void *out,
                                int op, int k, int n, void *stream) {
    if (n <= 0) return 0;
    const int blocks = (n + OURO_BLOCK - 1) / OURO_BLOCK;
    field_chain_kernel<<<blocks, OURO_BLOCK, 0, (cudaStream_t)stream>>>(
        (const int32_t *)a, (const int32_t *)b, (int32_t *)out, op, k, n);
    OURO_LAUNCH_CHECK();
}
