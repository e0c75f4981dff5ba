// Ed25519 split-128 verify, four threads a lane.
//
// Replaces the TPU kernel _ed25519_split_kernel
// (ouroboros_tpu/crypto/pallas_kernels.py:182).  Plain version:
// ouroboros_tpu_torch/crypto/ed25519.py:verify_full_split_words_core.
//
// Per lane: decompress R; -A and -[2^128]A from the per-key cache's affine
// coordinates; the 16-entry cached table T[c + 4v] over {1, B, B', B+B'} x
// {1, -A, -A', -A-A'}; 128 steps of one doubling plus one cached addition
// on the digits s_lo + 2 s_hi + 4 k_lo + 8 k_hi (MSB first); accept iff R
// decoded and X - x_R Z = Y - y_R Z = 0.
//
// Bound on this card: operations.  A lane reads 232 bytes and writes 4,
// but does ~2.4k field products of 100 32x32->64 multiply-adds each; the
// bound at 4096 lanes is ~0.05 ms.
// Design: a lane's four threads hold one coordinate each of the ladder's
// point (ge25519_x4.cuh), so each doubling and each cached addition is two
// rounds of four products side by side: the ladder's 1024 products a lane
// become 512 rounds, and 4096 lanes make ~4 warps an SM, one for each of
// the SM's four schedulers (one thread a lane left one warp an SM, three
// schedulers idle and the product chain's latency exposed).  The table is
// built four-way too, and each thread keeps only its column of it (16 x 10
// int32) in shared memory, where the old design's per-thread table sat in
// local memory.  R's decompression (~265 products) stays serial, run by all
// four threads alike.  Inputs arrive as the JAX call takes them ((8, N)
// uint32 words, lane last); the unpack and the digits run in the kernel.
#include <cuda_runtime.h>

#include "ge25519_x4.cuh"

#define SPLIT_THREADS_PER_LANE 4

__global__ void __launch_bounds__(X4_BLOCK)
ed25519_split_kernel(const uint32_t *__restrict__ Aw,
                     const uint32_t *__restrict__ xAw,
                     const uint32_t *__restrict__ A128xw,
                     const uint32_t *__restrict__ A128yw,
                     const uint32_t *__restrict__ Rw,
                     const int32_t *__restrict__ signR,
                     const uint32_t *__restrict__ sw,
                     const uint32_t *__restrict__ kw,
                     int32_t *__restrict__ out, int n) {
    __shared__ int32_t tab[16 * 10 * X4_BLOCK];
    const int lane = blockIdx.x * (X4_BLOCK / SPLIT_THREADS_PER_LANE) +
                     threadIdx.x / SPLIT_THREADS_PER_LANE;
    const int t = threadIdx.x % SPLIT_THREADS_PER_LANE;
    // lanes past the end run the last lane's inputs and store nothing
    const int j = lane < n ? lane : n - 1;
    const fe yA = fe_from_words(Aw, n, j);
    const fe xA = fe_from_words(xAw, n, j);
    const fe yR = fe_from_words(Rw, n, j);
    const fe xA128 = fe_from_words(A128xw, n, j);
    const fe yA128 = fe_from_words(A128yw, n, j);
    bool okR;
    const fe xR = ge_decompress(yR, signR[j], okR);
    const fe one = fe_small(1);
    const fe nax = fe_sub(fe_small(0), xA);
    const fe nax128 = fe_sub(fe_small(0), xA128);
    fe var[4];  // var[0], the identity, is never read
    var[1] = fe_pick4(t, nax, yA, one, fe_mul(nax, yA));
    var[2] = fe_pick4(t, nax128, yA128, one, fe_mul(nax128, yA128));
    var[3] = ge_add_x4(t, var[1], var[2]);
    const ge_const_pt cst[4] = {{}, GE_CONST_PT(K_S1), GE_CONST_PT(K_S2),
                                GE_CONST_PT(K_S3)};
    gc_table16_x4(tab, t, var, cst);
    fe q = ge_identity_x4(t);
    for (int w = 3; w >= 0; w--) {
        const uint32_t s_lo = sw[(size_t)w * n + j];
        const uint32_t s_hi = sw[(size_t)(w + 4) * n + j];
        const uint32_t k_lo = kw[(size_t)w * n + j];
        const uint32_t k_hi = kw[(size_t)(w + 4) * n + j];
        for (int b = 31; b >= 0; b--) {
            const int d = ((s_lo >> b) & 1) | ((s_hi >> b) & 1) << 1 |
                          ((k_lo >> b) & 1) << 2 | ((k_hi >> b) & 1) << 3;
            q = ge_add_cached_x4(t, ge_dbl_x4(t, q), gc_get_x4(tab, d));
        }
    }
    const fe X = fe_shfl(q, 0, 4), Y = fe_shfl(q, 1, 4), Z = fe_shfl(q, 2, 4);
    const fe d1 = fe_sub(fe_mul(xR, Z), X);
    const fe d2 = fe_sub(fe_mul(yR, Z), Y);
    if (t == 0 && lane < n)
        out[lane] = (okR && fe_is_zero(d1) && fe_is_zero(d2)) ? 1 : 0;
}

extern "C" int ouro_ed25519_split(const void *Aw, const void *xAw,
                                  const void *A128xw, const void *A128yw,
                                  const void *Rw, const void *signR,
                                  const void *sw, const void *kw, void *out,
                                  int n, void *stream) {
    if (n <= 0) return 0;
    const int per_block = X4_BLOCK / SPLIT_THREADS_PER_LANE;
    const int blocks = (n + per_block - 1) / per_block;
    ed25519_split_kernel<<<blocks, X4_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)Aw, (const uint32_t *)xAw,
        (const uint32_t *)A128xw, (const uint32_t *)A128yw,
        (const uint32_t *)Rw, (const int32_t *)signR, (const uint32_t *)sw,
        (const uint32_t *)kw, (int32_t *)out, n);
    OURO_LAUNCH_CHECK();
}
