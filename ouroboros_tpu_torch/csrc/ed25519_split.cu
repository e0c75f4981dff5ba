// Ed25519 split-128 verify, one lane per thread.
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
// but does ~2.3k field products of 100 32x32->64 multiply-adds each.
// Design: the packed-words inputs arrive as the JAX call takes them
// ((8, N) uint32, lane last), so a warp's loads of one word row are
// coalesced, and the word -> limb unpack and the digit extraction run in
// the kernel.  The table (16 x 40 int32) lives in local memory, which L1
// serves; the lookup is a plain indexed load (verification handles public
// data).  Shared-memory tables, several threads per lane and a wider
// radix with carry chains are later work.
#include <cuda_runtime.h>

#include "ge25519.cuh"

__global__ void __launch_bounds__(OURO_BLOCK)
ed25519_split_kernel(const uint32_t *__restrict__ Aw,
                     const uint32_t *__restrict__ xAw,
                     const uint32_t *__restrict__ A128xw,
                     const uint32_t *__restrict__ A128yw,
                     const uint32_t *__restrict__ Rw,
                     const int32_t *__restrict__ signR,
                     const uint32_t *__restrict__ sw,
                     const uint32_t *__restrict__ kw,
                     int32_t *__restrict__ out, int n) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n) return;
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
    ge var[4];
    var[1] = ge{nax, yA, one, fe_mul(nax, yA)};
    var[2] = ge{nax128, yA128, one, fe_mul(nax128, yA128)};
    var[3] = ge_add(var[1], var[2]);
    const ge_const_pt cst[4] = {{}, GE_CONST_PT(K_S1), GE_CONST_PT(K_S2),
                                GE_CONST_PT(K_S3)};
    gc table[16];
    gc_table16(table, var, cst);
    ge Q = ge_identity();
    for (int i = 0; i < 128; i++) {
        const int d = word_bit(sw, n, j, 127 - i) +
                      2 * word_bit(sw, n, j, 255 - i) +
                      4 * word_bit(kw, n, j, 127 - i) +
                      8 * word_bit(kw, n, j, 255 - i);
        Q = ge_add_cached(ge_dbl(Q), table[d]);
    }
    const fe d1 = fe_sub(fe_mul(xR, Q.Z), Q.X);
    const fe d2 = fe_sub(fe_mul(yR, Q.Z), Q.Y);
    out[j] = (okR && fe_is_zero(d1) && fe_is_zero(d2)) ? 1 : 0;
}

extern "C" int ouro_ed25519_split(const void *Aw, const void *xAw,
                                  const void *A128xw, const void *A128yw,
                                  const void *Rw, const void *signR,
                                  const void *sw, const void *kw, void *out,
                                  int n, void *stream) {
    const int blocks = (n + OURO_BLOCK - 1) / OURO_BLOCK;
    ed25519_split_kernel<<<blocks, OURO_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)Aw, (const uint32_t *)xAw,
        (const uint32_t *)A128xw, (const uint32_t *)A128yw,
        (const uint32_t *)Rw, (const int32_t *)signR, (const uint32_t *)sw,
        (const uint32_t *)kw, (int32_t *)out, n);
    OURO_LAUNCH_CHECK();
}
