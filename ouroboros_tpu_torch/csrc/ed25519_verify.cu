// Ed25519 full 256-bit verify, one lane per thread.
//
// Replaces the TPU kernel _ed25519_verify_kernel
// (ouroboros_tpu/crypto/pallas_kernels.py:105).  Plain version:
// ouroboros_tpu_torch/crypto/ed25519.py:verify_full_words_core.
//
// Per lane: decompress A and R (RFC 8032 §5.1.3, x = 0 with sign 1
// rejected); the 16-entry cached joint table T[4j + i] = [i]B + [j](-A)
// with [i]B constants and -A, [2](-A), [3](-A) built in the lane; 128 steps
// of two doublings plus one cached addition on the digits
// (2 s[255-2i] + s[254-2i]) + 4 (2 k[255-2i] + k[254-2i]) (MSB first);
// accept iff A and R decoded and X - x_R Z = Y - y_R Z = 0.
//
// Bound on this card: operations.  A lane reads 136 bytes and writes 4,
// but does ~3.7k field products (2197 products and 1536 squares: 304k
// 32x32->64 multiply-adds), 1.5x the split kernel's.
// Design: the split kernel's (ed25519_split.cu), with the per-key cache's
// inputs replaced by A's decompression in the lane and twice the
// doublings.  The packed-words inputs arrive as the port's host prep
// returns them ((8, N) uint32, lane last), so a warp's loads of one word
// row are coalesced; the word -> limb unpack and the digit extraction run
// in the kernel.  The table (16 x 40 int32) lives in local memory, which L1
// serves; the lookup is a plain indexed load (verification handles public
// data).  Several threads per lane and shared-memory tables are later work.
#include <cuda_runtime.h>

#include "ge25519.cuh"

__global__ void __launch_bounds__(OURO_BLOCK)
ed25519_verify_kernel(const uint32_t *__restrict__ Aw,
                      const int32_t *__restrict__ signA,
                      const uint32_t *__restrict__ Rw,
                      const int32_t *__restrict__ signR,
                      const uint32_t *__restrict__ sw,
                      const uint32_t *__restrict__ kw,
                      int32_t *__restrict__ out, int n) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n) return;
    const fe yA = fe_from_words(Aw, n, j);
    const fe yR = fe_from_words(Rw, n, j);
    bool okA, okR;
    const fe xA = ge_decompress(yA, signA[j], okA);
    const fe xR = ge_decompress(yR, signR[j], okR);
    const fe nax = fe_sub(fe_small(0), xA);
    ge var[4];
    var[1] = ge{nax, yA, fe_small(1), fe_mul(nax, yA)};
    var[2] = ge_dbl(var[1]);
    var[3] = ge_add(var[2], var[1]);
    // [i]B for i = 1, 2, 3 (B itself is the split table's K_S1)
    const ge_const_pt cst[4] = {{}, GE_CONST_PT(K_S1), GE_CONST_PT(K_B2),
                                GE_CONST_PT(K_B3)};
    gc table[16];
    gc_table16(table, var, cst);
    ge Q = ge_identity();
    for (int i = 0; i < 128; i++) {
        const int hi = 255 - 2 * i, lo = 254 - 2 * i;
        const int ds = 2 * word_bit(sw, n, j, hi) + word_bit(sw, n, j, lo);
        const int dk = 2 * word_bit(kw, n, j, hi) + word_bit(kw, n, j, lo);
        const int d = ds + 4 * dk;
        Q = ge_add_cached(ge_dbl(ge_dbl(Q)), table[d]);
    }
    const fe d1 = fe_sub(fe_mul(xR, Q.Z), Q.X);
    const fe d2 = fe_sub(fe_mul(yR, Q.Z), Q.Y);
    out[j] = (okA && okR && fe_is_zero(d1) && fe_is_zero(d2)) ? 1 : 0;
}

extern "C" int ouro_ed25519_verify(const void *Aw, const void *signA,
                                   const void *Rw, const void *signR,
                                   const void *sw, const void *kw, void *out,
                                   int n, void *stream) {
    const int blocks = (n + OURO_BLOCK - 1) / OURO_BLOCK;
    ed25519_verify_kernel<<<blocks, OURO_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)Aw, (const int32_t *)signA, (const uint32_t *)Rw,
        (const int32_t *)signR, (const uint32_t *)sw, (const uint32_t *)kw,
        (int32_t *)out, n);
    OURO_LAUNCH_CHECK();
}
