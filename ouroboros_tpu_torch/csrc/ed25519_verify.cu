// Ed25519 full 256-bit verify, four threads a lane.
//
// Replaces the TPU kernel _ed25519_verify_kernel
// (ouroboros_tpu/crypto/pallas_kernels.py:105).  Plain version:
// ouroboros_tpu_torch/crypto/ed25519.py:verify_full_words_core.
//
// Per lane: decompress A and R (RFC 8032 §5.1.3, x = 0 with sign 1
// rejected); the 16-entry cached joint table T[i + 4j] = [i]B + [j](-A)
// with [i]B constants and -A, [2](-A), [3](-A) built in the lane; 128 steps
// of two doublings plus one cached addition on the digits
// (2 s[255-2i] + s[254-2i]) + 4 (2 k[255-2i] + k[254-2i]) (MSB first);
// accept iff A and R decoded and X - x_R Z = Y - y_R Z = 0.
//
// Bound on this card: operations.  A lane reads 136 bytes and writes 4,
// but does ~3.7k field products (304k 32x32->64 multiply-adds): ~0.07 ms
// at 4096 lanes.
// What the one-thread design lost: 4096 lanes at one thread a lane were
// one warp an SM, one scheduler in four busy, every product of the ladder
// at one thread's latency, and the 16-entry table in local memory.
// Design: ed25519_split.cu's.  A lane's four threads hold one coordinate
// each of the ladder's point (ge25519_x4.cuh), so each doubling and each
// cached addition is two rounds of four products side by side: the
// ladder's 1536 products a lane become 768 rounds, and 4096 lanes make ~4
// warps an SM, one a scheduler.  The table is built four-way too, and
// each thread keeps its column of it (16 x 10 int32) in shared memory.
// The two decompressions, independent chains of ~265 products each, run
// side by side: slots 0-1 decompress A, slots 2-3 R, with the same code on
// inputs picked by slot, and the results move by shuffle.  Launch: blocks
// of X4_BLOCK (64) threads, 16 lanes a block, 40 KB of shared memory a
// block.  Lanes past n run lane n - 1's inputs and skip only the store.
// Inputs arrive as the port's host prep returns them ((8, N) uint32 words,
// lane last); the unpack and the digits run in the kernel.
#include <cuda_runtime.h>

#include "ge25519_x4.cuh"

#define VERIFY_THREADS_PER_LANE 4

__global__ void __launch_bounds__(X4_BLOCK)
ed25519_verify_kernel(const uint32_t *__restrict__ Aw,
                      const int32_t *__restrict__ signA,
                      const uint32_t *__restrict__ Rw,
                      const int32_t *__restrict__ signR,
                      const uint32_t *__restrict__ sw,
                      const uint32_t *__restrict__ kw,
                      int32_t *__restrict__ out, int n) {
    __shared__ int32_t tab[16 * 10 * X4_BLOCK];
    const int lane = blockIdx.x * (X4_BLOCK / VERIFY_THREADS_PER_LANE) +
                     threadIdx.x / VERIFY_THREADS_PER_LANE;
    const int t = threadIdx.x % VERIFY_THREADS_PER_LANE;
    // lanes past the end run the last lane's inputs and store nothing
    const int j = lane < n ? lane : n - 1;
    const fe yA = fe_from_words(Aw, n, j);
    const fe yR = fe_from_words(Rw, n, j);
    // A's decompression in slots 0-1 beside R's in slots 2-3
    const bool rh = t >= 2;
    bool ok;
    const fe x = ge_decompress(fe_sel(rh, yR, yA), rh ? signR[j] : signA[j],
                               ok);
    const fe xA = fe_shfl(x, 0, 4), xR = fe_shfl(x, 2, 4);
    const bool okA = __shfl_sync(X4_ALL, (int)ok, 0, 4) != 0;
    const bool okR = __shfl_sync(X4_ALL, (int)ok, 2, 4) != 0;
    const fe nax = fe_sub(fe_small(0), xA);
    fe var[4];  // var[0], the identity, is never read
    var[1] = fe_pick4(t, nax, yA, fe_small(1), fe_mul(nax, yA));
    var[2] = ge_dbl_x4(t, var[1]);
    var[3] = ge_add_x4(t, var[2], var[1]);
    // [i]B for i = 1, 2, 3 (B itself is the split table's K_S1)
    const ge_const_pt cst[4] = {{}, GE_CONST_PT(K_S1), GE_CONST_PT(K_B2),
                                GE_CONST_PT(K_B3)};
    gc_table16_x4(tab, t, var, cst);
    fe q = ge_identity_x4(t);
    for (int w = 7; w >= 0; w--) {
        const uint32_t s = sw[(size_t)w * n + j];
        const uint32_t k = kw[(size_t)w * n + j];
        for (int b = 31; b >= 1; b -= 2) {
            const int ds = 2 * ((s >> b) & 1) + ((s >> (b - 1)) & 1);
            const int dk = 2 * ((k >> b) & 1) + ((k >> (b - 1)) & 1);
            q = ge_add_cached_x4(t, ge_dbl_x4(t, ge_dbl_x4(t, q)),
                                 gc_get_x4(tab, ds + 4 * dk));
        }
    }
    const fe X = fe_shfl(q, 0, 4), Y = fe_shfl(q, 1, 4), Z = fe_shfl(q, 2, 4);
    const fe d1 = fe_sub(fe_mul(xR, Z), X);
    const fe d2 = fe_sub(fe_mul(yR, Z), Y);
    if (t == 0 && lane < n)
        out[lane] = (okA && okR && fe_is_zero(d1) && fe_is_zero(d2)) ? 1 : 0;
}

extern "C" int ouro_ed25519_verify(const void *Aw, const void *signA,
                                   const void *Rw, const void *signR,
                                   const void *sw, const void *kw, void *out,
                                   int n, void *stream) {
    if (n <= 0) return 0;
    const int per_block = X4_BLOCK / VERIFY_THREADS_PER_LANE;
    const int blocks = (n + per_block - 1) / per_block;
    ed25519_verify_kernel<<<blocks, X4_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)Aw, (const int32_t *)signA, (const uint32_t *)Rw,
        (const int32_t *)signR, (const uint32_t *)sw, (const uint32_t *)kw,
        (int32_t *)out, n);
    OURO_LAUNCH_CHECK();
}
