// KES hash-path check: one BLAKE2b-256 compression of a 64-byte block per
// lane, compared with the expected digest.
//
// Replaces the TPU kernel _kes_hash_kernel
// (ouroboros_tpu/crypto/pallas_kernels.py:454).  Plain version:
// ouroboros_tpu_torch/crypto/blake2b.py:check_block64.
//
// Bound on this card: operations, barely (12 rounds x 8 mixes of 64-bit
// adds, xors and rotates: ~2.7k 32-bit integer operations per lane against
// 100 bytes moved).  At the main path's 8192 lanes either bound is a few
// microseconds, below the launch cost.  Design: the TPU form carries
// 64-bit words as (lo, hi) uint32 pairs because its lanes are 32-bit; here
// a thread holds native uint64 words and the 12 rounds unroll with the
// message schedule resolved at compile time, so the state and message
// stay in registers.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ge25519.cuh"

__device__ __forceinline__ uint64_t rotr64(uint64_t x, int r) {
    return (x >> r) | (x << (64 - r));
}

#define B2_G(a, b, c, d, x, y)         \
    do {                               \
        v[a] = v[a] + v[b] + (x);      \
        v[d] = rotr64(v[d] ^ v[a], 32); \
        v[c] = v[c] + v[d];            \
        v[b] = rotr64(v[b] ^ v[c], 24); \
        v[a] = v[a] + v[b] + (y);      \
        v[d] = rotr64(v[d] ^ v[a], 16); \
        v[c] = v[c] + v[d];            \
        v[b] = rotr64(v[b] ^ v[c], 63); \
    } while (0)

// one round with the message schedule as literals, so every m[] index is
// a compile-time constant and m stays in registers
#define B2_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, \
                 s14, s15)                                                \
    do {                                                                  \
        B2_G(0, 4, 8, 12, m[s0], m[s1]);                                  \
        B2_G(1, 5, 9, 13, m[s2], m[s3]);                                  \
        B2_G(2, 6, 10, 14, m[s4], m[s5]);                                 \
        B2_G(3, 7, 11, 15, m[s6], m[s7]);                                 \
        B2_G(0, 5, 10, 15, m[s8], m[s9]);                                 \
        B2_G(1, 6, 11, 12, m[s10], m[s11]);                               \
        B2_G(2, 7, 8, 13, m[s12], m[s13]);                                \
        B2_G(3, 4, 9, 14, m[s14], m[s15]);                                \
    } while (0)

__global__ void __launch_bounds__(OURO_BLOCK)
kes_hash_kernel(const uint32_t *__restrict__ mw,
                const uint32_t *__restrict__ ew, int32_t *__restrict__ out,
                int n) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n) return;
    const uint64_t IV[8] = {
        0x6A09E667F3BCC908ull, 0xBB67AE8584CAA73Bull, 0x3C6EF372FE94F82Bull,
        0xA54FF53A5F1D36F1ull, 0x510E527FADE682D1ull, 0x9B05688C2B3E6C1Full,
        0x1F83D9ABFB41BD6Bull, 0x5BE0CD19137E2179ull};
    uint64_t m[16];
#pragma unroll
    for (int i = 0; i < 8; i++)
        m[i] = (uint64_t)mw[(size_t)(2 * i) * n + j] |
               ((uint64_t)mw[(size_t)(2 * i + 1) * n + j] << 32);
#pragma unroll
    for (int i = 8; i < 16; i++) m[i] = 0;
    uint64_t h[8], v[16];
#pragma unroll
    for (int i = 0; i < 8; i++) h[i] = IV[i];
    h[0] ^= 0x01010020ull;  // digest 32 bytes, no key, fanout = depth = 1
#pragma unroll
    for (int i = 0; i < 8; i++) {
        v[i] = h[i];
        v[i + 8] = IV[i];
    }
    v[12] ^= 64;       // t0: one 64-byte block
    v[14] = ~v[14];    // final block
    // BLAKE2b SIGMA; rounds 10 and 11 repeat the schedules of 0 and 1
    B2_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
    B2_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);
    B2_ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4);
    B2_ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8);
    B2_ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13);
    B2_ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9);
    B2_ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11);
    B2_ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10);
    B2_ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5);
    B2_ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0);
    B2_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
    B2_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);
    bool ok = true;
#pragma unroll
    for (int i = 0; i < 4; i++) {
        const uint64_t d = h[i] ^ v[i] ^ v[i + 8];
        ok = ok && (uint32_t)d == ew[(size_t)(2 * i) * n + j] &&
             (uint32_t)(d >> 32) == ew[(size_t)(2 * i + 1) * n + j];
    }
    out[j] = ok ? 1 : 0;
}

extern "C" int ouro_kes_hash(const void *mw, const void *ew, void *out,
                             int n, void *stream) {
    const int blocks = (n + OURO_BLOCK - 1) / OURO_BLOCK;
    kes_hash_kernel<<<blocks, OURO_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)mw, (const uint32_t *)ew, (int32_t *)out, n);
    OURO_LAUNCH_CHECK();
}
