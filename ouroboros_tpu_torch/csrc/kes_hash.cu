// KES hash-path check: one BLAKE2b-256 compression of a 64-byte block per
// lane, compared with the expected digest.
//
// Replaces the TPU kernel _kes_hash_kernel
// (ouroboros_tpu/crypto/pallas_kernels.py:454).  Plain version:
// ouroboros_tpu_torch/crypto/blake2b.py:check_block64.
//
// What bounds it on this card: not throughput.  A check needs 2,112
// simple 32-bit instructions at the fewest (12 rounds x 8 mixes of
// 64-bit adds, xors and rotations; blake2b.INT_OPS) against 100 bytes
// moved, 0.5 us for the main path's 8192 lanes at the SM's issue rate;
// but one lane's 24 half-rounds are serial (~22 instructions a mix), so
// at 8192 lanes, about one warp a scheduler, the time is that chain's
// latency plus a launch's fixed cost (an empty kernel at this grid ~1
// us, one that only loads the inputs ~1.5 us on an H100, PERF.md).
//
// Design: two threads a lane, the pair holding the 4x4 state by columns
// (thread t: columns 2t and 2t + 1), so each half-round is two
// interleaved mixes a thread instead of four: the column step on own
// columns, then row B's one word, row C's two and row D's one from the
// partner (__shfl_xor_sync; 16 SHFL a round, those after the last round
// that no digest word needs dropped by the compiler) for the diagonal
// step, and back.  The message schedule is resolved at compile time: a
// mix's word is a select between the two threads' literal indices, and
// the zero words 8-15 fold away.  64-bit words are held natively; nvcc
// turns each rotation into two funnel shifts or a register swap (~22
// instructions a mix, 1,415 a thread in all).  Each thread loads the
// message and its own four expected digest words before the rounds, so
// all loads are in flight together, and compares branch-free; the pair
// ors its differences and thread 0 stores.  Measured on an H100 at 8192
// lanes (csrc_compare, PERF.md): 0.0029 ms against 0.0036-0.0038 for one
// thread a lane (block 32 or 128, rotations as 64-bit shifts or as byte
// permutes and funnel shifts on 32-bit halves: the same 2,177
// instructions) and 0.0049 for the previous one-thread form, whose digest
// loads sat after the rounds; at 65536 lanes, where issue bounds, the
// one-thread form is 10 % faster, but a full window launches 8192.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ge25519.cuh"

__device__ __forceinline__ uint64_t rotr64(uint64_t x, int r) {
    return (x >> r) | (x << (64 - r));
}

#define KES_THREADS_PER_LANE 2
#define KES_BLOCK 64

#define G2(a, b, c, d, x, y)      \
    do {                          \
        a = a + b + (x);          \
        d = rotr64(d ^ a, 32);    \
        c = c + d;                \
        b = rotr64(b ^ c, 24);    \
        a = a + b + (y);          \
        d = rotr64(d ^ a, 16);    \
        c = c + d;                \
        b = rotr64(b ^ c, 63);    \
    } while (0)

__device__ __forceinline__ uint64_t pair_swap(uint64_t x) {
    return __shfl_xor_sync(0xffffffffu, (unsigned long long)x, 1);
}

// thread t of a pair holds columns 2t and 2t + 1 of the 4x4 state (A, B,
// C, D the rows); m word s0 for thread 0, s1 for thread 1
#define M2(s0, s1) (t ? m[s1] : m[s0])
// the column step on own columns, then rows B (one word), C (two) and D
// (one) from the partner for the diagonal step, and back
#define B2_ROUND2(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, \
                  s13, s14, s15)                                        \
    do {                                                                \
        G2(A0, B0, C0, D0, M2(s0, s4), M2(s1, s5));                     \
        G2(A1, B1, C1, D1, M2(s2, s6), M2(s3, s7));                     \
        uint64_t PB0 = pair_swap(B0), PC0 = pair_swap(C0),              \
                 PC1 = pair_swap(C1), PD1 = pair_swap(D1);              \
        G2(A0, B1, PC0, PD1, M2(s8, s12), M2(s9, s13));                 \
        G2(A1, PB0, PC1, D0, M2(s10, s14), M2(s11, s15));               \
        B0 = pair_swap(PB0);                                            \
        C0 = pair_swap(PC0);                                            \
        C1 = pair_swap(PC1);                                            \
        D1 = pair_swap(PD1);                                            \
    } while (0)

__global__ void __launch_bounds__(KES_BLOCK)
kes_hash_kernel(const uint32_t *__restrict__ mw,
                const uint32_t *__restrict__ ew, int32_t *__restrict__ out,
                int n) {
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    const int lane = g / KES_THREADS_PER_LANE;
    const int t = g % KES_THREADS_PER_LANE;
    // threads past the end run the last lane's inputs and store nothing
    const int j = lane < n ? lane : n - 1;
    const uint64_t IV[8] = {
        0x6A09E667F3BCC908ull, 0xBB67AE8584CAA73Bull, 0x3C6EF372FE94F82Bull,
        0xA54FF53A5F1D36F1ull, 0x510E527FADE682D1ull, 0x9B05688C2B3E6C1Full,
        0x1F83D9ABFB41BD6Bull, 0x5BE0CD19137E2179ull};
    uint64_t m[16];
    uint32_t e[4];
#pragma unroll
    for (int i = 0; i < 8; i++)
        m[i] = (uint64_t)mw[(size_t)(2 * i) * n + j] |
               ((uint64_t)mw[(size_t)(2 * i + 1) * n + j] << 32);
#pragma unroll
    for (int i = 0; i < 4; i++) e[i] = ew[(size_t)(4 * t + i) * n + j];
#pragma unroll
    for (int i = 8; i < 16; i++) m[i] = 0;
    const uint64_t h0 = IV[0] ^ 0x01010020ull;
    // v = h || IV with t0 = 64 and the final-block flag; own columns
    uint64_t A0 = t ? IV[2] : h0, A1 = t ? IV[3] : IV[1];
    uint64_t B0 = t ? IV[6] : IV[4], B1 = t ? IV[7] : IV[5];
    uint64_t C0 = t ? IV[2] : IV[0], C1 = t ? IV[3] : IV[1];
    uint64_t D0 = t ? ~IV[6] : IV[4] ^ 64, D1 = t ? IV[7] : IV[5];
    const uint64_t H0 = t ? IV[2] : h0, H1 = t ? IV[3] : IV[1];
    B2_ROUND2(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
    B2_ROUND2(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);
    B2_ROUND2(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4);
    B2_ROUND2(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8);
    B2_ROUND2(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13);
    B2_ROUND2(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9);
    B2_ROUND2(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11);
    B2_ROUND2(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10);
    B2_ROUND2(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5);
    B2_ROUND2(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0);
    B2_ROUND2(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
    B2_ROUND2(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);
    // digest words 2t and 2t + 1 against the expected ones, then the pair
    const uint64_t d0 = H0 ^ A0 ^ C0, d1 = H1 ^ A1 ^ C1;
    uint32_t diff = ((uint32_t)d0 ^ e[0]) | ((uint32_t)(d0 >> 32) ^ e[1]) |
                    ((uint32_t)d1 ^ e[2]) | ((uint32_t)(d1 >> 32) ^ e[3]);
    diff |= __shfl_xor_sync(0xffffffffu, diff, 1);
    if (t == 0 && lane < n) out[lane] = diff == 0;
}

extern "C" int ouro_kes_hash(const void *mw, const void *ew, void *out,
                             int n, void *stream) {
    if (n <= 0) return 0;
    const int per_block = KES_BLOCK / KES_THREADS_PER_LANE;
    const int blocks = (n + per_block - 1) / per_block;
    kes_hash_kernel<<<blocks, KES_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)mw, (const uint32_t *)ew, (int32_t *)out, n);
    OURO_LAUNCH_CHECK();
}
