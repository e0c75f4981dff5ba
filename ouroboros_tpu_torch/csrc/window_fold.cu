// The verdict fold over one validation window's packed buffer: each
// Ed25519 lane's verdict, each VRF lane's challenge (SHA-512 of its
// 130-byte preimage against c), the first failing request index over both,
// and the KES job flags and beta rows copied after it.
//
// Replaces the JAX package's jitted fold, _fold_program
// (ouroboros_tpu/crypto/jax_backend.py:687), which XLA fuses into one
// program; it has no Pallas kernel.  Plain version:
// ouroboros_tpu_torch/crypto/fold.py:fold_window.
//
// Input: packed = [ed ok (ne) | vrf rows (nv x 130) | beta rows (nb x 33) |
// kes ok (nk)] uint8; ed_own (ne) and vrf_own (nv) int32, each lane's
// request index (FOLD_SENT for host-known failures and padding); gamma
// (nv x 32) and c (nv x 16), the proofs' bytes 0:32 and 32:48.  Output:
// [first failing index, int32 little-endian, FOLD_SENT for none | kes ok |
// beta rows].  A VRF lane is ok where SHA512(suite || 0x02 || H || Gamma ||
// U || V)[:16] == c and both decompression flags (row bytes 128, 129) are
// set; an Ed25519 lane where its byte is not zero.
//
// What bounds it on this card: nothing the card does.  The main path's
// largest fold reads ~1 MB (131,072 Ed25519 lanes, 2,048 VRF rows) and
// hashes 2,048 two-block preimages, ~7,500 simple 32-bit instructions a
// VRF lane (fold.INT_OPS): under a microsecond by bytes or by issue rate,
// and one lane's 160 rounds are serial, a few microseconds of latency.
// The launch is the cost, so the design is one launch and nothing else:
// the torch-op form it replaces issued ~28,000 eager ops a window.
//
// Design: one thread a VRF lane in the first ceil(nv / FOLD_BLOCK)
// blocks, with the 64-bit words held natively (a rotation is two funnel
// shifts); the padding of the 130-byte preimage is fixed, so the second
// block's message words 1-15 are constants.  The remaining blocks stride
// over the Ed25519 lanes and copy the KES and beta bytes.  Each warp takes
// its minimum with one REDUX, each block with a shared atomic, and thread 0
// of each block puts the block's into the slot's first word (an atomic
// minimum), then takes a ticket from its second; the block that draws the
// last ticket writes the index and resets the slot to (FOLD_SENT, 0) for
// the next launch.  The slot is the caller's, one a stream
// (kernels._fold_slot), so folds on two streams never share one.
#include <cuda_runtime.h>
#include <stdint.h>

#define FOLD_BLOCK 64
// Ed25519 lanes or copied bytes a thread of the striding blocks takes
#define FOLD_PER_THREAD 8
#define FOLD_SENT 0x7FFFFFFF
#define FOLD_ROW 130
#define FOLD_BETA_ROW 33

__constant__ uint64_t SHA512_K[80] = {
    0x428A2F98D728AE22ull, 0x7137449123EF65CDull, 0xB5C0FBCFEC4D3B2Full,
    0xE9B5DBA58189DBBCull, 0x3956C25BF348B538ull, 0x59F111F1B605D019ull,
    0x923F82A4AF194F9Bull, 0xAB1C5ED5DA6D8118ull, 0xD807AA98A3030242ull,
    0x12835B0145706FBEull, 0x243185BE4EE4B28Cull, 0x550C7DC3D5FFB4E2ull,
    0x72BE5D74F27B896Full, 0x80DEB1FE3B1696B1ull, 0x9BDC06A725C71235ull,
    0xC19BF174CF692694ull, 0xE49B69C19EF14AD2ull, 0xEFBE4786384F25E3ull,
    0x0FC19DC68B8CD5B5ull, 0x240CA1CC77AC9C65ull, 0x2DE92C6F592B0275ull,
    0x4A7484AA6EA6E483ull, 0x5CB0A9DCBD41FBD4ull, 0x76F988DA831153B5ull,
    0x983E5152EE66DFABull, 0xA831C66D2DB43210ull, 0xB00327C898FB213Full,
    0xBF597FC7BEEF0EE4ull, 0xC6E00BF33DA88FC2ull, 0xD5A79147930AA725ull,
    0x06CA6351E003826Full, 0x142929670A0E6E70ull, 0x27B70A8546D22FFCull,
    0x2E1B21385C26C926ull, 0x4D2C6DFC5AC42AEDull, 0x53380D139D95B3DFull,
    0x650A73548BAF63DEull, 0x766A0ABB3C77B2A8ull, 0x81C2C92E47EDAEE6ull,
    0x92722C851482353Bull, 0xA2BFE8A14CF10364ull, 0xA81A664BBC423001ull,
    0xC24B8B70D0F89791ull, 0xC76C51A30654BE30ull, 0xD192E819D6EF5218ull,
    0xD69906245565A910ull, 0xF40E35855771202Aull, 0x106AA07032BBD1B8ull,
    0x19A4C116B8D2D0C8ull, 0x1E376C085141AB53ull, 0x2748774CDF8EEB99ull,
    0x34B0BCB5E19B48A8ull, 0x391C0CB3C5C95A63ull, 0x4ED8AA4AE3418ACBull,
    0x5B9CCA4F7763E373ull, 0x682E6FF3D6B2B8A3ull, 0x748F82EE5DEFB2FCull,
    0x78A5636F43172F60ull, 0x84C87814A1F0AB72ull, 0x8CC702081A6439ECull,
    0x90BEFFFA23631E28ull, 0xA4506CEBDE82BDE9ull, 0xBEF9A3F7B2C67915ull,
    0xC67178F2E372532Bull, 0xCA273ECEEA26619Cull, 0xD186B8C721C0C207ull,
    0xEADA7DD6CDE0EB1Eull, 0xF57D4F7FEE6ED178ull, 0x06F067AA72176FBAull,
    0x0A637DC5A2C898A6ull, 0x113F9804BEF90DAEull, 0x1B710B35131C471Bull,
    0x28DB77F523047D84ull, 0x32CAAB7B40C72493ull, 0x3C9EBE0A15C9BEBCull,
    0x431D67C49C100D4Cull, 0x4CC5D4BECB3E42B6ull, 0x597F299CFC657E2Aull,
    0x5FCB6FAB3AD6FAECull, 0x6C44198C4A475817ull};

__device__ __forceinline__ uint64_t rotr64(uint64_t x, int r) {
    return (x >> r) | (x << (64 - r));
}

// one SHA-512 compression of the message words w into the state h
__device__ __forceinline__ void sha512_compress(uint64_t h[8],
                                                uint64_t w[16]) {
    uint64_t a = h[0], b = h[1], c = h[2], d = h[3];
    uint64_t e = h[4], f = h[5], g = h[6], hh = h[7];
#pragma unroll
    for (int t = 0; t < 80; t++) {
        if (t >= 16) {
            const uint64_t w2 = w[(t - 2) & 15], w15 = w[(t - 15) & 15];
            w[t & 15] += (rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6)) +
                         w[(t - 7) & 15] +
                         (rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7));
        }
        const uint64_t t1 = hh + (rotr64(e, 14) ^ rotr64(e, 18) ^
                                  rotr64(e, 41)) +
                            ((e & f) ^ (~e & g)) + SHA512_K[t] + w[t & 15];
        const uint64_t t2 = (rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39)) +
                            ((a & b) ^ (a & c) ^ (b & c));
        hh = g;
        g = f;
        f = e;
        e = d + t1;
        d = c;
        c = b;
        b = a;
        a = t1 + t2;
    }
    h[0] += a;
    h[1] += b;
    h[2] += c;
    h[3] += d;
    h[4] += e;
    h[5] += f;
    h[6] += g;
    h[7] += hh;
}

// byte p of the challenge preimage suite || 0x02 || H || Gamma || U || V
// (row: H, U, V at 0, 32, 64); p is a constant once the loops unroll
__device__ __forceinline__ uint64_t preimage_byte(
    const uint8_t *__restrict__ row, const uint8_t *__restrict__ gam,
    int p) {
    if (p == 0) return 0x04;
    if (p == 1) return 0x02;
    if (p < 34) return row[p - 2];
    if (p < 66) return gam[p - 34];
    return row[p - 34];
}

// c == SHA512(preimage)[:16] for one VRF lane
__device__ __forceinline__ bool challenge_ok(const uint8_t *__restrict__ row,
                                             const uint8_t *__restrict__ gam,
                                             const uint8_t *__restrict__ c) {
    uint64_t h[8] = {0x6A09E667F3BCC908ull, 0xBB67AE8584CAA73Bull,
                     0x3C6EF372FE94F82Bull, 0xA54FF53A5F1D36F1ull,
                     0x510E527FADE682D1ull, 0x9B05688C2B3E6C1Full,
                     0x1F83D9ABFB41BD6Bull, 0x5BE0CD19137E2179ull};
    uint64_t w[16];
#pragma unroll
    for (int i = 0; i < 16; i++) {
        uint64_t x = 0;
#pragma unroll
        for (int k = 0; k < 8; k++)
            x = (x << 8) | preimage_byte(row, gam, 8 * i + k);
        w[i] = x;
    }
    sha512_compress(h, w);
    // the second block: preimage bytes 128-129 (V's last two), the pad's
    // 0x80, zeros, and the length in bits (1040) in the last word
    w[0] = ((uint64_t)row[94] << 56) | ((uint64_t)row[95] << 48) |
           (0x80ull << 40);
#pragma unroll
    for (int i = 1; i < 15; i++) w[i] = 0;
    w[15] = 8 * FOLD_ROW;
    sha512_compress(h, w);
    uint64_t c0 = 0, c1 = 0;
#pragma unroll
    for (int k = 0; k < 8; k++) {
        c0 = (c0 << 8) | c[k];
        c1 = (c1 << 8) | c[8 + k];
    }
    return h[0] == c0 && h[1] == c1;
}

__global__ void __launch_bounds__(FOLD_BLOCK)
window_fold_kernel(const uint8_t *__restrict__ packed,
                   const int32_t *__restrict__ ed_own,
                   const int32_t *__restrict__ vrf_own,
                   const uint8_t *__restrict__ gamma,
                   const uint8_t *__restrict__ cb, int32_t *slot,
                   uint8_t *__restrict__ out, int ne, int nv, int nb,
                   int nk) {
    __shared__ int block_min;
    if (threadIdx.x == 0) block_min = FOLD_SENT;
    int m = FOLD_SENT;
    const int vblocks = (nv + FOLD_BLOCK - 1) / FOLD_BLOCK;
    if ((int)blockIdx.x < vblocks) {
        const int j = blockIdx.x * FOLD_BLOCK + threadIdx.x;
        if (j < nv) {
            const uint8_t *row = packed + ne + (size_t)j * FOLD_ROW;
            const bool ok = row[128] != 0 && row[129] != 0 &&
                            challenge_ok(row, gamma + (size_t)j * 32,
                                         cb + (size_t)j * 16);
            if (!ok) m = vrf_own[j];
        }
    } else {
        const int stride = (gridDim.x - vblocks) * FOLD_BLOCK;
        const int t = (blockIdx.x - vblocks) * FOLD_BLOCK + threadIdx.x;
        for (int k = t; k < ne; k += stride)
            if (packed[k] == 0) m = min(m, ed_own[k]);
        const uint8_t *beta = packed + ne + (size_t)nv * FOLD_ROW;
        const uint8_t *kes = beta + (size_t)nb * FOLD_BETA_ROW;
        for (int k = t; k < nk; k += stride) out[4 + k] = kes[k];
        for (int k = t; k < nb * FOLD_BETA_ROW; k += stride)
            out[4 + nk + k] = beta[k];
    }
    __syncthreads();
    m = __reduce_min_sync(0xffffffffu, m);
    if ((threadIdx.x & 31) == 0 && m < FOLD_SENT) atomicMin(&block_min, m);
    __syncthreads();
    if (threadIdx.x == 0) {
        if (block_min < FOLD_SENT) atomicMin(&slot[0], block_min);
        __threadfence();
        const unsigned ticket = atomicAdd((unsigned *)&slot[1], 1u);
        if (ticket == gridDim.x - 1) {
            const int v = atomicExch(&slot[0], FOLD_SENT);
            atomicExch(&slot[1], 0);
            out[0] = (uint8_t)v;
            out[1] = (uint8_t)(v >> 8);
            out[2] = (uint8_t)(v >> 16);
            out[3] = (uint8_t)(v >> 24);
        }
    }
}

extern "C" int ouro_window_fold(const void *packed, const void *ed_own,
                                const void *vrf_own, const void *gamma,
                                const void *cb, void *slot, void *out,
                                int ne, int nv, int nb, int nk, int n,
                                void *stream) {
    // n: the lanes folded, ne + nv
    if (ne < 0 || nv < 0 || nb < 0 || nk < 0 || n != ne + nv)
        return (int)cudaErrorInvalidValue;
    const int per_block = FOLD_BLOCK * FOLD_PER_THREAD;
    const int work = ne > nk + nb * FOLD_BETA_ROW ? ne
                                                  : nk + nb * FOLD_BETA_ROW;
    int blocks = (nv + FOLD_BLOCK - 1) / FOLD_BLOCK +
                 (work + per_block - 1) / per_block;
    if (blocks == 0) blocks = 1;
    window_fold_kernel<<<blocks, FOLD_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)packed, (const int32_t *)ed_own,
        (const int32_t *)vrf_own, (const uint8_t *)gamma,
        (const uint8_t *)cb, (int32_t *)slot, (uint8_t *)out, ne, nv, nb,
        nk);
    return (int)cudaGetLastError();
}
