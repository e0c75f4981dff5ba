// [8]Gamma for VRF betas, one lane per thread.
//
// Replaces the TPU kernel _gamma8_kernel
// (ouroboros_tpu/crypto/pallas_kernels.py:407).  Plain version:
// ouroboros_tpu_torch/crypto/vrf.py:gamma8_words_core.
//
// Per lane: decompress Gamma, three doublings, one inversion, compress.
// Output row (33 bytes): compressed [8]Gamma, okG.  The host hashes the
// row into beta = SHA512(suite || 0x03 || [8]Gamma).
//
// Bound on this card: operations (~560 field products per lane, 36 bytes
// in, 33 out).  Design: the decompress and compress code is the shared
// ge25519.cuh core of the VRF kernel; lane-last word inputs read
// coalesced.
#include <cuda_runtime.h>

#include "ge25519.cuh"

__global__ void __launch_bounds__(OURO_BLOCK)
gamma8_kernel(const uint32_t *__restrict__ Gw,
              const int32_t *__restrict__ signG, uint8_t *__restrict__ out,
              int n) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n) return;
    const fe yG = fe_from_words(Gw, n, j);
    bool okG;
    const fe xG = ge_decompress(yG, signG[j], okG);
    const ge G8 = ge_dbl3(ge{xG, yG, fe_small(1), fe_mul(xG, yG)});
    uint8_t row[33];
    ge_compress(row, G8.X, G8.Y, G8.Z);
    row[32] = okG ? 1 : 0;
    uint8_t *o = out + (size_t)j * 33;
    for (int b = 0; b < 33; b++) o[b] = row[b];
}

extern "C" int ouro_gamma8(const void *Gw, const void *signG, void *out,
                           int n, void *stream) {
    const int blocks = (n + OURO_BLOCK - 1) / OURO_BLOCK;
    gamma8_kernel<<<blocks, OURO_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)Gw, (const int32_t *)signG, (uint8_t *)out, n);
    OURO_LAUNCH_CHECK();
}
