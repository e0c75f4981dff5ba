// ECVRF-ED25519-SHA512-Elligator2 verify, device half, one lane per
// thread.
//
// Replaces the TPU kernel _vrf_verify_kernel
// (ouroboros_tpu/crypto/pallas_kernels.py:318) with its helpers
// _select8, _bytes_rows_from_limbs, _compress_rows, _triple_ladder and
// _affine_bytes.  Plain version:
// ouroboros_tpu_torch/crypto/vrf.py:vrf_verify_words_core.
//
// Per lane: decompress Gamma; H = [8] Elligator2(r); H' = [2^128]H; U =
// [s]B - [c]Y and V = [s]H - [c]Gamma as two 128-step split triple
// ladders over 8-entry cached tables (s = lo + 2^128 hi, c < 2^128);
// compress H, U, V and [8]Gamma.  Y's affine x comes from the per-key
// cache, so only Gamma pays a square root.  Output row (130 bytes): H, U,
// V, [8]Gamma, okY (1: the host folds the cache mask), okG.
//
// Bound on this card: operations (~4.6k field products per lane; 272
// bytes in, 130 out).  Design as in ed25519_split.cu: lane-last word
// inputs read coalesced, unpack and digits in the kernel, tables in
// L1-served local memory, one inversion per compressed point.
#include <cuda_runtime.h>

#include "ge25519.cuh"

// vrf.elligator2_fraction: projective Elligator2 with the reference's
// measure-zero edge cases selected explicitly
__device__ __forceinline__ fe sqrt_ratio(const fe &u, const fe &v, bool &ok) {
    const fe v3 = fe_mul(fe_mul(v, v), v);
    const fe v7 = fe_mul(fe_mul(v3, v3), v);
    const fe xc = fe_mul(fe_mul(u, v3), fe_pow_p58(fe_mul(u, v7)));
    const fe vx2 = fe_mul(v, fe_mul(xc, xc));
    const bool root_direct = fe_is_zero(fe_sub(vx2, u));
    const bool root_twist = fe_is_zero(fe_add(vx2, u));
    ok = root_direct || root_twist;
    const fe tw = fe_mul(xc, fe_load(K_SQRTM1));
    const fe x = fe_canon(fe_sel(root_direct, xc, tw));
    return fe_carry(fe_sel((x.v[0] & 1) == 1, fe_neg(x), x));
}

__device__ __forceinline__ ge elligator2(const fe &r) {
    const fe one = fe_small(1);
    const fe zero = fe_small(0);
    const fe Ac = fe_load(K_ELL_A);
    const fe r2 = fe_mul(r, r);
    const fe two_r2 = fe_add(r2, r2);
    const fe W = fe_add(two_r2, one);
    const fe c1 = fe_sub(fe_mul(W, W), fe_mul(fe_mul(Ac, Ac), two_r2));
    const fe chi_in = fe_sub(zero, fe_mul(Ac, fe_mul(c1, W)));
    const bool is_sq = fe_is_zero(fe_sub(fe_chi(chi_in), one));
    const fe negA = fe_sub(zero, Ac);
    const fe U = fe_sel(is_sq, negA, fe_mul(negA, two_r2));
    fe Yn = fe_sub(U, W);
    fe Yd = fe_add(U, W);
    const bool w_zero = fe_is_zero(W);
    Yn = fe_sel(w_zero, fe_load(K_YW0), Yn);
    Yd = fe_sel(w_zero, one, Yd);
    const bool d_zero = fe_is_zero(Yd);
    Yn = fe_sel(d_zero, zero, Yn);
    Yd = fe_sel(d_zero, one, Yd);
    const fe Yn2 = fe_mul(Yn, Yn);
    const fe Yd2 = fe_mul(Yd, Yd);
    const fe u_num = fe_sub(Yn2, Yd2);
    const fe v_num = fe_add(fe_mul(fe_load(K_D), Yn2), Yd2);
    bool ok;
    const fe x = sqrt_ratio(u_num, v_num, ok);
    const fe X = fe_mul(x, Yd);
    const fe T = fe_mul(x, Yn);
    return ge{fe_sel(ok, X, fe_load(K_S1_X)), fe_sel(ok, Yn, fe_load(K_S1_Y)),
              fe_sel(ok, Yd, one), fe_sel(ok, T, fe_load(K_S1_XY))};
}

// Q = [lo]P1 + [hi]P1' + [c]P2 over the 8-entry cached table of
// vrf._triple_table_cached; digit i = lo + 2 hi + 4 c, MSB first
__device__ __forceinline__ ge triple_ladder(const ge &P1, const ge &P1p,
                                            const ge &P2,
                                            const uint32_t *cw,
                                            const uint32_t *sw, int n,
                                            int j) {
    gc table[8];
    const ge t3 = ge_add(P1, P1p);
    table[0] = gc_identity();
    table[1] = ge_cached(P1);
    table[2] = ge_cached(P1p);
    table[3] = ge_cached(t3);
    table[4] = ge_cached(P2);
    table[5] = ge_cached(ge_add(P1, P2));
    table[6] = ge_cached(ge_add(P1p, P2));
    table[7] = ge_cached(ge_add(t3, P2));
    ge Q = ge_identity();
    for (int i = 0; i < 128; i++) {
        const int d = word_bit(sw, n, j, 127 - i) +
                      2 * word_bit(sw, n, j, 255 - i) +
                      4 * word_bit(cw, n, j, 127 - i);
        Q = ge_add_cached(ge_dbl(Q), table[d]);
    }
    return Q;
}

__global__ void __launch_bounds__(OURO_BLOCK)
vrf_verify_kernel(const uint32_t *__restrict__ Yw,
                  const uint32_t *__restrict__ xYw,
                  const uint32_t *__restrict__ Gw,
                  const int32_t *__restrict__ signG,
                  const uint32_t *__restrict__ rw,
                  const uint32_t *__restrict__ cw,
                  const uint32_t *__restrict__ sw,
                  uint8_t *__restrict__ out, int n) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n) return;
    const fe yY = fe_from_words(Yw, n, j);
    const fe xY = fe_from_words(xYw, n, j);
    const fe yG = fe_from_words(Gw, n, j);
    const fe r = fe_from_words(rw, n, j);
    const fe one = fe_small(1);
    const fe zero = fe_small(0);
    bool okG;
    const fe xG = ge_decompress(yG, signG[j], okG);
    const ge H = ge_dbl3(elligator2(r));
    const ge G8 = ge_dbl3(ge{xG, yG, one, fe_mul(xG, yG)});
    const fe nYx = fe_sub(zero, xY);
    const fe nGx = fe_sub(zero, xG);
    const ge B = ge_const(K_S1_X, K_S1_Y, K_S1_XY);
    const ge Bp = ge_const(K_S2_X, K_S2_Y, K_S2_XY);
    ge Hp = H;
    for (int i = 0; i < 128; i++) Hp = ge_dbl(Hp);
    const ge negY{nYx, yY, one, fe_mul(nYx, yY)};
    const ge negG{nGx, yG, one, fe_mul(nGx, yG)};
    const ge U = triple_ladder(B, Bp, negY, cw, sw, n, j);
    const ge V = triple_ladder(H, Hp, negG, cw, sw, n, j);
    uint8_t row[130];
    ge_compress(row, H.X, H.Y, H.Z);
    ge_compress(row + 32, U.X, U.Y, U.Z);
    ge_compress(row + 64, V.X, V.Y, V.Z);
    ge_compress(row + 96, G8.X, G8.Y, G8.Z);
    row[128] = 1;
    row[129] = okG ? 1 : 0;
    uint8_t *o = out + (size_t)j * 130;
    for (int b = 0; b < 130; b++) o[b] = row[b];
}

extern "C" int ouro_vrf_verify(const void *Yw, const void *xYw,
                               const void *Gw, const void *signG,
                               const void *rw, const void *cw, const void *sw,
                               void *out, int n, void *stream) {
    const int blocks = (n + OURO_BLOCK - 1) / OURO_BLOCK;
    vrf_verify_kernel<<<blocks, OURO_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)Yw, (const uint32_t *)xYw, (const uint32_t *)Gw,
        (const int32_t *)signG, (const uint32_t *)rw, (const uint32_t *)cw,
        (const uint32_t *)sw, (uint8_t *)out, n);
    OURO_LAUNCH_CHECK();
}
