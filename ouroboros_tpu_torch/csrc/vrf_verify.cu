// ECVRF-ED25519-SHA512-Elligator2 verify, device half, eight threads a
// lane.
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
// Bound on this card: operations (~7.1k field products per lane; 272
// bytes in, 130 out): ~0.07 ms at 2048 lanes.
// Design: eight threads a lane, two points of four threads (ge25519_x4.cuh:
// one thread a coordinate, each doubling or cached addition two rounds of
// four products side by side).  Slots 0-3 carry U's ladder and slots 4-7
// V's, in lockstep on the same digits with the same code, so the warp
// never diverges; 2048 lanes make ~4 warps an SM, one a scheduler.  The
// serial prefix runs on all eight threads alike, except that Gamma's
// square-root power and Elligator2's Legendre power, independent chains of
// ~265 products each, run side by side (slots 0-3 the first, 4-7 the
// second).  [8]Gamma (slots 0-3) and H (slots 4-7) come out of one
// three-doubling run; slots 4-7 then double H 128 times into H' while
// slots 0-3 double along and drop the result.  Each thread keeps only its
// column of its ladder's table (8 x 10 int32) in shared memory.  The four
// compressions run as one, a point a slot: four inversions at once.
#include <cuda_runtime.h>

#include "ge25519_x4.cuh"

#define VRF_THREADS_PER_LANE 8

// vrf._sqrt_ratio: the even root x of u / v, ok where one exists
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

// vrf.elligator2_fraction up to the input of its Legendre symbol
__device__ __forceinline__ fe elligator2_chi_in(const fe &r, fe &two_r2,
                                                fe &W) {
    const fe Ac = fe_load(K_ELL_A);
    const fe r2 = fe_mul(r, r);
    two_r2 = fe_add(r2, r2);
    W = fe_add(two_r2, fe_small(1));
    const fe c1 = fe_sub(fe_mul(W, W), fe_mul(fe_mul(Ac, Ac), two_r2));
    return fe_sub(fe_small(0), fe_mul(Ac, fe_mul(c1, W)));
}

// the rest of vrf.elligator2_fraction, given chi = chi_in^((p-1)/2):
// projective Elligator2 with the reference's measure-zero edge cases
// selected explicitly
__device__ __forceinline__ ge elligator2_finish(const fe &two_r2,
                                                const fe &W, const fe &chi) {
    const fe one = fe_small(1);
    const fe zero = fe_small(0);
    const bool is_sq = fe_is_zero(fe_sub(chi, one));
    const fe negA = fe_sub(zero, fe_load(K_ELL_A));
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

// ge_decompress split around its power: the power's input z = u v^7 ...
__device__ __forceinline__ fe decompress_pow_in(const fe &y, fe &u, fe &v,
                                                fe &v3) {
    const fe y2 = fe_sq(y);
    u = fe_sub(y2, fe_small(1));
    v = fe_add(fe_mul(fe_load(K_D), y2), fe_small(1));
    v3 = fe_mul(fe_sq(v), v);
    const fe v7 = fe_mul(fe_sq(v3), v);
    return fe_mul(u, v7);
}

// ... and the rest, given p58 = fe_pow_p58(z)
__device__ __forceinline__ fe decompress_finish(const fe &u, const fe &v,
                                                const fe &v3, const fe &p58,
                                                int sign, bool &ok) {
    const fe xc = fe_mul(fe_mul(u, v3), p58);
    const fe vx2 = fe_mul(v, fe_sq(xc));
    const bool root_direct = fe_is_zero(fe_sub(vx2, u));
    const bool root_twist = fe_is_zero(fe_add(vx2, u));
    const fe x_twist = fe_mul(xc, fe_load(K_SQRTM1));
    const fe x = fe_canon(fe_sel(root_direct, xc, x_twist));
    int32_t acc = 0;
#pragma unroll
    for (int k = 0; k < 10; k++) acc |= x.v[k];
    ok = (root_direct || root_twist) && !(acc == 0 && sign == 1);
    return fe_carry(fe_sel((x.v[0] & 1) != sign, fe_neg(x), x));
}

// vrf._triple_table_cached, column t: entry lo + 2 hi + 4 c of
// [lo]P1 + [hi]P1' + [c]P2 (coordinate t of each point)
__device__ __forceinline__ void triple_table_x4(int32_t *tab, int t,
                                                const fe &P1, const fe &P1p,
                                                const fe &P2) {
    const fe t3 = ge_add_x4(t, P1, P1p);
    gc_put_x4(tab, 0, gc_identity_x4(t));
    gc_put_x4(tab, 1, ge_cached_x4(t, P1));
    gc_put_x4(tab, 2, ge_cached_x4(t, P1p));
    gc_put_x4(tab, 3, ge_cached_x4(t, t3));
    gc_put_x4(tab, 4, ge_cached_x4(t, P2));
    gc_put_x4(tab, 5, ge_cached_x4(t, ge_add_x4(t, P1, P2)));
    gc_put_x4(tab, 6, ge_cached_x4(t, ge_add_x4(t, P1p, P2)));
    gc_put_x4(tab, 7, ge_cached_x4(t, ge_add_x4(t, t3, P2)));
}

__global__ void __launch_bounds__(X4_BLOCK)
vrf_verify_kernel(const uint32_t *__restrict__ Yw,
                  const uint32_t *__restrict__ xYw,
                  const uint32_t *__restrict__ Gw,
                  const int32_t *__restrict__ signG,
                  const uint32_t *__restrict__ rw,
                  const uint32_t *__restrict__ cw,
                  const uint32_t *__restrict__ sw,
                  uint8_t *__restrict__ out, int n) {
    __shared__ int32_t tab[8 * 10 * X4_BLOCK];
    const int lane = blockIdx.x * (X4_BLOCK / VRF_THREADS_PER_LANE) +
                     threadIdx.x / VRF_THREADS_PER_LANE;
    const int s = threadIdx.x % VRF_THREADS_PER_LANE;
    const int t = s & 3;          // the coordinate
    const bool vh = s >= 4;       // V's half (U's: slots 0-3)
    // lanes past the end run the last lane's inputs and store nothing
    const int j = lane < n ? lane : n - 1;
    const fe yY = fe_from_words(Yw, n, j);
    const fe xY = fe_from_words(xYw, n, j);
    const fe yG = fe_from_words(Gw, n, j);
    const fe r = fe_from_words(rw, n, j);
    const fe one = fe_small(1);
    const fe zero = fe_small(0);
    // Gamma's square-root power (U's half) beside Elligator2's Legendre
    // power (V's half): one fe_chain250 on a per-half input
    fe u, v, v3, two_r2, W;
    const fe zG = decompress_pow_in(yG, u, v, v3);
    const fe zE = elligator2_chi_in(r, two_r2, W);
    const fe z = fe_sel(vh, zE, zG);
    fe t250, z11, z2;
    fe_chain250(z, t250, z11, z2);
    const fe t252 = fe_sq_n(t250, 2);
    const fe p58 = fe_mul(t252, z);          // z^((p-5)/8), as fe_pow_p58
    const fe z4 = fe_mul(z2, z2);            // z^((p-1)/2), the Legendre
    const fe z6 = fe_mul(z4, z2);            // symbol (field.pow_chi)
    const fe chi = fe_mul(fe_sq_n(t252, 2), z6);
    bool okG;
    const fe xG = decompress_finish(u, v, v3, fe_shfl(p58, 0, 8), signG[j],
                                    okG);
    const ge ell = elligator2_finish(two_r2, W, fe_shfl(chi, 4, 8));
    // [8]Gamma in U's half, H = [8]Elligator2(r) in V's half
    const fe xGyG = fe_mul(xG, yG);
    fe k = fe_sel(vh, fe_pick4(t, ell.X, ell.Y, ell.Z, ell.T),
                  fe_pick4(t, xG, yG, one, xGyG));
    k = ge_dbl_x4(t, ge_dbl_x4(t, ge_dbl_x4(t, k)));
    // H' = [2^128]H in V's half
    fe kp = k;
    for (int i = 0; i < 128; i++) kp = ge_dbl_x4(t, kp);
    // U's table over (B, B', -Y), V's over (H, H', -Gamma)
    const fe nx = fe_sel(vh, fe_sub(zero, xG), fe_sub(zero, xY));
    const fe ny = fe_sel(vh, yG, yY);
    const fe P2 = fe_pick4(t, nx, ny, one, fe_mul(nx, ny));
    const fe P1 = fe_sel(vh, k, ge_const_x4(t, GE_CONST_PT(K_S1)));
    const fe P1p = fe_sel(vh, kp, ge_const_x4(t, GE_CONST_PT(K_S2)));
    triple_table_x4(tab, t, P1, P1p, P2);
    fe q = ge_identity_x4(t);
    for (int w = 3; w >= 0; w--) {
        const uint32_t s_lo = sw[(size_t)w * n + j];
        const uint32_t s_hi = sw[(size_t)(w + 4) * n + j];
        const uint32_t c_lo = cw[(size_t)w * n + j];
        for (int b = 31; b >= 0; b--) {
            const int d = ((s_lo >> b) & 1) | ((s_hi >> b) & 1) << 1 |
                          ((c_lo >> b) & 1) << 2;
            q = ge_add_cached_x4(t, ge_dbl_x4(t, q), gc_get_x4(tab, d));
        }
    }
    // one compression a slot: H, U, V, [8]Gamma (slots 4-7 repeat 0-3)
    fe P[3];
#pragma unroll
    for (int c = 0; c < 3; c++)
        P[c] = fe_pick4(t, fe_shfl(k, 4 + c, 8), fe_shfl(q, c, 8),
                        fe_shfl(q, 4 + c, 8), fe_shfl(k, c, 8));
    uint8_t row[32];
    ge_compress(row, P[0], P[1], P[2]);
    if (lane < n && !vh) {
        uint8_t *o = out + (size_t)lane * 130;
        for (int b = 0; b < 32; b++) o[32 * t + b] = row[b];
        if (t == 0) {
            o[128] = 1;
            o[129] = okG ? 1 : 0;
        }
    }
}

extern "C" int ouro_vrf_verify(const void *Yw, const void *xYw,
                               const void *Gw, const void *signG,
                               const void *rw, const void *cw, const void *sw,
                               void *out, int n, void *stream) {
    if (n <= 0) return 0;
    const int per_block = X4_BLOCK / VRF_THREADS_PER_LANE;
    const int blocks = (n + per_block - 1) / per_block;
    vrf_verify_kernel<<<blocks, X4_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)Yw, (const uint32_t *)xYw, (const uint32_t *)Gw,
        (const int32_t *)signG, (const uint32_t *)rw, (const uint32_t *)cw,
        (const uint32_t *)sw, (uint8_t *)out, n);
    OURO_LAUNCH_CHECK();
}
