// GF(2^255-19), one field element a thread — the field core of the
// port's CUDA kernels (ed25519_split.cu, ed25519_verify.cu, vrf_verify.cu,
// gamma8.cu).
//
// Same representation and carry schedule as the plain PyTorch version
// (ouroboros_tpu_torch/crypto/field.py), so kernel and plain version agree
// limb for limb: ref10's radix 2^25.5, ten signed int32 limbs, limb k
// weighing 2^OFF[k] (even limbs 26 bits, odd 25).  A product is the 100
// 32x32->64 multiply-adds of the schoolbook form (IMAD.WIDE on Hopper),
// summed exactly in int64, then three parallel carry rounds.
//
// Invariants (as in field.py): mul/sqr return "carried" limbs
// (|limb k| <= 2^(W[k]-1) + 2^8) and accept sums of up to four carried
// elements; add/sub do not carry.
#pragma once
#include <stdint.h>

struct fe {
    int32_t v[10];
};

// limb width and bit offset: 26, 25, 26, ... and 0, 26, 51, 77, ... 230
#define FE_W(k) (((k) & 1) ? 25 : 26)
#define FE_OFF(k) (((k) * 51 + 1) / 2)

// constants as carried limbs (field.balanced_limbs of each value; the
// CPU tests check every line of this table against edwards.py)
#define FE_CONST(name, ...) \
    static __device__ __constant__ const int32_t name[10] = {__VA_ARGS__}
FE_CONST(K_D, -10913610, 13857413, -15372611, 6949391, 114729, -8787816,
         -6275908, -3247719, -18696448, -12055116);
FE_CONST(K_D2, -21827239, -5839606, -30745221, 13898782, 229458, 15978800,
         -12551817, -6495438, 29715968, 9444199);
FE_CONST(K_SQRTM1, -32595792, -7943725, 9377950, 3500415, 12389472, -272473,
         -25146209, -2005654, 326686, 11406482);
// the split-ladder constant points B, B' = [2^128]B, B + B': affine x, y,
// x*y and the cached form (y-x, y+x, 2dxy)
FE_CONST(K_S1_X, -14297830, -7645148, 16144683, -16471763, 27570974,
         -2696100, -26142465, 8378389, 20764389, 8758491);
FE_CONST(K_S1_Y, -26843541, -6710886, 13421773, -13421773, 26843546,
         6710886, -13421773, 13421773, -26843546, -6710886);
FE_CONST(K_S1_XY, 28827062, -6116119, -27349572, 244363, 8635006, 11264893,
         19351346, 13413597, 16611511, -6414980);
FE_CONST(K_S1_YMX, -12545711, 934262, -2722910, 3049990, -727428, 9406986,
         12720692, 5043384, 19500929, -15469378);
FE_CONST(K_S1_YPX, 25967493, -14356035, 29566456, 3660896, -12694345,
         4014787, 27544626, -11754271, -6079156, 2047605);
FE_CONST(K_S1_T2D, -8738181, 4489570, 9688441, -14785194, 10184609,
         -12363380, 29287919, 11864899, -24514362, -4438546);
FE_CONST(K_S2_X, 12052535, 1174424, 8175504, 5117753, -27026921, -11654751,
         -23281039, 6656678, -801697, -13590848);
FE_CONST(K_S2_Y, -678274, 11486291, 9685879, 15895846, -29146376, 12753979,
         9394963, -15748418, -26925347, -8605080);
FE_CONST(K_S2_XY, -17747062, -3378606, 28654909, 1258269, 5366162,
         -7189654, 11206660, 391836, -3096762, 1475988);
FE_CONST(K_S2_YMX, -12730809, 10311867, 1510375, 10778093, -2119455,
         -9145702, 32676003, 11149336, -26123651, 4985768);
FE_CONST(K_S2_YPX, 11374242, 12660715, 17861383, -12540833, 10935568,
         1099227, -13886076, -9091740, -27727044, 11358504);
FE_CONST(K_S2_T2D, -19096303, 341147, -6197485, -239033, 15756973, -8796662,
         -983043, 13794114, -19414307, -15621255);
FE_CONST(K_S3_X, 825005, 12536410, -6496388, 4296550, -20735056, 12804180,
         31514438, 9564502, 22198414, -4615275);
FE_CONST(K_S3_Y, -5255013, -11888353, -29227865, 12908075, 14214213,
         -4697787, -16889443, -15217324, 16403638, 14741828);
FE_CONST(K_S3_XY, 21398460, 2895648, 28054567, -3948068, 17824074, -4639343,
         -6857643, -14734600, -8056754, -14847608);
FE_CONST(K_S3_YMX, -6079999, 9129669, -22731478, 8611525, -32159595,
         16052466, 18704982, 8772605, -5794777, -14197329);
FE_CONST(K_S3_YPX, -4430008, 648057, 31384611, -16349808, -6520842, 8106393,
         14624995, -5652822, -28506812, 10126554);
FE_CONST(K_S3_T2D, 22472240, 9473251, 20136607, 3545737, 6583525, -5394043,
         -22300972, -4701040, -29716529, -13074752);
// the full ladder's constant half [2]B, [3]B ([1]B is K_S1), same six forms
FE_CONST(K_B2_X, 4443662, -9940086, 9171065, 2666173, 2111033, 3401644,
         -31605108, 9275297, 13235616, 14331105);
FE_CONST(K_B2_Y, -17259575, -3036261, -30752308, 9118147, -27466691,
         -6152361, 19887205, -13089868, -13594061, 9012024);
FE_CONST(K_B2_XY, 23704577, 9426267, 8410851, 5115833, 24503987, -16534509,
         -22051782, -14974019, 5288695, 9593502);
FE_CONST(K_B2_YMX, -21703237, 6903825, 27185491, 6451973, -29577724,
         -9554005, -15616551, 11189268, -26829678, -5319081);
FE_CONST(K_B2_YPX, -12815894, -12976347, -21581243, 11784320, -25355658,
         -2750717, -11717903, -3814571, -358445, -10211303);
FE_CONST(K_B2_T2D, 26966642, 11152617, 32442495, 15396054, 14353839,
         -12752335, -3128826, -9541118, -15472047, -4166697);
FE_CONST(K_B3_X, -466321, 9574389, 17880460, 13372178, 26021472, 14338106,
         -27837921, -1498113, 10627369, -6374799);
FE_CONST(K_B3_Y, 16102612, 14291486, 6324312, 12269856, -25404496, 2531064,
         -11483344, -13274075, 18317031, 4824775);
FE_CONST(K_B3_XY, 11772954, 4341406, -7775809, 6281400, 24157398, -4647641,
         -6569513, 10624382, 30088665, 11088905);
FE_CONST(K_B3_YMX, 16568933, 4717097, -11556148, -1102322, 15682896,
         -11807043, 16354577, -11775962, 7689662, 11199574);
FE_CONST(K_B3_YPX, 15636291, -9688557, 24204773, -7912398, 616977,
         -16685262, 27787600, -14772189, 28944400, -1550024);
FE_CONST(K_B3_T2D, 30464156, -5976125, -11779434, -15670865, 23220365,
         15915852, 7512774, 10017326, -17749093, -9920357);
// Elligator2: Montgomery A and the y of the 1 + 2r^2 == 0 edge case
FE_CONST(K_ELL_A, 486662, 0, 0, 0, 0, 0, 0, 0, 0, 0);
FE_CONST(K_YW0, -21827646, -4521558, -11878545, 8449817, -22362405, 5967128,
         24150371, -11011590, 19093292, 8833031);

__device__ __forceinline__ fe fe_load(const int32_t *k) {
    fe h;
#pragma unroll
    for (int i = 0; i < 10; i++) h.v[i] = k[i];
    return h;
}

__device__ __forceinline__ fe fe_small(int32_t x) {
    fe h;
#pragma unroll
    for (int i = 0; i < 10; i++) h.v[i] = 0;
    h.v[0] = x;
    return h;
}

__device__ __forceinline__ fe fe_add(const fe &f, const fe &g) {
    fe h;
#pragma unroll
    for (int i = 0; i < 10; i++) h.v[i] = f.v[i] + g.v[i];
    return h;
}

__device__ __forceinline__ fe fe_sub(const fe &f, const fe &g) {
    fe h;
#pragma unroll
    for (int i = 0; i < 10; i++) h.v[i] = f.v[i] - g.v[i];
    return h;
}

__device__ __forceinline__ fe fe_neg(const fe &f) {
    fe h;
#pragma unroll
    for (int i = 0; i < 10; i++) h.v[i] = -f.v[i];
    return h;
}

__device__ __forceinline__ fe fe_sel(bool c, const fe &a, const fe &b) {
    fe h;
#pragma unroll
    for (int i = 0; i < 10; i++) h.v[i] = c ? a.v[i] : b.v[i];
    return h;
}

// one parallel carry round (field.carry_round): limb k keeps its low W[k]
// bits rounded to [-2^(W-1), 2^(W-1)); limb 9's carry re-enters limb 0
// times 19
__device__ __forceinline__ void carry_round64(int64_t t[10]) {
    int64_t c[10];
#pragma unroll
    for (int k = 0; k < 10; k++) {
        c[k] = (t[k] + (int64_t(1) << (FE_W(k) - 1))) >> FE_W(k);
        t[k] -= c[k] * (int64_t(1) << FE_W(k));
    }
    t[0] += 19 * c[9];
#pragma unroll
    for (int k = 1; k < 10; k++) t[k] += c[k - 1];
}

__device__ __forceinline__ fe fe_carry(const fe &f) {
    int64_t t[10];
#pragma unroll
    for (int i = 0; i < 10; i++) t[i] = f.v[i];
    carry_round64(t);
    fe h;
#pragma unroll
    for (int i = 0; i < 10; i++) h.v[i] = (int32_t)t[i];
    return h;
}

__device__ __forceinline__ fe fe_finish_product(const int64_t lo[10],
                                                const int64_t hi[10]) {
    int64_t t[10];
#pragma unroll
    for (int k = 0; k < 10; k++) t[k] = lo[k] + 19 * hi[k];
    carry_round64(t);
    carry_round64(t);
    carry_round64(t);
    fe h;
#pragma unroll
    for (int k = 0; k < 10; k++) h.v[k] = (int32_t)t[k];
    return h;
}

// h = f * g.  Term f_i g_j lands in limb (i + j) mod 10, doubled when i
// and j are both odd, times 19 when i + j >= 10; the wrapped terms are
// summed apart (hi) so each partial sum stays below 2^58.4.
static __device__ __noinline__ fe fe_mul(const fe f, const fe g) {
    int64_t lo[10], hi[10];
#pragma unroll
    for (int k = 0; k < 10; k++) lo[k] = hi[k] = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
        const int32_t fi = f.v[i];
        const int32_t fi2 = (i & 1) ? 2 * fi : fi;
#pragma unroll
        for (int j = 0; j < 10; j++) {
            const int64_t p =
                (int64_t)(((i & 1) && (j & 1)) ? fi2 : fi) * g.v[j];
            if (i + j < 10)
                lo[i + j] += p;
            else
                hi[i + j - 10] += p;
        }
    }
    return fe_finish_product(lo, hi);
}

// h = f^2: the 55 distinct products of the same sum
static __device__ __noinline__ fe fe_sq(const fe f) {
    int64_t lo[10], hi[10];
#pragma unroll
    for (int k = 0; k < 10; k++) lo[k] = hi[k] = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
#pragma unroll
        for (int j = i; j < 10; j++) {
            const int32_t m = (i == j ? 1 : 2) * (((i & 1) && (j & 1)) ? 2 : 1);
            const int64_t p = (int64_t)(m * f.v[i]) * f.v[j];
            if (i + j < 10)
                lo[i + j] += p;
            else
                hi[i + j - 10] += p;
        }
    }
    return fe_finish_product(lo, hi);
}

// exact floor carry from limb 0 up to limb 9 (limb 9 keeps its excess)
__device__ __forceinline__ void seq_carry64(int64_t t[10]) {
#pragma unroll
    for (int k = 0; k < 9; k++) {
        const int64_t c = t[k] >> FE_W(k);
        t[k] &= (int64_t(1) << FE_W(k)) - 1;
        t[k + 1] += c;
    }
}

// canonical digits of the value mod p (field.canon): one carry round
// brings |value| below p, adding p makes it positive, then one
// conditional subtraction of p (v >= p iff v + 19 reaches bit 255)
__device__ __forceinline__ fe fe_canon(const fe &f) {
    int64_t d[10], t[10];
#pragma unroll
    for (int k = 0; k < 10; k++) d[k] = f.v[k];
    carry_round64(d);
    d[0] += (int64_t(1) << 26) - 19;
#pragma unroll
    for (int k = 1; k < 10; k++) d[k] += (int64_t(1) << FE_W(k)) - 1;
    seq_carry64(d);
#pragma unroll
    for (int k = 0; k < 10; k++) t[k] = d[k];
    t[0] += 19;
    seq_carry64(t);
    const bool top = (t[9] >> 25) != 0;
    t[9] &= (int64_t(1) << 25) - 1;
    fe h;
#pragma unroll
    for (int k = 0; k < 10; k++) h.v[k] = (int32_t)(top ? t[k] : d[k]);
    return h;
}

__device__ __forceinline__ bool fe_is_zero(const fe &f) {
    const fe c = fe_canon(f);
    int32_t acc = 0;
#pragma unroll
    for (int k = 0; k < 10; k++) acc |= c.v[k];
    return acc == 0;
}

// column j of an (8, n) little-endian uint32 word array -> carried limbs
// (bit 255 must be clear, as in field.limbs_from_words)
__device__ __forceinline__ fe fe_from_words(const uint32_t *w, int n, int j) {
    uint32_t x[8];
#pragma unroll
    for (int i = 0; i < 8; i++) x[i] = w[(size_t)i * n + j];
    fe h;
#pragma unroll
    for (int k = 0; k < 10; k++) {
        const int o = FE_OFF(k);
        const int i = o / 32, s = o % 32;
        uint64_t v = x[i] >> s;
        if (s + FE_W(k) > 32) v |= (uint64_t)x[i + 1] << (32 - s);
        h.v[k] = (int32_t)(v & ((uint64_t(1) << FE_W(k)) - 1));
    }
    return fe_carry(h);
}

// column j of a (10, n) int32 limb array, lane last: a warp's loads of one
// limb row are coalesced
__device__ __forceinline__ fe fe_from_limbs(const int32_t *a, int n, int j) {
    fe h;
#pragma unroll
    for (int k = 0; k < 10; k++) h.v[k] = a[(size_t)k * n + j];
    return h;
}

__device__ __forceinline__ void fe_to_limbs(int32_t *o, int n, int j,
                                            const fe &h) {
#pragma unroll
    for (int k = 0; k < 10; k++) o[(size_t)k * n + j] = h.v[k];
}

// canonical digits -> 32 little-endian bytes (field.bytes_from_canon)
__device__ __forceinline__ void fe_bytes(uint8_t out[32], const fe &c) {
#pragma unroll
    for (int b = 0; b < 32; b++) {
        const int bit = 8 * b;
        int k = 0;
#pragma unroll
        for (int i = 1; i < 10; i++)
            if (FE_OFF(i) <= bit) k = i;
        const int ok = FE_OFF(k);
        uint32_t v = (uint32_t)c.v[k] >> (bit - ok);
        if (bit + 8 > ok + FE_W(k) && k + 1 < 10)
            v |= (uint32_t)c.v[k + 1] << (FE_OFF(k + 1) - bit);
        out[b] = (uint8_t)(v & 0xFF);
    }
}

__device__ __forceinline__ fe fe_sq_n(fe x, int n) {
    for (int i = 0; i < n; i++) x = fe_sq(x);
    return x;
}

// ref10 addition-chain prefix: z^(2^250-1), with z^11 and z^2 beside
__device__ __forceinline__ void fe_chain250(const fe &z, fe &t250, fe &z11,
                                            fe &z2) {
    z2 = fe_sq(z);
    const fe z9 = fe_mul(z, fe_sq_n(z2, 2));
    z11 = fe_mul(z2, z9);
    fe t0 = fe_mul(z9, fe_mul(z11, z11));
    t0 = fe_mul(fe_sq_n(t0, 5), t0);
    fe t1 = fe_mul(fe_sq_n(t0, 10), t0);
    t1 = fe_mul(fe_sq_n(t1, 20), t1);
    t0 = fe_mul(fe_sq_n(t1, 10), t0);
    t1 = fe_mul(fe_sq_n(t0, 50), t0);
    t1 = fe_mul(fe_sq_n(t1, 100), t1);
    t250 = fe_mul(fe_sq_n(t1, 50), t0);
}

// z^((p-5)/8)
__device__ __forceinline__ fe fe_pow_p58(const fe &z) {
    fe t250, z11, z2;
    fe_chain250(z, t250, z11, z2);
    return fe_mul(fe_sq_n(t250, 2), z);
}

// z^(p-2), inv(0) = 0
__device__ __forceinline__ fe fe_inv(const fe &z) {
    fe t250, z11, z2;
    fe_chain250(z, t250, z11, z2);
    return fe_mul(fe_sq_n(t250, 5), z11);
}

// bit j of column `lane` of an (nw, n) word array
__device__ __forceinline__ int word_bit(const uint32_t *w, int n, int lane,
                                        int j) {
    return (w[(size_t)(j >> 5) * n + lane] >> (j & 31)) & 1;
}
