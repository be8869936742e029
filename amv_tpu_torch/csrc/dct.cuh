// The integer 8x8 transforms shared by kernels T (transcode.cu), I (idct.cu)
// and F (fdct.cu), so that the three compute the same arithmetic:
//   * simple_idct (simple_idct.c:78-253): row pass with the DC-only shortcut
//     wrap16(c0 << 3), >> 11 and an int16 store; column pass >> 20 and the
//     [0, 255] clamp;
//   * jfdctint (jfdctint.c:184-341), CONST_BITS 13, PASS1_BITS 4, wrap16
//     after every output;
//   * dct_quantize_c's AC rule (mpegvideo_enc.c:3646-3725): coef * qmat
//     with a sign-symmetric >> 22 (its clip to +-1023 never acts here).
// All arithmetic is int32 two's-complement with wraparound, as XLA and the
// C reference compute it: products and sums are formed in uint32 so that
// nvcc's signed-overflow assumptions cannot change a result; shifts and
// compares take the int32 view.

#pragma once

#include <stdint.h>

namespace {

typedef uint32_t u32;

// zigzag scan position -> raster index; a local constant array so that the
// unrolled loops fold every index and a block stays in registers
#define AMV_ZIGZAG {                                                   \
     0,  1,  8, 16,  9,  2,  3, 10, 17, 24, 32, 25, 18, 11,  4,  5,    \
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,  6,  7, 14, 21, 28,    \
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,    \
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63}

// int32 views of wrapped uint32 values
__device__ __forceinline__ int32_t s32(u32 x) { return (int32_t)x; }
__device__ __forceinline__ u32 sra(u32 x, int n) { return (u32)(s32(x) >> n); }
__device__ __forceinline__ u32 wrap16(u32 x) { return (u32)(int32_t)(int16_t)(uint16_t)x; }
__device__ __forceinline__ u32 descale(u32 x, int n) { return sra(x + (1u << (n - 1)), n); }

constexpr u32 W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873,
              W6 = 8867, W7 = 4520;

// simple_idct row pass (values already int16-range), in place
__device__ __forceinline__ void idct_row(u32 *c) {
    if ((c[1] | c[2] | c[3] | c[4] | c[5] | c[6] | c[7]) == 0) {
        u32 v = wrap16(c[0] << 3);
#pragma unroll
        for (int i = 0; i < 8; i++) c[i] = v;
        return;
    }
    u32 a0 = W4 * c[0] + (1u << 10);
    u32 a1 = a0 + W6 * c[2] - W4 * c[4] - W2 * c[6];
    u32 a2 = a0 - W6 * c[2] - W4 * c[4] + W2 * c[6];
    u32 a3 = a0 - W2 * c[2] + W4 * c[4] - W6 * c[6];
    a0 = a0 + W2 * c[2] + W4 * c[4] + W6 * c[6];
    u32 b0 = W1 * c[1] + W3 * c[3] + W5 * c[5] + W7 * c[7];
    u32 b1 = W3 * c[1] - W7 * c[3] - W1 * c[5] - W5 * c[7];
    u32 b2 = W5 * c[1] - W1 * c[3] + W7 * c[5] + W3 * c[7];
    u32 b3 = W7 * c[1] - W5 * c[3] + W3 * c[5] - W1 * c[7];
    c[0] = wrap16(sra(a0 + b0, 11)); c[7] = wrap16(sra(a0 - b0, 11));
    c[1] = wrap16(sra(a1 + b1, 11)); c[6] = wrap16(sra(a1 - b1, 11));
    c[2] = wrap16(sra(a2 + b2, 11)); c[5] = wrap16(sra(a2 - b2, 11));
    c[3] = wrap16(sra(a3 + b3, 11)); c[4] = wrap16(sra(a3 - b3, 11));
}

__device__ __forceinline__ u32 clamp255(u32 x) {
    int32_t v = sra(x, 20);
    return (u32)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// simple_idct column pass on column j of blk (stride 8), in place
__device__ __forceinline__ void idct_col(u32 *blk, int j) {
    u32 c[8];
#pragma unroll
    for (int i = 0; i < 8; i++) c[i] = blk[i * 8 + j];
    u32 a0 = W4 * (c[0] + 32u);   // (1 << 19) / W4 == 32
    u32 a1 = a0 + W6 * c[2] - W4 * c[4] - W2 * c[6];
    u32 a2 = a0 - W6 * c[2] - W4 * c[4] + W2 * c[6];
    u32 a3 = a0 - W2 * c[2] + W4 * c[4] - W6 * c[6];
    a0 = a0 + W2 * c[2] + W4 * c[4] + W6 * c[6];
    u32 b0 = W1 * c[1] + W3 * c[3] + W5 * c[5] + W7 * c[7];
    u32 b1 = W3 * c[1] - W7 * c[3] - W1 * c[5] - W5 * c[7];
    u32 b2 = W5 * c[1] - W1 * c[3] + W7 * c[5] + W3 * c[7];
    u32 b3 = W7 * c[1] - W5 * c[3] + W3 * c[5] - W1 * c[7];
    blk[0 * 8 + j] = clamp255(a0 + b0); blk[7 * 8 + j] = clamp255(a0 - b0);
    blk[1 * 8 + j] = clamp255(a1 + b1); blk[6 * 8 + j] = clamp255(a1 - b1);
    blk[2 * 8 + j] = clamp255(a2 + b2); blk[5 * 8 + j] = clamp255(a2 - b2);
    blk[3 * 8 + j] = clamp255(a3 + b3); blk[4 * 8 + j] = clamp255(a3 - b3);
}

// simple_idct_put: 64 raster coefficients in registers -> pixels, in place
__device__ __forceinline__ void idct_put(u32 *blk) {
#pragma unroll
    for (int r = 0; r < 8; r++) idct_row(blk + r * 8);
#pragma unroll
    for (int j = 0; j < 8; j++) idct_col(blk, j);
}

// jfdctint 1-D pass over 8 values at stride s of blk, in place
__device__ __forceinline__ void fdct_1d(u32 *blk, int base, int s, bool pass1) {
    const int sh = pass1 ? 13 - 4 : 13 + 4;
    u32 c[8];
#pragma unroll
    for (int i = 0; i < 8; i++) c[i] = blk[base + i * s];
    u32 t0 = c[0] + c[7], t7 = c[0] - c[7];
    u32 t1 = c[1] + c[6], t6 = c[1] - c[6];
    u32 t2 = c[2] + c[5], t5 = c[2] - c[5];
    u32 t3 = c[3] + c[4], t4 = c[3] - c[4];
    u32 t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
    u32 o0, o4;
    if (pass1) {
        o0 = wrap16((t10 + t11) << 4);
        o4 = wrap16((t10 - t11) << 4);
    } else {
        o0 = wrap16(descale(t10 + t11, 4));
        o4 = wrap16(descale(t10 - t11, 4));
    }
    u32 z1 = (t12 + t13) * 4433u;
    u32 o2 = wrap16(descale(z1 + t13 * 6270u, sh));
    u32 o6 = wrap16(descale(z1 - t12 * 15137u, sh));
    u32 za = t4 + t7, zb = t5 + t6, zc = t4 + t6, zd = t5 + t7;
    u32 z5 = (zc + zd) * 9633u;
    t4 *= 2446u; t5 *= 16819u; t6 *= 25172u; t7 *= 12299u;
    za *= (u32)-7373; zb *= (u32)-20995;
    zc = zc * (u32)-16069 + z5;
    zd = zd * (u32)-3196 + z5;
    blk[base + 0 * s] = o0;
    blk[base + 1 * s] = wrap16(descale(t7 + za + zd, sh));
    blk[base + 2 * s] = o2;
    blk[base + 3 * s] = wrap16(descale(t6 + zb + zc, sh));
    blk[base + 4 * s] = o4;
    blk[base + 5 * s] = wrap16(descale(t5 + zb + zd, sh));
    blk[base + 6 * s] = o6;
    blk[base + 7 * s] = wrap16(descale(t4 + za + zc, sh));
}

// ff_jpeg_fdct_islow on 64 raster pixels in registers, in place
__device__ __forceinline__ void fdct(u32 *blk) {
#pragma unroll
    for (int r = 0; r < 8; r++) fdct_1d(blk, r * 8, 1, true);
#pragma unroll
    for (int j = 0; j < 8; j++) fdct_1d(blk, j, 8, false);
}

// dct_quantize_c's intra DC: (coef + 32) >> 6
__device__ __forceinline__ int16_t quant_dc(u32 coef) {
    return (int16_t)sra(coef + 32u, 6);
}

// dct_quantize_c's AC rule for one coefficient and its qmat entry.  Its
// clip to +-1023 is left out: the wrapped int32 product shifted right by
// 22, sign-symmetrically, lies in [-511, 512] for every u32 product, so
// the clip never acts.
__device__ __forceinline__ int16_t quant_ac(u32 coef, int32_t qmat) {
    const u32 level = coef * (u32)qmat;
    return (int16_t)(s32(level) >= 0 ? s32(level) >> 22
                                     : -(s32(0u - level) >> 22));
}

}  // namespace
