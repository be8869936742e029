// Kernel V: AMV encode transform straight from the planes: MCU block
// gather (with the AMV flip and edge replication on the encode path) +
// jfdctint + quantizer -> levels.
//
// Replaces the Pallas kernel
//   amv_tpu/kernels/encode_fused_pallas.py:encode_fused (coded planes ->
//     raster levels; an interpret-mode prototype that Mosaic refused for
//     its rank-6 block-extraction reshapes).
// One kernel, three instances (template parameters):
//   * kDisplay false, kQuantFfmpeg (encode_fused's contract): coded planes,
//     already flipped and padded, y [F, 16 mb_h, 16 mb_w], cb and cr
//     [F, 8 mb_h, 8 mb_w] -> raster levels;
//   * kDisplay true (the encode path): display planes y [F, H, W], cb and
//     cr [F, H/2, W/2], the flip and the bottom/right edge replication of
//     amv_tpu codecs/amv_video.py extract_blocks (entropy.c
//     amv_ref_encode_frame) folded into the load: coded row r reads
//     display row h - 1 - min(r, h - 1), column c reads min(c, w - 1), for
//     a plane h x w -> zigzag levels, kernel E's input;
//     - kQuantFfmpeg: dct_quantize_c (mpegvideo_enc.c), slot 0 the absolute
//       DC (coef + 32) >> 6, AC coef * qmat with a sign-symmetric >> 22 and
//       a clip to +-1023 in int32 wraparound (dct.cuh, as kernels T and F);
//     - kQuantQ60: amv_tpu encode_transform(quant="q60") (amv_video.py
//       :204-216), which JAX computes in XLA: num = coef less 8192 at DC,
//       den = 8 * Q60[r] of the block's component, (|num| + den / 2) / den
//       with num's sign, a clip to +-1023, then +128 at DC.
// The transform is dct.cuh's fdct.
//
// What bounds it: 64 bytes of pixels in and 128 of levels out a block,
// against ~1,600 integer operations (the q60 divisions add ~1,300):
// memory, if the accesses were whole lines.  Design, simple first: one
// thread per block, as kernel F; each of the 8 pixel rows loaded as one
// 8-byte vector where the row lies whole in a plane whose width is a
// multiple of 8, else byte by byte with the column clamp; the levels
// stored as 16-byte vectors; the tables in the kernel parameters.  The
// extracted block tensor and the flip/pad/permute copies of the F route
// are gone.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dct.cuh"

namespace {

struct QuantTables {
    int32_t qmat[64];   // encoder reciprocal quantizer, raster (ffmpeg)
    int32_t q60_l[64];  // Q60 luma table, raster (q60)
    int32_t q60_c[64];  // Q60 chroma table, raster (q60)
};

// Frames of n_mcu MCUs, mb_w to a row; luma planes height x width a frame,
// chroma planes height / 2 x width / 2.
struct Planes {
    long long n_mcu, mb_w;
    int width, height;
};

enum { kQuantFfmpeg = 0, kQuantQ60 = 1 };

constexpr int kThreads = 192;

// amv_tpu encode_transform's q60 rule for the coefficient at raster r
__device__ __forceinline__ int16_t quant_q60(u32 coef, int r, int32_t q) {
    const int32_t num = s32(coef) - (r == 0 ? 8192 : 0);
    const int32_t den = 8 * q;
    const int32_t mag = ((num < 0 ? -num : num) + (den >> 1)) / den;
    int32_t lv = num < 0 ? -mag : mag;
    lv = lv > 1023 ? 1023 : (lv < -1023 ? -1023 : lv);
    return (int16_t)(r == 0 ? lv + 128 : lv);
}

template <bool kDisplay, int kQuant>
__global__ void __launch_bounds__(kThreads)
encode_fused_kernel(const uint8_t *__restrict__ y,
                    const uint8_t *__restrict__ cb,
                    const uint8_t *__restrict__ cr,
                    const __grid_constant__ QuantTables tab,
                    const __grid_constant__ Planes geo,
                    int16_t *__restrict__ out, long long n) {
    const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (b >= n) return;
    const uint8_t kZigzag[64] = AMV_ZIGZAG;
    const int t = (int)(b % 6);
    const bool luma = t < 4;

    const long long mcu = b / 6;
    const long long f = mcu / geo.n_mcu, m = mcu % geo.n_mcu;
    const int mx = (int)(m % geo.mb_w), my = (int)(m / geo.mb_w);
    const int ph = luma ? geo.height : geo.height / 2;
    const int pw = luma ? geo.width : geo.width / 2;
    const int r0 = luma ? 16 * my + 8 * (t >> 1) : 8 * my;
    const int c0 = luma ? 16 * mx + 8 * (t & 1) : 8 * mx;
    const uint8_t *plane = (luma ? y : (t == 4 ? cb : cr)) + f * ph * pw;
    const bool whole = c0 + 8 <= pw && pw % 8 == 0;

    u32 blk[64];   // raster
#pragma unroll
    for (int r = 0; r < 8; r++) {
        const int rc = r0 + r;
        const int d = kDisplay ? ph - 1 - min(rc, ph - 1) : rc;
        const uint8_t *row = plane + (long long)d * pw;
        if (whole) {
            const uint2 px = *reinterpret_cast<const uint2 *>(row + c0);
#pragma unroll
            for (int c = 0; c < 4; c++) {
                blk[r * 8 + c] = (px.x >> (8 * c)) & 0xFF;
                blk[r * 8 + 4 + c] = (px.y >> (8 * c)) & 0xFF;
            }
        } else {
#pragma unroll
            for (int c = 0; c < 8; c++)
                blk[r * 8 + c] = row[min(c0 + c, pw - 1)];
        }
    }
    fdct(blk);

    __align__(16) int16_t res[64];
    if (kQuant == kQuantQ60) {
#pragma unroll
        for (int i = 0; i < 64; i++) {
            const int r = kZigzag[i];
            res[i] = quant_q60(blk[r], r, luma ? tab.q60_l[r] : tab.q60_c[r]);
        }
    } else {
        res[0] = quant_dc(blk[0]);
#pragma unroll
        for (int i = 1; i < 64; i++) {
            const int r = kDisplay ? kZigzag[i] : i;
            res[i] = quant_ac(blk[r], tab.qmat[r]);
        }
    }
    int4 *dst = reinterpret_cast<int4 *>(out + b * 64);
#pragma unroll
    for (int k = 0; k < 8; k++) dst[k] = reinterpret_cast<int4 *>(res)[k];
}

template <bool kDisplay, int kQuant>
void launch(const void *y, const void *cb, const void *cr,
            const QuantTables &tab, const Planes &geo, void *out,
            long long n, cudaStream_t s) {
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    encode_fused_kernel<kDisplay, kQuant><<<grid, kThreads, 0, s>>>(
        (const uint8_t *)y, (const uint8_t *)cb, (const uint8_t *)cr, tab,
        geo, (int16_t *)out, n);
}

}  // namespace

// display 0: coded planes -> raster levels (ffmpeg quantizer only);
// display 1: display planes -> zigzag levels, quant 0 ffmpeg, 1 q60
extern "C" int amv_encode_fused(const void *y, const void *cb, const void *cr,
                                const void *tables, const void *geom,
                                void *out, long long n, int display,
                                int quant, void *stream) {
    if (n > 0) {
        cudaStream_t s = (cudaStream_t)stream;
        const QuantTables tab = *(const QuantTables *)tables;
        const Planes geo = *(const Planes *)geom;
        if (!display)
            launch<false, kQuantFfmpeg>(y, cb, cr, tab, geo, out, n, s);
        else if (quant == kQuantQ60)
            launch<true, kQuantQ60>(y, cb, cr, tab, geo, out, n, s);
        else
            launch<true, kQuantFfmpeg>(y, cb, cr, tab, geo, out, n, s);
    }
    return (int)cudaGetLastError();
}
