// Kernel U: AMV decode transform straight into the planes: Q60 dequant +
// simple_idct + MCU assembly, and on the decode path the AMV flip, the crop
// and the frame un-sort in the same store.
//
// Replaces the Pallas kernel
//   amv_tpu/kernels/decode_fused_pallas.py:decode_fused (levels -> coded
//     planes; an interpret-mode prototype that Mosaic refused for its
//     rank-6 assembly reshapes).
// One kernel, two entries, the form a template parameter (kMode):
//   * kModeCoded (decode_fused's contract): raster levels int16 [N, 64]
//     (slot 0 ignored) and the resolved DC -> coded, un-flipped planes
//     y [F, 16 mb_h, 16 mb_w], cb and cr [F, 8 mb_h, 8 mb_w];
//   * kModeDisplay (the decode path): zigzag levels as kernel D leaves them
//     -> display planes y [F, H, W], cb and cr [F, H/2, W/2]: coded row r
//     lands on display row h - 1 - r of its plane (h the plane's height),
//     rows >= h and columns >= w are dropped (amv_tpu codecs/amv_video.py
//     assemble_planes, entropy.c amv_ref_decode_frame), and batch frame f
//     lands on frame dst[f] (the inverse of the decoder's length sort; a
//     frame whose dst lies outside [0, F) is skipped).
// Per block (luma iff n % 6 < 4): wrap16(level * Q60[r]) in raster order,
// slot 0 := wrap16(dc), then dct.cuh's idct_put, the one kernels T and I
// run, so the three decode to the same pixels.
//
// What bounds it: 128 bytes of levels and 4 of DC in, 64 of pixels out a
// block, against ~1,600 integer operations: memory, if the accesses were
// whole lines.  Design, simple first: one thread per block, as kernel I;
// the 128-byte load as 16-byte vectors; each of the 8 pixel rows stored as
// one 8-byte vector at the plane's stride where the row lies whole in a
// plane whose width is a multiple of 8, else byte by byte.  Coalescing the
// stores through shared memory is later work.  The intermediate pixel
// tensor, the un-sort gather and the assembly's permute/flip copies of the
// I route are gone.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dct.cuh"

namespace {

struct DequantTables {
    int32_t qm_l[64];   // Q60 luma dequant, raster
    int32_t qm_c[64];   // Q60 chroma dequant, raster
};

// F = frames of n_mcu MCUs, mb_w to a row; luma planes height x width a
// frame, chroma planes height / 2 x width / 2.
struct Planes {
    long long n_mcu, mb_w, frames;
    int width, height;
};

enum { kModeCoded = 0, kModeDisplay = 1 };

constexpr int kThreads = 192;

template <int kMode>
__global__ void __launch_bounds__(kThreads)
decode_fused_kernel(const int16_t *__restrict__ in,
                    const int32_t *__restrict__ dc,
                    const __grid_constant__ DequantTables tab,
                    const __grid_constant__ Planes geo,
                    const long long *__restrict__ dst,
                    uint8_t *__restrict__ y, uint8_t *__restrict__ cb,
                    uint8_t *__restrict__ cr, long long n) {
    const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (b >= n) return;
    const uint8_t kZigzag[64] = AMV_ZIGZAG;
    const int t = (int)(b % 6);
    const bool luma = t < 4;

    __align__(16) int16_t v[64];
    const int4 *src = reinterpret_cast<const int4 *>(in + b * 64);
#pragma unroll
    for (int k = 0; k < 8; k++) reinterpret_cast<int4 *>(v)[k] = src[k];

    u32 blk[64];   // raster
    blk[0] = wrap16((u32)dc[b]);
#pragma unroll
    for (int i = 1; i < 64; i++) {
        const int r = kMode == kModeDisplay ? kZigzag[i] : i;
        const int32_t q = luma ? tab.qm_l[r] : tab.qm_c[r];
        blk[r] = wrap16((u32)(int32_t)v[i] * (u32)q);
    }
    idct_put(blk);

    // where the block lies: frame, MCU, and its rows and columns in the
    // coded plane of its component
    const long long mcu = b / 6;
    const long long f = mcu / geo.n_mcu, m = mcu % geo.n_mcu;
    const int mx = (int)(m % geo.mb_w), my = (int)(m / geo.mb_w);
    const int ph = luma ? geo.height : geo.height / 2;
    const int pw = luma ? geo.width : geo.width / 2;
    const int r0 = luma ? 16 * my + 8 * (t >> 1) : 8 * my;
    const int c0 = luma ? 16 * mx + 8 * (t & 1) : 8 * mx;
    if (c0 >= pw) return;
    const long long fo = kMode == kModeDisplay && dst != nullptr ? dst[f] : f;
    if (fo < 0 || fo >= geo.frames) return;
    uint8_t *plane = (luma ? y : (t == 4 ? cb : cr)) + fo * ph * pw;
    const bool whole = pw % 8 == 0;   // then c0 + 8 <= pw too
#pragma unroll
    for (int r = 0; r < 8; r++) {
        const int rc = r0 + r;
        if (rc < ph) {
            const int d = kMode == kModeDisplay ? ph - 1 - rc : rc;
            uint8_t *row = plane + (long long)d * pw + c0;
            if (whole) {
                uint2 px;
                px.x = blk[r * 8 + 0] | blk[r * 8 + 1] << 8 |
                       blk[r * 8 + 2] << 16 | blk[r * 8 + 3] << 24;
                px.y = blk[r * 8 + 4] | blk[r * 8 + 5] << 8 |
                       blk[r * 8 + 6] << 16 | blk[r * 8 + 7] << 24;
                *reinterpret_cast<uint2 *>(row) = px;
            } else {
#pragma unroll
                for (int c = 0; c < 8; c++)
                    if (c0 + c < pw) row[c] = (uint8_t)blk[r * 8 + c];
            }
        }
    }
}

}  // namespace

// mode 0: raster levels -> coded planes; 1: zigzag levels -> display
// planes, frame f to dst[f] (dst null: to f)
extern "C" int amv_decode_fused(const void *in, const void *dc,
                                const void *tables, const void *geom,
                                const void *dst, void *y, void *cb, void *cr,
                                long long n, int mode, void *stream) {
    if (n > 0) {
        const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
        cudaStream_t s = (cudaStream_t)stream;
        const DequantTables tab = *(const DequantTables *)tables;
        const Planes geo = *(const Planes *)geom;
        if (mode == kModeDisplay)
            decode_fused_kernel<kModeDisplay><<<grid, kThreads, 0, s>>>(
                (const int16_t *)in, (const int32_t *)dc, tab, geo,
                (const long long *)dst, (uint8_t *)y, (uint8_t *)cb,
                (uint8_t *)cr, n);
        else
            decode_fused_kernel<kModeCoded><<<grid, kThreads, 0, s>>>(
                (const int16_t *)in, (const int32_t *)dc, tab, geo, nullptr,
                (uint8_t *)y, (uint8_t *)cb, (uint8_t *)cr, n);
    }
    return (int)cudaGetLastError();
}
