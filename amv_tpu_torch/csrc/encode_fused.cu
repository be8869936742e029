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
//       with num's sign, a clip to +-1023, then +128 at DC.  The division
//       is a multiply by m = ceil(2^32 / den) and the high word, exact for
//       every numerator below 2^17 (|num| + den / 2 <= 41,348);
//       kernels/encode_fused.py:q60_reciprocals computes the multipliers.
// The transform is dct.cuh's fdct_1d, the same arithmetic as T, I, F, U.
//
// What bounds it: 64 bytes of pixels in and 128 of levels out a block
// against ~1,600 integer operations (the 16 1-D passes and 64 quantizer
// steps), so once the accesses are whole lines the instructions bound it:
// at 80 registers a thread (ptxas, ffmpeg and q60) an SM holds 24 warps.
// Design: a CTA takes 16 consecutive MCUs with 96 threads, so its output
// is one contiguous range.  (1) The CTA stages the MCUs' rows into the
// blocks' pixels in shared memory, neighbouring threads on neighbouring
// MCUs of one row: a luma row of an MCU as one 16-byte load, a chroma row
// as one 8-byte load, with the flip and the edge clamp in the addresses;
// a row that is not whole in its plane or not aligned is read byte by
// byte.  (2) Thread tid takes block tid, reads its pixels from shared
// memory into 64 registers and runs dct.cuh's register fdct on them.
// (3) It quantizes the 64 coefficients (zigzag or raster order) and
// stages the levels as eight int4 in shared memory, and (4) the CTA
// stores its levels as 16-byte vectors.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dct.cuh"

namespace {

struct QuantTables {
    int32_t qmat[64];      // encoder reciprocal quantizer, raster (ffmpeg)
    int32_t q60[2][64];    // Q60 luma and chroma tables, raster (q60)
    uint32_t q60_mul[2][64];   // ceil(2^32 / (8 Q60)), raster (q60)
};

// Frames of n_mcu MCUs, mb_w to a row; luma planes height x width a frame,
// chroma planes height / 2 x width / 2.  The wrapper keeps F n_mcu below
// 2^31, so MCU indices are 32-bit.
struct Planes {
    long long n_mcu, mb_w;
    int width, height;
};

enum { kQuantFfmpeg = 0, kQuantQ60 = 1 };

constexpr int kMcus = 16;                 // MCUs a CTA
constexpr int kThreads = 6 * kMcus;       // 96: a thread a block
constexpr int kPixStride = 80;            // bytes a block's pixels, padded
constexpr int kLvStride = 72;             // int16 a block's levels, padded
constexpr int kLumaRows = 16 * kMcus;     // luma row loads (16 bytes)
constexpr int kRows = kLumaRows + 2 * 8 * kMcus;  // + chroma (8 bytes)

// amv_tpu encode_transform's q60 rule for the coefficient at raster r
__device__ __forceinline__ int16_t quant_q60(u32 coef, int r, int32_t half,
                                             uint32_t mul) {
    const int32_t num = s32(coef) - (r == 0 ? 8192 : 0);
    const int32_t mag = (int32_t)__umulhi(
        (uint32_t)((num < 0 ? -num : num) + half), mul);
    int32_t lv = num < 0 ? -mag : mag;
    lv = lv > 1023 ? 1023 : (lv < -1023 ? -1023 : lv);
    return (int16_t)(r == 0 ? lv + 128 : lv);
}

// bytes [c0, c0 + n) of a row, the column clamped to the plane (n 8 or 16)
template <int n>
__device__ __forceinline__ void load_row(const uint8_t *row, int c0, int pw,
                                         uint32_t (&w)[n / 4]) {
    const uintptr_t at = (uintptr_t)(row + c0);
    if (c0 + n <= pw && at % n == 0) {
        if constexpr (n == 16) {
            const uint4 v = *reinterpret_cast<const uint4 *>(row + c0);
            w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
        } else {
            const uint2 v = *reinterpret_cast<const uint2 *>(row + c0);
            w[0] = v.x; w[1] = v.y;
        }
    } else {
#pragma unroll
        for (int k = 0; k < n / 4; k++) {
            w[k] = 0;
#pragma unroll
            for (int q = 0; q < 4; q++)
                w[k] |= (u32)row[min(c0 + 4 * k + q, pw - 1)] << (8 * q);
        }
    }
}

template <bool kDisplay, int kQuant>
__global__ void __launch_bounds__(kThreads)
encode_fused_kernel(const uint8_t *__restrict__ y,
                    const uint8_t *__restrict__ cb,
                    const uint8_t *__restrict__ cr,
                    const __grid_constant__ QuantTables tab,
                    const __grid_constant__ Planes geo,
                    int16_t *__restrict__ out, long long n_mcus) {
    __shared__ __align__(16) uint8_t pix[kThreads * kPixStride];
    __shared__ __align__(16) int16_t lv[kThreads * kLvStride];
    __shared__ int mcu_f[kMcus], mcu_x[kMcus], mcu_y[kMcus];
    const int tid = threadIdx.x;
    const long long m0 = (long long)blockIdx.x * kMcus;
    const int nm = (int)min((long long)kMcus, n_mcus - m0);
    if (tid < nm) {            // the MCUs' frames and positions
        const unsigned gm = (unsigned)(m0 + tid), nmcu = (unsigned)geo.n_mcu;
        const unsigned m = gm % nmcu, mbw = (unsigned)geo.mb_w;
        mcu_f[tid] = (int)(gm / nmcu);
        mcu_x[tid] = (int)(m % mbw);
        mcu_y[tid] = (int)(m / mbw);
    }
    __syncthreads();

    // (1) the MCUs' rows into the blocks' pixels: a luma row of an MCU is
    // 16 bytes (two blocks), a chroma row 8; neighbouring threads take
    // neighbouring MCUs of one row
    for (int task = tid; task < kRows; task += kThreads) {
        const bool luma = task < kLumaRows;
        const int u = luma ? task : task - kLumaRows;
        const int mcu = u % kMcus;
        if (mcu >= nm) continue;
        const int comp = luma ? 0 : 1 + u / (8 * kMcus);
        const int r = luma ? u / kMcus : (u / kMcus) & 7;
        const long long f = mcu_f[mcu];
        const int mx = mcu_x[mcu], my = mcu_y[mcu];
        const int ph = luma ? geo.height : geo.height / 2;
        const int pw = luma ? geo.width : geo.width / 2;
        const int rc = luma ? 16 * my + r : 8 * my + r;
        const int d = kDisplay ? ph - 1 - min(rc, ph - 1) : rc;
        const uint8_t *plane = luma ? y : (comp == 1 ? cb : cr);
        const uint8_t *row = plane + (f * ph + d) * (long long)pw;
        uint8_t *dst = pix + (mcu * 6) * kPixStride;
        if (luma) {
            uint32_t w[4];
            load_row<16>(row, 16 * mx, pw, w);
            const int t = (r >> 3) * 2;
            *reinterpret_cast<uint2 *>(dst + t * kPixStride + (r & 7) * 8) =
                make_uint2(w[0], w[1]);
            *reinterpret_cast<uint2 *>(dst + (t + 1) * kPixStride +
                                       (r & 7) * 8) = make_uint2(w[2], w[3]);
        } else {
            uint32_t w[2];
            load_row<8>(row, 8 * mx, pw, w);
            *reinterpret_cast<uint2 *>(dst + (3 + comp) * kPixStride +
                                       r * 8) = make_uint2(w[0], w[1]);
        }
    }
    __syncthreads();

    // (2) thread tid: block tid, in registers, as dct.cuh's fdct
    const uint8_t kZz[64] = AMV_ZIGZAG;
    const int t6 = tid % 6;
    const bool luma = t6 < 4;
    u32 blk[64];   // raster
#pragma unroll
    for (int q = 0; q < 4; q++) {
        const uint4 v = *reinterpret_cast<const uint4 *>(
            pix + tid * kPixStride + 16 * q);
        const u32 w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; k++)
#pragma unroll
            for (int c = 0; c < 4; c++)
                blk[16 * q + 4 * k + c] = (w[k] >> (8 * c)) & 0xFF;
    }
    fdct(blk);

    // (3) the quantizer, into the levels staged in shared memory
    __align__(16) int16_t res[64];
    if (kQuant == kQuantQ60) {
        const int cq = luma ? 0 : 1;
#pragma unroll
        for (int i = 0; i < 64; i++) {
            const int r = kZz[i];
            res[i] = quant_q60(blk[r], r, 4 * tab.q60[cq][r],
                               tab.q60_mul[cq][r]);
        }
    } else {
        res[0] = quant_dc(blk[0]);
#pragma unroll
        for (int i = 1; i < 64; i++) {
            const int r = kDisplay ? kZz[i] : i;
            res[i] = quant_ac(blk[r], tab.qmat[r]);
        }
    }
    int4 *row = reinterpret_cast<int4 *>(lv + tid * kLvStride);
#pragma unroll
    for (int k = 0; k < 8; k++) row[k] = reinterpret_cast<const int4 *>(res)[k];
    __syncthreads();

    // (4) the CTA's levels, one contiguous range, as 16-byte vectors
    int4 *dst = reinterpret_cast<int4 *>(out + m0 * 6 * 64);
    for (int k = tid; k < nm * 6 * 8; k += kThreads)
        dst[k] = *reinterpret_cast<const int4 *>(lv + (k >> 3) * kLvStride +
                                                 (k & 7) * 8);
}

template <bool kDisplay, int kQuant>
void launch(const void *y, const void *cb, const void *cr,
            const QuantTables &tab, const Planes &geo, void *out,
            long long n_mcus, cudaStream_t s) {
    const unsigned grid = (unsigned)((n_mcus + kMcus - 1) / kMcus);
    encode_fused_kernel<kDisplay, kQuant><<<grid, kThreads, 0, s>>>(
        (const uint8_t *)y, (const uint8_t *)cb, (const uint8_t *)cr, tab,
        geo, (int16_t *)out, n_mcus);
}

}  // namespace

// n: blocks (6 per MCU).  display 0: coded planes -> raster levels (ffmpeg
// quantizer only); display 1: display planes -> zigzag levels, quant 0
// ffmpeg, 1 q60
extern "C" int amv_encode_fused(const void *y, const void *cb, const void *cr,
                                const void *tables, const void *geom,
                                void *out, long long n, int display,
                                int quant, void *stream) {
    if (n > 0) {
        cudaStream_t s = (cudaStream_t)stream;
        const QuantTables tab = *(const QuantTables *)tables;
        const Planes geo = *(const Planes *)geom;
        const long long n_mcus = n / 6;
        if (!display)
            launch<false, kQuantFfmpeg>(y, cb, cr, tab, geo, out, n_mcus, s);
        else if (quant == kQuantQ60)
            launch<true, kQuantQ60>(y, cb, cr, tab, geo, out, n_mcus, s);
        else
            launch<true, kQuantFfmpeg>(y, cb, cr, tab, geo, out, n_mcus, s);
    }
    return (int)cudaGetLastError();
}
