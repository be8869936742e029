// Kernel I: AMV block decode, Q60 dequant + simple_idct -> pixels.
//
// Replaces the Pallas kernels
//   amv_tpu/kernels/transcode_layout_pallas.py:decode_mcu_layout (the
//     device decode chain's transform, slab layout), and
//   amv_tpu/kernels/idct_pallas.py:idct_put_soa (coefficient-major
//     simple_idct of already dequantized blocks).
// Both compute the same IDCT; here one kernel serves both:
//   * with `dc` given: zigzag levels int16 [N, 64] (slot 0 ignored) are
//     dequantized with the Q60 table of their component (block n is luma
//     iff n % 6 < 4), wrap16(level * q), and slot 0 takes wrap16(dc[n]),
//     the resolved DC (+1024 bias) -- mjpegdec decode_block semantics;
//   * with `dc` null: the int16 [N, 64] input is raster coefficients as
//     they are (idct_put's contract).
// Output: pixels uint8 [N, 64], raster.  The IDCT is dct.cuh's, the one
// kernel T runs, so the two decode to the same pixels.
//
// What bounds it: 192 bytes of device memory traffic per block (128 in,
// 64 out, 4 DC) against about 700 integer operations, so at the 3.35 TB/s
// the card moves, memory bounds it if the accesses are whole lines.
// Design: one thread per block holds its 64 coefficients in registers
// (straight-line code over them), loads its 128 bytes and stores its 64 as
// 16-byte vectors, as kernel T does; the dequant tables ride in the kernel
// parameters.  Simple first: neighbouring threads touch neighbouring
// 128-byte rows, so a warp's vector load spans 32 lines (no shared-memory
// transpose yet).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dct.cuh"

namespace {

struct DequantTables {
    int32_t qm_l[64];   // Q60 luma dequant, raster
    int32_t qm_c[64];   // Q60 chroma dequant, raster
};

constexpr int kThreads = 192;

__global__ void __launch_bounds__(kThreads)
idct_blocks_kernel(const int16_t *__restrict__ in,
                   const int32_t *__restrict__ dc,
                   const __grid_constant__ DequantTables tab,
                   uint8_t *__restrict__ pix, long long n) {
    const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (b >= n) return;
    const uint8_t kZigzag[64] = AMV_ZIGZAG;

    __align__(16) int16_t v[64];
    const int4 *src = reinterpret_cast<const int4 *>(in + b * 64);
#pragma unroll
    for (int k = 0; k < 8; k++) reinterpret_cast<int4 *>(v)[k] = src[k];

    u32 blk[64];   // raster
    if (dc != nullptr) {
        const bool luma = b % 6 < 4;
        blk[0] = wrap16((u32)dc[b]);
#pragma unroll
        for (int i = 1; i < 64; i++) {
            const int r = kZigzag[i];
            const int32_t q = luma ? tab.qm_l[r] : tab.qm_c[r];
            blk[r] = wrap16((u32)(int32_t)v[i] * (u32)q);
        }
    } else {
#pragma unroll
        for (int k = 0; k < 64; k++) blk[k] = (u32)(int32_t)v[k];
    }
    idct_put(blk);

    __align__(16) uint8_t px[64];
#pragma unroll
    for (int k = 0; k < 64; k++) px[k] = (uint8_t)blk[k];
    int4 *dst = reinterpret_cast<int4 *>(pix + b * 64);
#pragma unroll
    for (int k = 0; k < 4; k++) dst[k] = reinterpret_cast<int4 *>(px)[k];
}

}  // namespace

extern "C" int amv_idct_blocks(const void *in, const void *dc,
                               const void *tables, void *pix, long long n,
                               void *stream) {
    if (n > 0) {
        const long long grid = (n + kThreads - 1) / kThreads;
        idct_blocks_kernel<<<(unsigned)grid, kThreads, 0,
                             (cudaStream_t)stream>>>(
            (const int16_t *)in, (const int32_t *)dc,
            *(const DequantTables *)tables, (uint8_t *)pix, n);
    }
    return (int)cudaGetLastError();
}
