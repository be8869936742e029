// Kernel F: AMV block encode, jfdctint FDCT + dct_quantize -> levels.
//
// Replaces the Pallas kernels
//   amv_tpu/kernels/transcode_layout_pallas.py:encode_mcu_layout (the
//     device encode chain's transform, slab layout; zigzag output), and
//   amv_tpu/kernels/fdct_pallas.py:_fdct_quant_soa (coefficient-major;
//     raster output, fdct_quantize's contract).
// Both compute the same arithmetic; here one kernel serves both, the
// output order a template parameter (a run-time index would push the block
// out of registers).
//
// Per block: pixels uint8 [64] raster -> ff_jpeg_fdct_islow -> levels
// int16 [64]: slot 0 the absolute DC (coef + 32) >> 6, every other slot
// coef * qmat with a sign-symmetric >> 22 and a clip to +-1023, in int32
// wraparound (qmat reaches 2^18 at qscale 1, so the products wrap).  The
// transform and the quantizer are dct.cuh's, the ones kernel T runs.
//
// What bounds it: 192 bytes of device memory traffic per block (64 in,
// 128 out) against about 800 integer operations, so memory bounds it if
// the accesses are whole lines.  Design: one thread per block, pixels and
// levels as 16-byte vectors, the block in registers, qmat in the kernel
// parameters, as kernels T and I.  Simple first: no shared-memory transpose
// to coalesce the rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dct.cuh"

namespace {

struct QuantTable {
    int32_t qmat[64];   // encoder reciprocal quantizer, raster
};

constexpr int kThreads = 192;

template <bool kZigzagOut>
__global__ void __launch_bounds__(kThreads)
fdct_quant_kernel(const uint8_t *__restrict__ pix,
                  const __grid_constant__ QuantTable tab,
                  int16_t *__restrict__ out, long long n) {
    const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (b >= n) return;
    const uint8_t kZigzag[64] = AMV_ZIGZAG;

    __align__(16) uint8_t px[64];
    const int4 *src = reinterpret_cast<const int4 *>(pix + b * 64);
#pragma unroll
    for (int k = 0; k < 4; k++) reinterpret_cast<int4 *>(px)[k] = src[k];
    u32 blk[64];
#pragma unroll
    for (int k = 0; k < 64; k++) blk[k] = px[k];
    fdct(blk);

    __align__(16) int16_t res[64];
    res[0] = quant_dc(blk[0]);
#pragma unroll
    for (int i = 1; i < 64; i++) {
        const int r = kZigzagOut ? kZigzag[i] : i;
        res[i] = quant_ac(blk[r], tab.qmat[r]);
    }
    int4 *dst = reinterpret_cast<int4 *>(out + b * 64);
#pragma unroll
    for (int k = 0; k < 8; k++) dst[k] = reinterpret_cast<int4 *>(res)[k];
}

}  // namespace

extern "C" int amv_fdct_quant(const void *pix, const void *qmat, void *out,
                              long long n, int zigzag_out, void *stream) {
    if (n > 0) {
        const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
        const QuantTable tab = *(const QuantTable *)qmat;
        if (zigzag_out)
            fdct_quant_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
                (const uint8_t *)pix, tab, (int16_t *)out, n);
        else
            fdct_quant_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
                (const uint8_t *)pix, tab, (int16_t *)out, n);
    }
    return (int)cudaGetLastError();
}
