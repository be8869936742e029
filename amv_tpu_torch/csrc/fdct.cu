// Kernel F: AMV block encode, jfdctint FDCT + dct_quantize -> levels.
//
// Replaces the Pallas kernels
//   amv_tpu/kernels/transcode_layout_pallas.py:encode_mcu_layout (the
//     device encode chain's transform, slab layout; zigzag output), and
//   amv_tpu/kernels/fdct_pallas.py:_fdct_quant_soa (coefficient-major;
//     raster output, fdct_quantize's contract).
// Both compute the same arithmetic; here one kernel serves both, the
// output order a table that the C entry builds (the two differ only in it).
//
// Per block: pixels uint8 [64] raster -> ff_jpeg_fdct_islow -> levels
// int16 [64]: slot 0 the absolute DC (coef + 32) >> 6, every other slot
// coef * qmat with a sign-symmetric >> 22 and a clip to +-1023, in int32
// wraparound (qmat reaches 2^18 at qscale 1, so the products wrap).  The
// 1-D passes and the quantizer are dct.cuh's, the ones kernels T and V run.
//
// What bounds it on the H100: 192 bytes of device memory traffic per
// block (64 in, 128 out) against about 1,600 integer operations, so the
// bytes bind it if the accesses are whole lines.  Design: eight threads a
// block, each 8-lane group of a warp one block, so that a warp reads 4
// blocks' 256 contiguous bytes (a row of 8 bytes a thread) and writes
// their 512 contiguous bytes (16 bytes a thread).  Thread r runs the row
// pass on row r, the block goes through a tile in shared memory (rows of 9
// words: the row and column accesses of a warp fall in 32 distinct banks),
// thread r runs the column pass on column r, and then quantizes output
// slots 8r .. 8r + 7, reading each one's coefficient from the tile and its
// qmat entry from registers (both from the C entry's table of the output
// order, loaded once a thread).  Only the block's own 8 threads touch its
// tile, so a __syncwarp orders each step.  The CTAs stay resident and
// stride over the blocks, 32 at a time, each thread keeping the rows of its
// next two steps in flight while it computes this one; the levels are
// stored with the streaming hint (__stcs).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dct.cuh"

namespace {

constexpr int kBlocks = 32;             // 8x8 blocks a CTA a step
constexpr int kThreads = 8 * kBlocks;   // a thread a row, then a column
constexpr int kRow = 9;                 // words a row of a block's tile
constexpr int kTile = 8 * kRow;

// Output slot s (s = 8r + m, thread r's m-th value) -> the qmat entry of
// its raster coefficient, and that coefficient's word in a block's tile.
struct SlotTable {
    int32_t q[64];
    int32_t at[64];
};

// Row r of block b (8 bytes), or zeros past the last block
__device__ __forceinline__ uint2 load_row(const uint8_t *__restrict__ pix,
                                          long long b, int r, long long n) {
    return b < n ? __ldg(reinterpret_cast<const uint2 *>(pix + b * 64 + 8 * r))
                 : make_uint2(0, 0);
}

__device__ __forceinline__ u32 pack16(int16_t lo, int16_t hi) {
    return (u32)(uint16_t)lo | (u32)(uint16_t)hi << 16;
}

__global__ void __launch_bounds__(kThreads)
fdct_quant_kernel(const uint8_t *__restrict__ pix,
                  const __grid_constant__ SlotTable tab,
                  int16_t *__restrict__ out, long long n) {
    __shared__ u32 tiles[kBlocks * kTile];
    const int lb = threadIdx.x >> 3, r = threadIdx.x & 7;
    u32 *t = tiles + lb * kTile;
    int32_t q[8];
    int at[8];
#pragma unroll
    for (int m = 0; m < 8; m++) {
        q[m] = tab.q[8 * r + m];
        at[m] = tab.at[8 * r + m];
    }
    const long long steps = (n + kBlocks - 1) / kBlocks;
    const long long stride = (long long)gridDim.x * kBlocks;
    const long long b0 = blockIdx.x * (long long)kBlocks + lb;
    // the rows of the next two steps, in flight while this one is computed
    uint2 next = load_row(pix, b0, r, n);
    uint2 next2 = load_row(pix, b0 + stride, r, n);
    for (long long g = blockIdx.x; g < steps; g += gridDim.x) {
        const long long b = g * kBlocks + lb;
        const uint2 v = next;
        next = next2;
        if (g + 2 * gridDim.x < steps)
            next2 = load_row(pix, b + 2 * stride, r, n);
        u32 c[8];
#pragma unroll
        for (int k = 0; k < 4; k++) {
            c[k] = (v.x >> (8 * k)) & 0xFFu;
            c[4 + k] = (v.y >> (8 * k)) & 0xFFu;
        }
        fdct_1d(c, 0, 1, true);                 // row r
#pragma unroll
        for (int k = 0; k < 8; k++) t[r * kRow + k] = c[k];
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 8; i++) c[i] = t[i * kRow + r];
        fdct_1d(c, 0, 1, false);                // column r
#pragma unroll
        for (int i = 0; i < 8; i++) t[i * kRow + r] = c[i];
        __syncwarp();
        int16_t lv[8];
#pragma unroll
        for (int m = 0; m < 8; m++) lv[m] = quant_ac(t[at[m]], q[m]);
        if (r == 0) lv[0] = quant_dc(t[0]);     // slot 0: the DC
        if (b < n) {
            const int4 w = make_int4(
                (int)pack16(lv[0], lv[1]), (int)pack16(lv[2], lv[3]),
                (int)pack16(lv[4], lv[5]), (int)pack16(lv[6], lv[7]));
            // streamed: nothing reads the levels back here
            __stcs(reinterpret_cast<int4 *>(out + b * 64 + 8 * r), w);
        }
        __syncwarp();                           // the tile is free again
    }
}

}  // namespace

extern "C" int amv_fdct_quant(const void *pix, const void *qmat, void *out,
                              long long n, int zigzag_out, void *stream) {
    if (n > 0) {
        const uint8_t kZigzag[64] = AMV_ZIGZAG;
        const int32_t *qm = (const int32_t *)qmat;
        SlotTable tab;
        for (int s = 0; s < 64; s++) {
            const int src = zigzag_out ? kZigzag[s] : s;
            tab.q[s] = qm[src];
            tab.at[s] = (src >> 3) * kRow + (src & 7);
        }
        int dev = 0, sms = 1, per_sm = 1;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, fdct_quant_kernel, kThreads, 0);
        const long long steps = (n + kBlocks - 1) / kBlocks;
        const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
        fdct_quant_kernel<<<(unsigned)(steps < cap ? steps : cap), kThreads,
                            0, (cudaStream_t)stream>>>(
            (const uint8_t *)pix, tab, (int16_t *)out, n);
    }
    return (int)cudaGetLastError();
}
