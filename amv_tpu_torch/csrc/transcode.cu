// Kernel T: fused AMV block transcode (dequant + IDCT + FDCT + requant).
//
// Replaces the Pallas kernels
//   amv_tpu/kernels/transcode_layout_pallas.py:transcode_mcu_layout (slab
//     layout, the complete chain's transform), and
//   amv_tpu/kernels/transcode_pallas.py:transcode_zz (coefficient-major,
//     also emits the decoded pixels; the host-entropy route).
//   amv_tpu/kernels/transcode_pallas.py:transcode_zz_wrap (transcode_zz over
//     a logically tiled input: output block s * nm_full + m reads base block
//     s * nm_base + m % nm_base of the [64, 8, nm] view), and
//   amv_tpu/kernels/transcode_pallas.py:transcode_soa and transcode_soa3
//     (bit-identical to each other: raster blocks already dequantized, DC
//     included, in; pixels and raster levels out).
// All compute the same arithmetic; here one kernel serves all, the input
// and output forms a template parameter (kMode) and the pixel store
// another (kPix), so that each instance keeps its indices compile-time.
//
// Per 8x8 block n (luma iff n % 6 < 4, the AMV MCU order 4Y + Cb + Cr):
//   * Q60 dequant of zigzag levels, _wrap16(level * q), slot 0 replaced by
//     _wrap16(resolved DC) (transcode_layout_pallas.py:52-58);
//   * simple_idct: row pass with the DC-only shortcut _wrap16(c0 << 3),
//     >> 11 and int16 store; column pass >> 20 and the [0, 255] clamp
//     (transcode_pallas.py:37-78, entropy.c:864-923);
//   * jfdctint FDCT, CONST_BITS 13, PASS1_BITS 4, _wrap16 after every
//     output (fdct_pallas.py:35-66, entropy.c:1004);
//   * dct_quantize: DC (coef + 32) >> 6; AC coef * qmat with a
//     sign-symmetric >> 22, whose clip to +-1023 never acts
//     (entropy.c:1096-1122).
// All arithmetic is int32 two's-complement with wraparound, as XLA computes
// it (coef * qmat exceeds int32 at qscale 1 and 2, where qmat reaches 2^18
// and 2^17); the transforms and the quantizer live in dct.cuh, shared with
// kernels I, F, U and V.
//
// Geometries that are not whole MCUs (160x120 has half an MCU row of pad)
// take the encoder's edge replication between the IDCT and the FDCT, so
// that the result is the two-stage decode -> crop -> re-encode of the C
// reference and of amv_tpu's decode_transform + encode_transform.
//
// What bounds it: 260 bytes of device memory a block (128 in, 128 out, 4
// of DC; 64 more of pixels in the pixel entry) and at most ~3,500 SASS
// instructions a block (the static count, which holds both sides of the
// IDCT's DC-only branch and the edge replication), one thread a block,
// most of them integer ALU and multiply-add operations: at the
// transcode's 2.3 M blocks the bytes take 0.18 ms and full issue of the
// static count at most 0.24 ms, so the design keeps the memory system
// streaming and cuts instructions (the edge replication's address math,
// the quantizer's clip that never acts, the dequant's sign extensions).
// Design: a CTA holds 32 whole MCUs (192 blocks, 192 threads), so the edge
// replication stays inside it.  Its levels are one contiguous span of
// 24 KB: the CTA copies it into shared memory by 16-byte cp.async
// (consecutive threads, consecutive vectors), each thread reads its
// block's 64 levels from there, and writes its 64 re-quantized levels back
// to the same place, which the CTA stores as coalesced 16-byte vectors; the
// decoded pixels leave the same way from a 12 KB tile in the pixel entry.
// Warp w takes block w of the MCU order (Y0..Y3, Cb, Cr) of the 32 MCUs,
// lane l MCU l, so the luma/chroma choice of the dequant table is uniform
// per warp and each path multiplies by its own table; a block's 16-byte
// vectors sit at a slot XOR-swizzled by its MCU, so that eight lanes' loads
// of one vector hit eight different bank groups.  Index math is 32-bit
// (the wrapper checks n < 2^31): per thread no division but by constants,
// save the frame geometry in CTAs of pictures with pad pixels.  Only CTAs
// that hold a block needing the edge replication stage the pixels for it
// and wait at the barrier that it needs (a uniform branch).  Bounded to
// three CTAs an SM (18 warps, at most 112 registers a thread): the
// zigzag and dequantized instances fit without spills; at four CTAs (80
// registers) the zigzag ones spill around the dequant and the IDCT.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dct.cuh"

namespace {

struct Tables {
    int32_t qmat[64];   // encoder reciprocal quantizer, raster
    int32_t qm_l[64];   // Q60 luma dequant, raster
    int32_t qm_c[64];   // Q60 chroma dequant, raster
};

// Frame geometry for the encoder's edge replication: MCUs per row and per
// frame, picture width and height, and whether the frames have pad pixels
// (width < 16 mb_w or height < 16 n_mcu / mb_w; without, every decoded
// pixel is kept, as the JAX fused transform does).  nm_full and nm_base:
// the wrap mode's [64, 8, nm] views of the output and of the base levels.
struct Geom {
    int mb_w, n_mcu, width, height, nm_full, nm_base, pad;
};

// kMode: zigzag levels + DC in, zigzag levels out (the layout and pixel
// entries); the same over wrapped base levels; dequantized raster blocks
// in, raster levels out, no edge replication (the dequantized entry).
enum { kModeZigzag = 0, kModeWrap = 1, kModeDeq = 2 };

constexpr int kMcus = 32;
constexpr int kThreads = 6 * kMcus;   // = the CTA's blocks

// thread t = r * 32 + m works on block j = 6 m + r of the CTA (MCU m, block
// r of its 4Y + Cb + Cr); its slot in the shared tiles is t.  Level vector
// k of slot t sits at t * 8 + (k ^ (m & 7)), pixel vector k at t * 4 +
// (k ^ ((m >> 1) & 3)).
__device__ __forceinline__ int lv_vec(int slot, int k) {
    return slot * 8 + (k ^ (slot & 7));
}
__device__ __forceinline__ int px_vec(int slot, int k) {
    return slot * 4 + (k ^ ((slot >> 1) & 3));
}

// the block's levels from its shared slot into raster coefficients:
// dequantized by table qm, slot 0 (the DC's) left to the caller (zigzag
// modes), or as they are (dequantized mode).  The int16 level in half e & 1
// of a word, moved to the top 16 bits and multiplied, is the product
// shifted left by 16, so an arithmetic shift back gives _wrap16(level * q)
// at once.
template <int kMode>
__device__ __forceinline__ void load_block(u32 *blk, const int4 *s_lv,
                                           int slot,
                                           const int32_t (&qm)[64]) {
    const uint8_t kZigzag[64] = AMV_ZIGZAG;
#pragma unroll
    for (int k = 0; k < 8; k++) {
        const int4 v = s_lv[lv_vec(slot, k)];
        const u32 w[4] = {(u32)v.x, (u32)v.y, (u32)v.z, (u32)v.w};
#pragma unroll
        for (int e = 0; e < 8; e++) {
            const int i = 8 * k + e;
            const u32 top = e & 1 ? w[e / 2] & 0xffff0000u : w[e / 2] << 16;
            if (kMode == kModeDeq)
                blk[i] = sra(top, 16);
            else if (i > 0)
                blk[kZigzag[i]] = sra(top * (u32)qm[kZigzag[i]], 16);
        }
    }
}

// the rows hr and columns wr of the picture in the component area of
// block r (4Y + Cb + Cr) of the CTA's MCU m (at most 16 or 8), and whether
// the block reaches past them (then it takes the edge replication)
__device__ __forceinline__ bool edge_area(const Geom &geo, int m, int r,
                                          int &hr, int &wr) {
    const int mf = (int)((blockIdx.x * kMcus + m) % (unsigned)geo.n_mcu);
    const bool luma = r < 4;
    const int my = mf / geo.mb_w, mx = mf - my * geo.mb_w;
    const int area = luma ? 16 : 8;
    hr = min(area, (luma ? geo.height : geo.height / 2) - area * my);
    wr = min(area, (luma ? geo.width : geo.width / 2) - area * mx);
    const int r0 = luma ? 8 * (r >> 1) : 0, c0 = luma ? 8 * (r & 1) : 0;
    return r0 + 8 > hr || c0 + 8 > wr;
}

template <int kMode, bool kPix>
__global__ void __launch_bounds__(kThreads, 3)
transcode_blocks_kernel(const int16_t *__restrict__ lv,
                        const int32_t *__restrict__ dc,
                        const __grid_constant__ Tables tab,
                        const __grid_constant__ Geom geo,
                        int16_t *__restrict__ out,
                        uint8_t *__restrict__ pix, int n) {
    __shared__ int4 s_lv[kThreads * 8];     // levels in, then levels out
    __shared__ int4 s_px[kThreads * 4];     // decoded pixels
    __shared__ int s_dc[kThreads];
    __shared__ int s_src[kModeWrap == kMode ? kThreads : 1];
    const int t = threadIdx.x;
    const int m = t & 31, r = t >> 5;
    const int j = 6 * m + r;
    const int b0 = blockIdx.x * kThreads;
    const int nb = min(kThreads, n - b0);
    const bool live = j < nb;
    const bool luma = r < 4;

    if (kMode == kModeWrap) {       // the base block each block reads
        const int b = b0 + t;
        s_src[t] = b / geo.nm_full * geo.nm_base +
                   b % geo.nm_full % geo.nm_base;
        __syncthreads();
    }
    // the CTA's levels into shared memory: thread t copies vector t & 7 of
    // blocks a + 24 i (a = t >> 3), i.e. of MCU m0 + 4 i, block ra
    {
        const int a = t >> 3, k = t & 7;
        const int m0 = a / 6, ra = a - 6 * m0;
        const int4 *src = reinterpret_cast<const int4 *>(lv);
#pragma unroll
        for (int i = 0; i < 8; i++) {
            const int jj = a + 24 * i;
            if (jj < nb) {
                const long long sb = kMode == kModeWrap ? s_src[jj] : b0 + jj;
                __pipeline_memcpy_async(&s_lv[lv_vec(32 * ra + m0 + 4 * i, k)],
                                        src + sb * 8 + k, 16);
            }
        }
        __pipeline_commit();
    }
    if (kMode != kModeDeq && t < nb) s_dc[t] = dc[b0 + t];

    __pipeline_wait_prior(0);
    __syncthreads();

    u32 blk[64];   // raster
    if (live) {
        if (luma)
            load_block<kMode>(blk, s_lv, t, tab.qm_l);
        else
            load_block<kMode>(blk, s_lv, t, tab.qm_c);
        if (kMode != kModeDeq) blk[0] = wrap16((u32)s_dc[j]);
        idct_put(blk);
    }
    // does this block take the edge replication?  (pictures with pad
    // pixels only: the last MCU row or column; decided here, not kept
    // across the IDCT, whose registers are the kernel's peak)
    int hr, wr;
    const bool edge = kMode == kModeZigzag && geo.pad && live &&
                      edge_area(geo, m, r, hr, wr);
    const bool any_edge =
        kMode == kModeZigzag && geo.pad && __syncthreads_or(edge);
    if (kPix || any_edge) {
        if (live) {
            uint32_t w[16];
#pragma unroll
            for (int i = 0; i < 16; i++)
                w[i] = blk[4 * i] | blk[4 * i + 1] << 8 |
                       blk[4 * i + 2] << 16 | blk[4 * i + 3] << 24;
#pragma unroll
            for (int k = 0; k < 4; k++)
                s_px[px_vec(t, k)] = make_int4(w[4 * k], w[4 * k + 1],
                                               w[4 * k + 2], w[4 * k + 3]);
        }
        __syncthreads();
    }
    if (kPix) {     // the decoded pixels out: vector t & 3 of blocks a + 48 i
        const int a = t >> 2, k = t & 3;
        const int m0 = a / 6, ra = a - 6 * m0;
        int4 *dst = reinterpret_cast<int4 *>(pix) + (size_t)b0 * 4;
#pragma unroll
        for (int i = 0; i < 4; i++)
            if (a + 48 * i < nb)
                dst[4 * (a + 48 * i) + k] =
                    s_px[px_vec(32 * ra + m0 + 8 * i, k)];
    }
    if (edge) {
        // Encoder edge replication (amv_ref_encode_frame's flip + edge pad,
        // amv_video.extract_blocks): in the last MCU row/column a pixel
        // past the picture takes the value of the nearest picture pixel,
        // which lies in the same MCU: pixel (y, x) of the block reads the
        // component area's (rs, cs) = (min(r0 + y, hr - 1), min(c0 + x,
        // wr - 1)), in block 2 (rs >> 3) + (cs >> 3) (luma) or this one.
        // Its byte in the pixel tile is a row part plus a column part:
        // 64 slot + 16 (((rs & 7) >> 1) ^ ((m >> 1) & 3)) + 8 (rs & 1) +
        // (cs & 7), slot = 32 block + m.
        const uint8_t *px = reinterpret_cast<const uint8_t *>(s_px);
        const int r0 = luma ? 8 * (r >> 1) : 0, c0 = luma ? 8 * (r & 1) : 0;
        int row[8], col[8];
#pragma unroll
        for (int y = 0; y < 8; y++) {
            const int rs = min(r0 + y, hr - 1);
            row[y] = 64 * (32 * (luma ? 2 * (rs >> 3) : r) + m) +
                     16 * (((rs & 7) >> 1) ^ ((m >> 1) & 3)) + 8 * (rs & 1);
        }
#pragma unroll
        for (int x = 0; x < 8; x++) {
            const int cs = min(c0 + x, wr - 1);
            col[x] = (luma ? 64 * 32 * (cs >> 3) : 0) + (cs & 7);
        }
#pragma unroll
        for (int y = 0; y < 8; y++)
#pragma unroll
            for (int x = 0; x < 8; x++) blk[y * 8 + x] = px[row[y] + col[x]];
    }

    if (live) {
        fdct(blk);
        const uint8_t kZigzag[64] = AMV_ZIGZAG;
#pragma unroll
        for (int k = 0; k < 8; k++) {
            u32 w[4];
#pragma unroll
            for (int e = 0; e < 8; e += 2) {
                const int i = 8 * k + e;
                const int ra = kMode == kModeDeq ? i : kZigzag[i];
                const int rb = kMode == kModeDeq ? i + 1 : kZigzag[i + 1];
                const u32 lo = i == 0 ? (u32)quant_dc(blk[0])
                                      : (u32)quant_ac(blk[ra], tab.qmat[ra]);
                const u32 hi = (u32)quant_ac(blk[rb], tab.qmat[rb]);
                w[e / 2] = __byte_perm(lo, hi, 0x5410);
            }
            s_lv[lv_vec(t, k)] = make_int4(w[0], w[1], w[2], w[3]);
        }
    }
    __syncthreads();
    {   // the levels out: vector t & 7 of blocks a + 24 i
        const int a = t >> 3, k = t & 7;
        const int m0 = a / 6, ra = a - 6 * m0;
        int4 *dst = reinterpret_cast<int4 *>(out) + (size_t)b0 * 8;
#pragma unroll
        for (int i = 0; i < 8; i++)
            if (a + 24 * i < nb)
                dst[8 * (a + 24 * i) + k] =
                    s_lv[lv_vec(32 * ra + m0 + 4 * i, k)];
    }
}

template <int kMode, bool kPix>
void launch(const void *lv, const void *dc, const void *tables,
            const void *geom, void *out, void *pix, int n,
            cudaStream_t stream) {
    const int grid = (n + kThreads - 1) / kThreads;
    transcode_blocks_kernel<kMode, kPix><<<grid, kThreads, 0, stream>>>(
        (const int16_t *)lv, (const int32_t *)dc, *(const Tables *)tables,
        *(const Geom *)geom, (int16_t *)out, (uint8_t *)pix, n);
}

}  // namespace

// mode: 0 zigzag levels + dc, 1 the same wrapped over base levels, 2
// dequantized raster blocks (dc unused, raster levels out); pix may be null
// in mode 0 only; n < 2^31
extern "C" int amv_transcode_blocks(const void *lv, const void *dc,
                                    const void *tables, const void *geom,
                                    void *out, void *pix, long long n,
                                    int mode, void *stream) {
    if (n > 0) {
        cudaStream_t s = (cudaStream_t)stream;
        if (mode == kModeWrap)
            launch<kModeWrap, true>(lv, dc, tables, geom, out, pix, (int)n, s);
        else if (mode == kModeDeq)
            launch<kModeDeq, true>(lv, dc, tables, geom, out, pix, (int)n, s);
        else if (pix != nullptr)
            launch<kModeZigzag, true>(lv, dc, tables, geom, out, pix, (int)n,
                                      s);
        else
            launch<kModeZigzag, false>(lv, dc, tables, geom, out, pix, (int)n,
                                       s);
    }
    return (int)cudaGetLastError();
}
