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
// and output forms a template parameter (kMode) so that each instance keeps
// its indices compile-time, and the pixel store enabled by a non-null `pix`.
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
//     sign-symmetric >> 22 and a clip to +-1023 (entropy.c:1096-1122).
// All arithmetic is int32 two's-complement with wraparound, as XLA computes
// it (coef * qmat exceeds int32 at qscale 1 and 2, where qmat reaches 2^18
// and 2^17); the transforms and the quantizer live in dct.cuh, shared with
// kernels I and F.
//
// Geometries that are not whole MCUs (160x120 has half an MCU row of pad)
// take the encoder's edge replication between the IDCT and the FDCT, so
// that the result is the two-stage decode -> crop -> re-encode of the C
// reference and of amv_tpu's decode_transform + encode_transform.
//
// What bounds it: about 1,500 integer operations per block against 260
// bytes of device memory traffic (128 in, 128 out, 4 DC), so it is
// compute-bound at a few operations per byte only if the loads coalesce.
// Design: one thread per block holds its 64 coefficients in registers
// (the whole transform is straight-line code over them); the tables ride
// in the kernel parameters (constant bank).  A block's 128 bytes are read
// and written as 16-byte vectors.  A CTA holds whole MCUs, whose decoded
// pixels pass through 12 KB of shared memory for the edge replication.
// Simple first: no shared-memory transpose to coalesce the level loads.

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
// frame, picture width and height.  width = 16 * mb_w and height = 16 *
// n_mcu / mb_w (no pad pixels) keep every decoded pixel, as the JAX fused
// transform does.  nm_full and nm_base: the wrap mode's [64, 8, nm] views of
// the output and of the base levels.
struct Geom {
    long long mb_w, n_mcu;
    int width, height;
    long long nm_full, nm_base;
};

// kMode: zigzag levels + DC in, zigzag levels out (the layout and pixel
// entries); the same over wrapped base levels; dequantized raster blocks
// in, raster levels out, no edge replication (the dequantized entry).
enum { kModeZigzag = 0, kModeWrap = 1, kModeDeq = 2 };

// One CTA = kMcus whole MCUs (n % 6 == 0 is required but by kModeDeq), so
// the blocks of an MCU can share their decoded pixels through shared memory.
constexpr int kMcus = 32;
constexpr int kThreads = 6 * kMcus;

template <int kMode>
__global__ void __launch_bounds__(kThreads)
transcode_blocks_kernel(const int16_t *__restrict__ lv,
                        const int32_t *__restrict__ dc,
                        const __grid_constant__ Tables tab,
                        const __grid_constant__ Geom geo,
                        int16_t *__restrict__ out,
                        uint8_t *__restrict__ pix, long long n) {
    __shared__ uint8_t spix[kThreads][64];
    const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
    const bool live = b < n;
    const uint8_t kZigzag[64] = AMV_ZIGZAG;
    const int t = (int)(b % 6);
    const bool luma = t < 4;

    long long src_b = live ? b : 0;
    if (kMode == kModeWrap && live)
        src_b = b / geo.nm_full * geo.nm_base + b % geo.nm_full % geo.nm_base;
    int16_t in[64];
    const int4 *src = reinterpret_cast<const int4 *>(lv + src_b * 64);
#pragma unroll
    for (int k = 0; k < 8; k++) reinterpret_cast<int4 *>(in)[k] = src[k];

    u32 blk[64];   // raster
    if (kMode == kModeDeq) {
#pragma unroll
        for (int i = 0; i < 64; i++) blk[i] = (u32)(int32_t)in[i];
    } else {
        blk[0] = wrap16((u32)dc[live ? b : 0]);
#pragma unroll
        for (int i = 1; i < 64; i++) {
            const int r = kZigzag[i];
            const int32_t q = luma ? tab.qm_l[r] : tab.qm_c[r];
            blk[r] = wrap16((u32)(int32_t)in[i] * (u32)q);
        }
    }
    idct_put(blk);

    uint8_t px[64];
#pragma unroll
    for (int k = 0; k < 64; k++) px[k] = (uint8_t)blk[k];
#pragma unroll
    for (int k = 0; k < 4; k++)
        reinterpret_cast<int4 *>(spix[threadIdx.x])[k] =
            reinterpret_cast<int4 *>(px)[k];
    if (live && pix != nullptr) {
        int4 *dst = reinterpret_cast<int4 *>(pix + b * 64);
#pragma unroll
        for (int k = 0; k < 4; k++) dst[k] = reinterpret_cast<int4 *>(px)[k];
    }
    __syncthreads();
    if (!live) return;

    // Encoder edge replication (amv_ref_encode_frame's flip + edge pad,
    // amv_video.extract_blocks): in the last MCU row/column a pixel past
    // the picture takes the value of the nearest picture pixel, which
    // lies in the same MCU.  Rows/cols of this block's component area:
    const long long m = (b / 6) % geo.n_mcu;
    const int mx = (int)(m % geo.mb_w), my = (int)(m / geo.mb_w);
    const int area = luma ? 16 : 8;
    const int hr = min(area, (luma ? geo.height : geo.height / 2) - area * my);
    const int wr = min(area, (luma ? geo.width : geo.width / 2) - area * mx);
    const int r0 = luma ? 8 * (t >> 1) : 0, c0 = luma ? 8 * (t & 1) : 0;
    if (kMode != kModeDeq && (r0 + 8 > hr || c0 + 8 > wr)) {
        const int base = threadIdx.x - t;
#pragma unroll
        for (int r = 0; r < 8; r++) {
            const int rs = min(r0 + r, hr - 1);
#pragma unroll
            for (int c = 0; c < 8; c++) {
                const int cs = min(c0 + c, wr - 1);
                const int ts = luma ? 2 * (rs >> 3) + (cs >> 3) : t;
                blk[r * 8 + c] = spix[base + ts][(rs & 7) * 8 + (cs & 7)];
            }
        }
    }

    fdct(blk);

    int16_t res[64];
    res[0] = quant_dc(blk[0]);
#pragma unroll
    for (int i = 1; i < 64; i++) {
        const int r = kMode == kModeDeq ? i : kZigzag[i];
        res[i] = quant_ac(blk[r], tab.qmat[r]);
    }
    int4 *dst = reinterpret_cast<int4 *>(out + b * 64);
#pragma unroll
    for (int k = 0; k < 8; k++) dst[k] = reinterpret_cast<int4 *>(res)[k];
}

template <int kMode>
void launch(const void *lv, const void *dc, const void *tables,
            const void *geom, void *out, void *pix, long long n,
            cudaStream_t stream) {
    const long long grid = (n + kThreads - 1) / kThreads;
    transcode_blocks_kernel<kMode><<<(unsigned)grid, kThreads, 0, stream>>>(
        (const int16_t *)lv, (const int32_t *)dc, *(const Tables *)tables,
        *(const Geom *)geom, (int16_t *)out, (uint8_t *)pix, n);
}

}  // namespace

// mode: 0 zigzag levels + dc, 1 the same wrapped over base levels, 2
// dequantized raster blocks (dc unused, raster levels out)
extern "C" int amv_transcode_blocks(const void *lv, const void *dc,
                                    const void *tables, const void *geom,
                                    void *out, void *pix, long long n,
                                    int mode, void *stream) {
    if (n > 0) {
        cudaStream_t s = (cudaStream_t)stream;
        if (mode == kModeWrap)
            launch<kModeWrap>(lv, dc, tables, geom, out, pix, n, s);
        else if (mode == kModeDeq)
            launch<kModeDeq>(lv, dc, tables, geom, out, pix, n, s);
        else
            launch<kModeZigzag>(lv, dc, tables, geom, out, pix, n, s);
    }
    return (int)cudaGetLastError();
}
