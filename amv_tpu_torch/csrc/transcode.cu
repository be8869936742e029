// Kernel T: fused AMV block transcode (dequant + IDCT + FDCT + requant).
//
// Replaces the Pallas kernels
//   amv_tpu/kernels/transcode_layout_pallas.py:transcode_mcu_layout (slab
//     layout, the complete chain's transform), and
//   amv_tpu/kernels/transcode_pallas.py:transcode_zz (coefficient-major,
//     also emits the decoded pixels; the host-entropy route).
// Both compute the same arithmetic; here one kernel serves both, the pixel
// store enabled by a non-null `pix`.
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
// it: the products are formed in uint32 so that nvcc's signed-overflow
// assumptions cannot change a result (coef * qmat exceeds int32 at qscale
// 1 and 2, where qmat reaches 2^18 and 2^17).
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

namespace {

typedef uint32_t u32;

struct Tables {
    int32_t qmat[64];   // encoder reciprocal quantizer, raster
    int32_t qm_l[64];   // Q60 luma dequant, raster
    int32_t qm_c[64];   // Q60 chroma dequant, raster
};

// Frame geometry for the encoder's edge replication: MCUs per row and per
// frame, picture width and height.  width = 16 * mb_w and height = 16 *
// n_mcu / mb_w (no pad pixels) keep every decoded pixel, as the JAX fused
// transform does.
struct Geom {
    long long mb_w, n_mcu;
    int width, height;
};

// zigzag scan position -> raster index; a local constant array so that the
// unrolled loops fold every index and the block stays in registers
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

// One CTA = kMcus whole MCUs (n % 6 == 0 is required), so the blocks of an
// MCU can share their decoded pixels through shared memory.
constexpr int kMcus = 32;
constexpr int kThreads = 6 * kMcus;

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

    int16_t in[64];
    const int4 *src = reinterpret_cast<const int4 *>(lv + (live ? b : 0) * 64);
#pragma unroll
    for (int k = 0; k < 8; k++) reinterpret_cast<int4 *>(in)[k] = src[k];

    u32 blk[64];   // raster
    blk[0] = wrap16((u32)dc[live ? b : 0]);
#pragma unroll
    for (int i = 1; i < 64; i++) {
        const int r = kZigzag[i];
        const int32_t q = luma ? tab.qm_l[r] : tab.qm_c[r];
        blk[r] = wrap16((u32)(int32_t)in[i] * (u32)q);
    }
#pragma unroll
    for (int r = 0; r < 8; r++) idct_row(blk + r * 8);
#pragma unroll
    for (int j = 0; j < 8; j++) idct_col(blk, j);

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
    if (r0 + 8 > hr || c0 + 8 > wr) {
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

#pragma unroll
    for (int r = 0; r < 8; r++) fdct_1d(blk, r * 8, 1, true);
#pragma unroll
    for (int j = 0; j < 8; j++) fdct_1d(blk, j, 8, false);

    int16_t res[64];
    res[0] = (int16_t)sra(blk[0] + 32u, 6);
#pragma unroll
    for (int i = 1; i < 64; i++) {
        const int r = kZigzag[i];
        const u32 level = blk[r] * (u32)tab.qmat[r];
        const int32_t q = s32(level) >= 0 ? s32(level) >> 22
                                          : -(s32(0u - level) >> 22);
        res[i] = (int16_t)(q > 1023 ? 1023 : (q < -1023 ? -1023 : q));
    }
    int4 *dst = reinterpret_cast<int4 *>(out + b * 64);
#pragma unroll
    for (int k = 0; k < 8; k++) dst[k] = reinterpret_cast<int4 *>(res)[k];
}

}  // namespace

extern "C" int amv_transcode_blocks(const void *lv, const void *dc,
                                    const void *tables, const void *geom,
                                    void *out, void *pix, long long n,
                                    void *stream) {
    if (n > 0) {
        const long long grid = (n + kThreads - 1) / kThreads;
        transcode_blocks_kernel<<<(unsigned)grid, kThreads, 0,
                                  (cudaStream_t)stream>>>(
            (const int16_t *)lv, (const int32_t *)dc,
            *(const Tables *)tables, *(const Geom *)geom, (int16_t *)out,
            (uint8_t *)pix, n);
    }
    return (int)cudaGetLastError();
}
