// Kernel W: amvlib's own AMV decode transform (C-AMVDecoder/amvlib), its
// levels -> its display planes, or straight to its RGB.
//
// Replaces no TPU kernel: the JAX package writes this transform as ~150
// elementwise XLA ops over lists of int32 arrays
// (amv_tpu/codecs/amvlib_video.py:116 decode_transform_amvlib), each a
// pass over [F, M, 6, 64] int32 temporaries.
// Per block b (luma iff b % 6 < 4), exactly
// amv_tpu_torch/codecs/amvlib_video.py:decode_transform_amvlib_plain:
//   * slot 0 of the zigzag levels := the block's DC level, predicted from
//     0 in the level domain: the frame's running (int32, wrapping) sum of
//     its component's DC differences in decode order, Y over its 4 blocks
//     an MCU, then Cb, then Cr (amvlib_video.py:resolve_dc_levels);
//   * dequant in zigzag order by amvlib's ~Q75 pair (AmvJpeg.c:30-61), and
//     the buggy gather raster[k] = deq_zz[kZigzag[k]] (AmvJpeg.c:133-143:
//     37 twice, no 31);
//   * Wang's row pass (idctrow), then its column pass (idctcol), each with
//     its all-zero shortcut (rows: c0 << 3; columns: clip((c0 + 32) >> 6)),
//     the column clip to [-256, 255], +128 on luma after the clip;
//   * XLA's int32 arithmetic: sums, products and left shifts wrap (formed
//     in uint32), right shifts are arithmetic (on int32).
// Two entries (kMode): kPlanes stores int32 planes y [F, H, W] and u, v
// [F, H/2, W/2], coded row r of a plane of h rows on display row h - 1 - r,
// rows >= h and columns >= the plane's width dropped; kRgb stores uint8 RGB
// [F, H, W, 3] of StoreBuffer's fixed point (AmvJpeg.c:789-840) from the
// same pixels, chroma replicated 2x2 (even sizes).
//
// What bounds it: 128 bytes of levels in a block, 256 bytes of int32
// pixels (or 96 of RGB for the four luma blocks' share) out, against
// ~1,300 integer operations: memory.  Design: a CTA a frame, over its MCUs
// 32 at a time (192 threads, a thread a block).  A chunk's levels come
// into a shared tile by coalesced 16-byte loads (rows of 72 int16: a
// warp's 16-byte accesses to 8 rows meet 8 distinct bank groups); a CTA
// scan of the three components' DC differences, plus the frame's carry,
// gives each block its DC (no pass before the launch); each thread takes
// its row to registers, transforms it and writes its pixels back over it
// as 8 16-byte vectors (the first design wrote 64 int16 a thread at a row
// stride of 64, every lane of a warp on one bank: 32-way conflicts).
// After a barrier the threads walk the tile's output, 4 pixels of a row a
// thread (a 16-byte store of int32 planes, or 12 bytes of RGB as 3
// words), which is also where the RGB entry finds a luma pixel's chroma
// (the same MCU's blocks 4 and 5).  A warp-a-frame DC scan into a scratch
// tensor before a transform of 32 MCUs a CTA across frames ran 1.17x
// slower on the H100 (PERF.md, kernel W).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef uint32_t u32;

constexpr int kMcus = 32;                 // MCUs a chunk
constexpr int kThreads = 6 * kMcus;       // a thread a block

// amvlib's zigzag (AmvJpeg.c:133-143), verbatim: the same table as
// codecs/amvlib_video.py AMVLIB_ZIGZAG (a test holds them equal)
#define AMVLIB_ZIGZAG                                                       \
    {0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,       \
     3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 37, 40, 44, 53,       \
     10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,       \
     21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63}

enum { kPlanes = 0, kRgb = 1 };

struct QuantTables {
    int32_t luma[64];     // AMVLIB_QUANT_LUMA, read in zigzag order
    int32_t chroma[64];
};

// F frames of n_mcu MCUs, mb_w to a row; luma height x width
struct Frames {
    long long n_mcu, mb_w, frames;
    int width, height;
};

constexpr int W1 = 2841, W2 = 2676, W3 = 2408, W5 = 1609, W6 = 1108,
              W7 = 565;

// int32 arithmetic that wraps as XLA's
__device__ __forceinline__ int add(int a, int b) {
    return (int)((u32)a + (u32)b);
}
__device__ __forceinline__ int sub(int a, int b) {
    return (int)((u32)a - (u32)b);
}
__device__ __forceinline__ int mul(int k, int a) {
    return (int)((u32)k * (u32)a);
}
__device__ __forceinline__ int shl(int a, int s) {
    return (int)((u32)a << s);
}
__device__ __forceinline__ int clip(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// idctrow (AmvJpeg.c:1082-1128) on c[0..7] in place
__device__ __forceinline__ void idct_row(int *c) {
    const int x1 = shl(c[4], 11);
    const int x2 = c[6], x3 = c[2], x4 = c[1], x5 = c[7], x6 = c[5],
              x7 = c[3];
    if (!(x1 | x2 | x3 | x4 | x5 | x6 | x7)) {
        const int v = shl(c[0], 3);
#pragma unroll
        for (int k = 0; k < 8; k++) c[k] = v;
        return;
    }
    int x0 = add(shl(c[0], 11), 128);
    int x8 = mul(W7, add(x4, x5));
    const int x4b = add(x8, mul(W1 - W7, x4));
    const int x5b = sub(x8, mul(W1 + W7, x5));
    x8 = mul(W3, add(x6, x7));
    const int x6b = sub(x8, mul(W3 - W5, x6));
    const int x7b = sub(x8, mul(W3 + W5, x7));
    x8 = add(x0, x1);
    x0 = sub(x0, x1);
    const int x1b = mul(W6, add(x3, x2));
    const int x2b = sub(x1b, mul(W2 + W6, x2));
    const int x3b = add(x1b, mul(W2 - W6, x3));
    const int x1c = add(x4b, x6b), x4c = sub(x4b, x6b);
    const int x6c = add(x5b, x7b), x5c = sub(x5b, x7b);
    const int x7c = add(x8, x3b);
    x8 = sub(x8, x3b);
    const int x3c = add(x0, x2b);
    x0 = sub(x0, x2b);
    const int x2c = add(mul(181, add(x4c, x5c)), 128) >> 8;
    const int x4d = add(mul(181, sub(x4c, x5c)), 128) >> 8;
    c[0] = add(x7c, x1c) >> 8;
    c[1] = add(x3c, x2c) >> 8;
    c[2] = add(x0, x4d) >> 8;
    c[3] = add(x8, x6c) >> 8;
    c[4] = sub(x8, x6c) >> 8;
    c[5] = sub(x0, x4d) >> 8;
    c[6] = sub(x3c, x2c) >> 8;
    c[7] = sub(x7c, x1c) >> 8;
}

// idctcol (AmvJpeg.c:1130-1176) on c[0..7] in place, clipped to
// [-256, 255]
__device__ __forceinline__ void idct_col(int *c) {
    const int x1 = shl(c[4], 8);
    const int x2 = c[6], x3 = c[2], x4 = c[1], x5 = c[7], x6 = c[5],
              x7 = c[3];
    if (!(x1 | x2 | x3 | x4 | x5 | x6 | x7)) {
        const int v = clip(add(c[0], 32) >> 6, -256, 255);
#pragma unroll
        for (int k = 0; k < 8; k++) c[k] = v;
        return;
    }
    int x0 = add(shl(c[0], 8), 8192);
    int x8 = add(mul(W7, add(x4, x5)), 4);
    const int x4b = add(x8, mul(W1 - W7, x4)) >> 3;
    const int x5b = sub(x8, mul(W1 + W7, x5)) >> 3;
    x8 = add(mul(W3, add(x6, x7)), 4);
    const int x6b = sub(x8, mul(W3 - W5, x6)) >> 3;
    const int x7b = sub(x8, mul(W3 + W5, x7)) >> 3;
    x8 = add(x0, x1);
    x0 = sub(x0, x1);
    const int x1b = add(mul(W6, add(x3, x2)), 4);
    const int x2b = sub(x1b, mul(W2 + W6, x2)) >> 3;
    const int x3b = add(x1b, mul(W2 - W6, x3)) >> 3;
    const int x1c = add(x4b, x6b), x4c = sub(x4b, x6b);
    const int x6c = add(x5b, x7b), x5c = sub(x5b, x7b);
    const int x7c = add(x8, x3b);
    x8 = sub(x8, x3b);
    const int x3c = add(x0, x2b);
    x0 = sub(x0, x2b);
    const int x2c = add(mul(181, add(x4c, x5c)), 128) >> 8;
    const int x4d = add(mul(181, sub(x4c, x5c)), 128) >> 8;
    c[0] = clip(add(x7c, x1c) >> 14, -256, 255);
    c[1] = clip(add(x3c, x2c) >> 14, -256, 255);
    c[2] = clip(add(x0, x4d) >> 14, -256, 255);
    c[3] = clip(add(x8, x6c) >> 14, -256, 255);
    c[4] = clip(sub(x8, x6c) >> 14, -256, 255);
    c[5] = clip(sub(x0, x4d) >> 14, -256, 255);
    c[6] = clip(sub(x3c, x2c) >> 14, -256, 255);
    c[7] = clip(sub(x7c, x1c) >> 14, -256, 255);
}

// shared tile row of a block: 64 int16 and 8 of padding (144 bytes), so a
// warp's 16-byte accesses to 8 rows at a time meet 8 distinct bank groups
constexpr int kRow = 72;

// 4 consecutive pixels of a row: plane values at dst (int32), guarded by
// the columns left in the row
__device__ __forceinline__ void store4(int32_t *dst, const int16_t *px,
                                       int left) {
    if (left >= 4 && ((uintptr_t)dst & 15) == 0) {
        *reinterpret_cast<int4 *>(dst) = make_int4(px[0], px[1], px[2],
                                                   px[3]);
    } else {
#pragma unroll
        for (int e = 0; e < 4; e++)
            if (e < left) dst[e] = px[e];
    }
}

// XLA's wrapping int32 sum of x over the CTA's threads 0..t (inclusive),
// for three classes at once: x[c] is a thread's value in class c.  s_warp
// holds the warps' totals afterwards; one barrier inside.
__device__ __forceinline__ void cta_scan3(int *x, int (*s_warp)[3]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
        for (int c = 0; c < 3; c++) {
            const int o = __shfl_up_sync(0xffffffffu, x[c], off);
            if (lane >= off) x[c] = add(x[c], o);
        }
    }
    if (lane == 31) {
#pragma unroll
        for (int c = 0; c < 3; c++) s_warp[warp][c] = x[c];
    }
    __syncthreads();
    for (int w = 0; w < warp; w++) {
#pragma unroll
        for (int c = 0; c < 3; c++) x[c] = add(x[c], s_warp[w][c]);
    }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
amvlib_idct_kernel(const int16_t *__restrict__ in,
                   const __grid_constant__ QuantTables tab,
                   const __grid_constant__ Frames geo,
                   int32_t *__restrict__ y, int32_t *__restrict__ u,
                   int32_t *__restrict__ v, uint8_t *__restrict__ rgb) {
    // a chunk's blocks: their levels in, then each row overwritten by its
    // own thread's pixels ([MCU][component] rows)
    __shared__ __align__(16) int16_t s_tile[kThreads * kRow];
    __shared__ int s_warp[kThreads / 32][3];
    __shared__ int s_carry[3];   // the DC levels so far: Y, Cb, Cr
    const int t = threadIdx.x;
    const long long f = blockIdx.x;
    const int n_mcu = (int)geo.n_mcu;
    const int hh = geo.height, ww = geo.width, ch = hh / 2, cw = ww / 2;
    const int comp = t % 6;
    const int cls = comp < 4 ? 0 : comp - 3;   // 0 luma, 1 Cb, 2 Cr
    if (t < 3) s_carry[t] = 0;

    for (int m0 = 0; m0 < n_mcu; m0 += kMcus) {
        const int nm = min(kMcus, n_mcu - m0), nb = 6 * nm;
        // the levels, 16-byte vectors, neighbouring threads on
        // neighbouring addresses
        const int4 *src =
            reinterpret_cast<const int4 *>(in + (f * n_mcu + m0) * 6 * 64);
        for (int q = t; q < nb * 8; q += kThreads)
            *reinterpret_cast<int4 *>(s_tile + (q >> 3) * kRow +
                                      (q & 7) * 8) = src[q];
        __syncthreads();

        // DC prediction in the level domain: a thread's block's DC is the
        // frame's running sum of its class's differences up to it (the
        // blocks are in decode order: MCU, then component)
        const int d = t < nb ? (int)s_tile[t * kRow] : 0;
        int x[3] = {cls == 0 ? d : 0, cls == 1 ? d : 0, cls == 2 ? d : 0};
        cta_scan3(x, s_warp);
        const int dcv = add(s_carry[cls], x[cls]);

        if (t < nb) {
            const uint8_t kZigzag[64] = AMVLIB_ZIGZAG;
            const bool luma = cls == 0;
            int16_t *row = s_tile + t * kRow;
            __align__(16) int16_t lv[64];
#pragma unroll
            for (int k = 0; k < 8; k++)
                reinterpret_cast<int4 *>(lv)[k] =
                    reinterpret_cast<const int4 *>(row)[k];
            int blk[64];   // raster
#pragma unroll
            for (int k = 0; k < 64; k++) {
                const int z = kZigzag[k];
                const int q = luma ? tab.luma[z] : tab.chroma[z];
                blk[k] = mul(q, z == 0 ? dcv : (int)lv[z]);
            }
#pragma unroll
            for (int r = 0; r < 8; r++) idct_row(blk + 8 * r);
#pragma unroll
            for (int j = 0; j < 8; j++) {
                int col[8];
#pragma unroll
                for (int i = 0; i < 8; i++) col[i] = blk[8 * i + j];
                idct_col(col);
#pragma unroll
                for (int i = 0; i < 8; i++) blk[8 * i + j] = col[i];
            }
            // this thread's own row: no other thread reads it before the
            // barrier
#pragma unroll
            for (int i = 0; i < 8; i++) {
                __align__(16) int16_t p[8];
#pragma unroll
                for (int j = 0; j < 8; j++)
                    p[j] = (int16_t)(blk[8 * i + j] + (luma ? 128 : 0));
                reinterpret_cast<int4 *>(row)[i] =
                    *reinterpret_cast<const int4 *>(p);
            }
        }
        __syncthreads();
        if (t < 3) {   // the carry past this chunk (read after a barrier)
            int c = s_carry[t];
            for (int w = 0; w < kThreads / 32; w++) c = add(c, s_warp[w][t]);
            s_carry[t] = c;
        }

        // the store: 4 pixels of a row a thread, the rows of each MCU in
        // turn
        constexpr int kQuads = kMode == kRgb ? 64 : 96;   // luma 64, +32
        for (int idx = t; idx < nm * kQuads; idx += kThreads) {
            const int k = idx / kQuads, rem = idx % kQuads;
            const int m = m0 + k;
            const int mx = m % (int)geo.mb_w, my = m / (int)geo.mb_w;
            const int16_t *tile = s_tile + k * 6 * kRow;
            if (rem < 64) {
                const int r = rem >> 2, c0 = (rem & 3) * 4;
                const int row = 16 * my + r, col = 16 * mx + c0;
                if (row >= hh || col >= ww) continue;
                const int16_t *py = tile + ((r >> 3) * 2 + (c0 >> 3)) * kRow +
                                    (r & 7) * 8 + (c0 & 7);
                const long long o = (f * hh + hh - 1 - row) * ww + col;
                const int left = ww - col;
                if (kMode == kPlanes) {
                    store4(y + o, py, left);
                } else {
                    const int16_t *pu = tile + 4 * kRow + (r >> 1) * 8 +
                                        (c0 >> 1);
                    const int16_t *pv = pu + kRow;
                    uint32_t w3[3] = {0, 0, 0};
#pragma unroll
                    for (int e = 0; e < 4; e++) {
                        const int yv = py[e] << 8, cu = pu[e >> 1],
                                  cv = pv[e >> 1];
                        const uint32_t px[3] = {
                            (uint32_t)clip((yv + 18 * cu + 367 * cv) >> 8, 0,
                                           255),
                            (uint32_t)clip((yv - 159 * cu - 220 * cv) >> 8,
                                           0, 255),
                            (uint32_t)clip((yv + 411 * cu - 29 * cv) >> 8, 0,
                                           255)};
#pragma unroll
                        for (int c = 0; c < 3; c++)
                            w3[(3 * e + c) / 4] |= px[c]
                                                   << (8 * ((3 * e + c) % 4));
                    }
                    uint8_t *dst = rgb + 3 * o;
                    if (left >= 4 && ((uintptr_t)dst & 3) == 0) {
#pragma unroll
                        for (int w = 0; w < 3; w++)
                            reinterpret_cast<uint32_t *>(dst)[w] = w3[w];
                    } else {
#pragma unroll
                        for (int k2 = 0; k2 < 12; k2++)
                            if (k2 < 3 * left)
                                dst[k2] = (uint8_t)(w3[k2 / 4] >>
                                                    (8 * (k2 % 4)));
                    }
                }
            } else {
                const int cc = 4 + (rem - 64) / 16, p = (rem - 64) & 15;
                const int r = p >> 1, c0 = (p & 1) * 4;
                const int row = 8 * my + r, col = 8 * mx + c0;
                if (row >= ch || col >= cw) continue;
                store4((cc == 4 ? u : v) + (f * ch + ch - 1 - row) * cw + col,
                       tile + cc * kRow + r * 8 + c0, cw - col);
            }
        }
        __syncthreads();   // the tile is free for the next chunk
    }
}

}  // namespace

// mode 0: int32 planes y, u, v; 1: uint8 RGB into y's place (u, v unused).
// A CTA a frame (geom's frames of n_mcu MCUs), over its MCUs 32 at a time.
extern "C" int amv_amvlib_idct(const void *in, const void *tables,
                               const void *geom, void *out0, void *out1,
                               void *out2, int mode, void *stream) {
    const Frames geo = *(const Frames *)geom;
    if (geo.frames > 0 && geo.n_mcu > 0) {
        const unsigned grid = (unsigned)geo.frames;
        cudaStream_t s = (cudaStream_t)stream;
        const QuantTables tab = *(const QuantTables *)tables;
        if (mode == kRgb)
            amvlib_idct_kernel<kRgb><<<grid, kThreads, 0, s>>>(
                (const int16_t *)in, tab, geo, nullptr, nullptr, nullptr,
                (uint8_t *)out0);
        else
            amvlib_idct_kernel<kPlanes><<<grid, kThreads, 0, s>>>(
                (const int16_t *)in, tab, geo, (int32_t *)out0,
                (int32_t *)out1, (int32_t *)out2, nullptr);
    }
    return (int)cudaGetLastError();
}
