// Kernel Y: YUV420 planes -> packed and ordered-dithered RGB (libswscale's
// yuv2rgb output family, the `-pix_fmt` .rgb/.raw output), every format in
// one pass.
//
// Replaces no TPU kernel: the JAX package computes this as ~15 XLA ops over
// int32 planes (amv_tpu/kernels/yuv2rgb_dither.py:283 yuv420_to_packed),
// and the port's plain version as as many torch passes over int32
// temporaries; this kernel reads the planes once and writes the packed
// pixels once.
//
// Per pixel (x, y) of a frame, with U, V the chroma sample (x/2, y/2) and
// D = dither[(y & 7) * 8 + (x & 7)] (the wrapper tiles every dither matrix
// to 8x8), value(base, off, d) = arena[clamp(Y + off + base + d, 0, L-1)]:
//   r = value(base_r, off_r[V], dr), g = value(base_g, off_gu[U] +
//   off_gv[V], dg), b = value(base_b, off_b[U], db);
// 32-bit: r + g + b as a word; 24-bit: three bytes (r, g, b or b, g, r);
// 16/15-bit: r + g + b as a halfword; 8-bit and 4-bit-a-byte: a byte;
// 4-bit pairs: (even) | (odd) << 4; monochrome: g's value at U = V = 128
// (offset 0), eight pixels MSB first in a byte.  Exactly
// amv_tpu_torch/kernels/yuv2rgb_dither.py:yuv420_to_packed_plain.
//
// What bounds it: 1.5 bytes of planes in a pixel, 0.125 to 4 bytes out,
// against ~30 integer operations and 3 table reads: memory.  Design, simple
// first: a thread takes 8 pixels of a row (x0 a multiple of 8, so the
// dither column is the pixel's index in the group and a thread's dither row
// is fixed), loads its 8 luma and 4 + 4 chroma bytes as one vector each
// where aligned, builds its output bytes in registers (at most 32) and
// stores them as 16-, 8- or 4-byte vectors where the address allows.  The
// tables (offsets 4 x 256, dither 3 x 64, arena <= 2,048 words, ~13 KB) are
// read at random indices by neighbouring lanes, so they live in shared
// memory, copied once a CTA: resident CTAs (SMs x occupancy) stride over
// the groups, so the copy is paid ~1,000 times, not once a group.  Not in
// __constant__ memory: lanes reading different entries there serialize.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kArenaMax = 2048;
constexpr int kOffsets = 4 * 256;
constexpr int kDither = 3 * 64;

enum { kKind32 = 0, kKind24, kKind16, kKind8, kKindNibble, kKindMono };

// frames of height x width luma and height/2 x width/2 chroma
struct Packing {
    long long frames;
    int height, width;
    int kind, is_rgb;
    int n_arena;
    int base_r, base_g, base_b;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// n (<= 32, even or 1) bytes held little-endian in words -> p, with the
// widest stores the address and the length allow
__device__ __forceinline__ void store_bytes(uint8_t *p, const uint32_t *words,
                                            int n) {
    const uintptr_t a = (uintptr_t)p;
    if (n % 16 == 0 && a % 16 == 0) {
#pragma unroll
        for (int k = 0; k < 2; k++)
            if (16 * k < n)
                reinterpret_cast<int4 *>(p)[k] = make_int4(
                    (int)words[4 * k], (int)words[4 * k + 1],
                    (int)words[4 * k + 2], (int)words[4 * k + 3]);
    } else if (n % 8 == 0 && a % 8 == 0) {
#pragma unroll
        for (int k = 0; k < 4; k++)
            if (8 * k < n)
                reinterpret_cast<uint2 *>(p)[k] =
                    make_uint2(words[2 * k], words[2 * k + 1]);
    } else if (n % 4 == 0 && a % 4 == 0) {
#pragma unroll
        for (int k = 0; k < 8; k++)
            if (4 * k < n) reinterpret_cast<uint32_t *>(p)[k] = words[k];
    } else {
#pragma unroll
        for (int k = 0; k < 32; k++)
            if (k < n) p[k] = (uint8_t)(words[k / 4] >> (8 * (k % 4)));
    }
}

// n (<= 8) bytes from p into v, one 8- or 4-byte load where aligned
__device__ __forceinline__ void load_bytes(const uint8_t *p, int n,
                                           uint32_t *v) {
    const uintptr_t a = (uintptr_t)p;
    if (n == 8 && a % 8 == 0) {
        const uint2 t = *reinterpret_cast<const uint2 *>(p);
        v[0] = t.x;
        v[1] = t.y;
    } else if (n == 4 && a % 4 == 0) {
        v[0] = *reinterpret_cast<const uint32_t *>(p);
        v[1] = 0;
    } else {
        v[0] = v[1] = 0;
#pragma unroll
        for (int k = 0; k < 8; k++)
            if (k < n) v[k / 4] |= (uint32_t)p[k] << (8 * (k % 4));
    }
}

__device__ __forceinline__ int byte_of(const uint32_t *v, int k) {
    return (int)((v[k / 4] >> (8 * (k % 4))) & 0xff);
}

__global__ void __launch_bounds__(kThreads)
yuv2rgb_packed_kernel(const uint8_t *__restrict__ y,
                      const uint8_t *__restrict__ cb,
                      const uint8_t *__restrict__ cr,
                      const int32_t *__restrict__ tables,
                      const __grid_constant__ Packing geo,
                      uint8_t *__restrict__ out) {
    __shared__ int32_t s_off[kOffsets];   // off_r, off_gu, off_gv, off_b
    __shared__ int32_t s_dith[kDither];   // dr, dg, db, 8 x 8 each
    __shared__ int32_t s_arena[kArenaMax];
    for (int i = threadIdx.x; i < kOffsets + kDither + geo.n_arena;
         i += kThreads) {
        const int32_t t = tables[i];
        if (i < kOffsets) s_off[i] = t;
        else if (i < kOffsets + kDither) s_dith[i - kOffsets] = t;
        else s_arena[i - kOffsets - kDither] = t;
    }
    __syncthreads();

    const int w = geo.width, h = geo.height, cw = w / 2;
    const int hi = geo.n_arena - 1;
    const int groups = (w + 7) / 8;
    const long long total = geo.frames * h * groups;
    const int kind = geo.kind;
    // output bytes of a row
    const long long row_bytes =
        kind == kKind32 ? 4LL * w : kind == kKind24 ? 3LL * w
        : kind == kKind16 ? 2LL * w : kind == kKind8 ? (long long)w
        : kind == kKindNibble ? w / 2 : w / 8;

    for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
         g < total; g += (long long)gridDim.x * kThreads) {
        const int x0 = (int)(g % groups) * 8;
        const long long fr = g / groups;       // frame * h + row
        const int row = (int)(fr % h);
        const long long f = fr / h;
        const int n = min(8, w - x0);          // even: w is even

        uint32_t yv[2], uv[2], vv[2];
        load_bytes(y + fr * w + x0, n, yv);
        const int *dr = s_dith + (row & 7) * 8;
        const int *dg = dr + 64, *db = dr + 128;
        uint32_t words[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        int nbytes;
        uint8_t *dst = out + fr * row_bytes;

        if (kind == kKindMono) {
            uint32_t bits = 0;   // sum of v << (7 - i), as uint8
#pragma unroll
            for (int i = 0; i < 8; i++) {
                const int v = s_arena[clampi(byte_of(yv, i) + geo.base_g +
                                             dg[i], 0, hi)];
                bits += (uint32_t)v << (7 - i);
            }
            words[0] = bits & 0xff;
            nbytes = 1;
            dst += x0 / 8;
        } else {
            const long long crow = (f * (h / 2) + row / 2) * cw + x0 / 2;
            load_bytes(cb + crow, n / 2, uv);
            load_bytes(cr + crow, n / 2, vv);
#pragma unroll
            for (int i = 0; i < 8; i++) {
                if (i < n) {
                    const int py = byte_of(yv, i);
                    const int u = byte_of(uv, i / 2), v = byte_of(vv, i / 2);
                    const int r = s_arena[clampi(py + s_off[v] + geo.base_r +
                                                 dr[i], 0, hi)];
                    const int gg = s_arena[clampi(py + s_off[256 + u] +
                                                  s_off[512 + v] +
                                                  geo.base_g + dg[i], 0, hi)];
                    const int b = s_arena[clampi(py + s_off[768 + u] +
                                                 geo.base_b + db[i], 0, hi)];
                    const uint32_t s = (uint32_t)(r + gg + b);
                    if (kind == kKind32) {
                        words[i] = s;
                    } else if (kind == kKind24) {
                        const uint32_t c0 = (uint32_t)(geo.is_rgb ? r : b);
                        const uint32_t c2 = (uint32_t)(geo.is_rgb ? b : r);
                        words[(3 * i) / 4] |= (c0 & 0xff)
                                              << (8 * ((3 * i) % 4));
                        words[(3 * i + 1) / 4] |= ((uint32_t)gg & 0xff)
                                                  << (8 * ((3 * i + 1) % 4));
                        words[(3 * i + 2) / 4] |= (c2 & 0xff)
                                                  << (8 * ((3 * i + 2) % 4));
                    } else if (kind == kKind16) {
                        words[i / 2] |= (s & 0xffff) << (16 * (i % 2));
                    } else if (kind == kKind8) {
                        words[i / 4] |= (s & 0xff) << (8 * (i % 4));
                    } else {   // (even | odd << 4) & 0xff, even low
                        words[0] |= (s & (i % 2 ? 0xfu : 0xffu))
                                    << (4 * i);
                    }
                }
            }
            nbytes = kind == kKind32 ? 4 * n : kind == kKind24 ? 3 * n
                   : kind == kKind16 ? 2 * n : kind == kKind8 ? n : n / 2;
            dst += kind == kKind32 ? 4 * x0 : kind == kKind24 ? 3 * x0
                 : kind == kKind16 ? 2 * x0 : kind == kKind8 ? x0 : x0 / 2;
        }
        store_bytes(dst, words, nbytes);
    }
}

}  // namespace

// geom: struct Packing (kernels/yuv2rgb_dither.py packs it); tables: the
// int32 buffer of kernel_tables() on the device
extern "C" int amv_yuv2rgb_packed(const void *y, const void *cb,
                                  const void *cr, const void *tables,
                                  const void *geom, void *out,
                                  void *stream) {
    const Packing geo = *(const Packing *)geom;
    if (geo.n_arena > kArenaMax || geo.n_arena < 1)
        return (int)cudaErrorInvalidValue;
    const long long total =
        geo.frames * geo.height * ((geo.width + 7) / 8);
    if (total > 0) {
        int dev = 0, sms = 1, per_sm = 1;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, yuv2rgb_packed_kernel, kThreads, 0);
        long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
        const long long need = (total + kThreads - 1) / kThreads;
        if (grid > need) grid = need;
        yuv2rgb_packed_kernel<<<(unsigned)grid, kThreads, 0,
                                (cudaStream_t)stream>>>(
            (const uint8_t *)y, (const uint8_t *)cb, (const uint8_t *)cr,
            (const int32_t *)tables, geo, (uint8_t *)out);
    }
    return (int)cudaGetLastError();
}
