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
// What bounds it: 1.5 bytes of planes in a pixel and 0.125 to 4 bytes out,
// against ~20 integer operations: memory (rgb24: 138.2 MB in and 276.5 MB
// out for 4,800 frames of 160x120, 0.124 ms at 3.35 TB/s).
//
// Design.  One kernel a format (a template on the output kind), so each
// holds only its own code and registers.  A thread takes a group of 8 x 2
// pixels: 8 columns (x0 a multiple of 8, so a pixel's dither column is its
// index in the group) of the two luma rows that share one chroma row, so
// each of its 4 chroma samples' offsets serves 4 pixels.  Tiles of groups:
// whole chroma rows while a row has at most 256 groups (then a tile's luma
// rows are one contiguous run of the output), else 256 groups of one
// chroma row; resident CTAs (SMs x occupancy) take the tiles in turn.  The
// indices are 32-bit; the planes' byte offsets one 32x32->64 multiply a
// row.  Each thread loads its 8 luma bytes a row and 4 + 4 chroma bytes as
// one vector each where aligned, builds its output bytes in registers and
// writes them to the tile's staging buffer in shared memory; after a
// barrier the CTA stores the tile with 16-byte vectors (8- or 4-byte where
// the output address allows), neighbouring threads on neighbouring
// addresses.
//
// Two value paths, picked by the wrapper for each table key:
// * computed (the 32-, 24- and 16/15-bit formats when the wrapper finds it
//   equal to the tables, which holds for the usual keys): the arena is
//   swscale's clip table, a clamp of an affine map, shifted and masked per
//   channel: value = (clamp((cy Y + K + cy d) >> 16, 0, 255) >> rshift) <<
//   lshift, where K = cy off + bh comes from four 256-entry tables of
//   cy div_round(c (i - 128), 76309) (+ bh) that each CTA computes once in
//   shared memory, read once a chroma sample, and cy Y is shared by the
//   three channels; the 16-bit formats' 2x2 dither (cy d) is a kernel
//   parameter;
// * tables (the 8-, 4- and 1-bit formats, and any key the wrapper cannot
//   prove in registers): offsets (4 x 256), dither (3 x 64) and the arena
//   (<= 2,048 words) copied to shared memory once a CTA, the offsets read
//   once a chroma sample, a row's dither as 16-byte vectors.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = kThreads;          // groups of 8 x 2 pixels a tile
constexpr int kTileBytes = kGroups * 64;   // 2 rows x 8 pixels x 4 bytes
constexpr int kArenaMax = 2048;
constexpr int kOffsets = 4 * 256;
constexpr int kDither = 3 * 64;
constexpr int kTables = kOffsets + kDither + kArenaMax;

enum { kKind32 = 0, kKind24, kKind16, kKind8, kKindNibble, kKindMono };

// frames of height x width luma and height/2 x width/2 chroma
struct Packing {
    long long frames;
    int height, width;
    int kind, is_rgb;
    int n_arena;
    int base_r, base_g, base_b;
    // the computed path (computed != 0): channel c (r, g, b) = (clamp((cy
    // * (Y + off + d) + bh) >> 16, 0, 255) >> rshift[c]) << lshift[c];
    // off = div_round(coef * (i - 128), 76309) for coef = crv, cgu, cgv,
    // cbu; cyd[c][row & 1][x & 1] = cy times the 16-bit formats' dither
    int computed;
    int cy, bh;
    int coef[4];
    int rshift[3], lshift[3];
    int cyd[3][2][2];
    int pad;
};

// output bytes of px pixels (px a multiple of 8 for monochrome, even else)
__device__ constexpr int bytes_of(int kind, int px) {
    return kind == kKind32 ? 4 * px : kind == kKind24 ? 3 * px
         : kind == kKind16 ? 2 * px : kind == kKind8 ? px
         : kind == kKindNibble ? px / 2 : px / 8;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// yuv2rgb.c:689-695 div_round(c * (i - 128), 76309) in 32 bits (the wrapper
// checks that |c| * 128 + 38154 fits)
__device__ __forceinline__ int div_round(int c, int i) {
    const int t = c * (i - 128);
    return t > 0 ? (int)((unsigned)(t + 38154) / 76309u)
                 : -(int)((unsigned)(38154 - t) / 76309u);
}

// n (<= 32) bytes held little-endian in words -> p, with the widest
// stores the address and the length allow
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

// n bytes from shared memory (src 16-byte aligned) to dst by the CTA, with
// the widest vectors dst's alignment allows
template <class V>
__device__ __forceinline__ void copy_as(uint8_t *dst, const uint8_t *src,
                                        int n) {
    for (int i = threadIdx.x; i < n / (int)sizeof(V); i += kThreads)
        reinterpret_cast<V *>(dst)[i] = reinterpret_cast<const V *>(src)[i];
    for (int i = n / (int)sizeof(V) * (int)sizeof(V) + threadIdx.x; i < n;
         i += kThreads)
        dst[i] = src[i];
}

__device__ __forceinline__ void copy_out(uint8_t *dst, const uint8_t *src,
                                         int n) {
    const uintptr_t a = (uintptr_t)dst;
    if (a % 16 == 0) copy_as<int4>(dst, src, n);
    else if (a % 8 == 0) copy_as<uint2>(dst, src, n);
    else if (a % 4 == 0) copy_as<uint32_t>(dst, src, n);
    else copy_as<uint8_t>(dst, src, n);
}

// four bytes (the low byte of each) -> a word, a first
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
    return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                       0x5410);
}

// one row's 8 pixels' channel values (c0, g, c2 in the output's order;
// for the 32- and 16-bit kinds already shifted into place) -> its output
// bytes, little-endian in words
template <int kKind>
__device__ __forceinline__ void pack_row(const int *c0, const int *g,
                                         const int *c2, uint32_t *words) {
    if (kKind == kKind32) {
#pragma unroll
        for (int i = 0; i < 8; i++)
            words[i] = (uint32_t)(c0[i] + g[i] + c2[i]);
    } else if (kKind == kKind24) {   // c0 g c2 c0 g c2 ...
        int b[24];
#pragma unroll
        for (int i = 0; i < 8; i++) {
            b[3 * i] = c0[i];
            b[3 * i + 1] = g[i];
            b[3 * i + 2] = c2[i];
        }
#pragma unroll
        for (int k = 0; k < 6; k++)
            words[k] = pack4(b[4 * k], b[4 * k + 1], b[4 * k + 2],
                             b[4 * k + 3]);
    } else if (kKind == kKind16) {
#pragma unroll
        for (int k = 0; k < 4; k++)
            words[k] = __byte_perm(c0[2 * k] + g[2 * k] + c2[2 * k],
                                   c0[2 * k + 1] + g[2 * k + 1] +
                                   c2[2 * k + 1], 0x5410);
    } else if (kKind == kKind8) {
#pragma unroll
        for (int k = 0; k < 2; k++) {
            int s[4];
#pragma unroll
            for (int j = 0; j < 4; j++)
                s[j] = c0[4 * k + j] + g[4 * k + j] + c2[4 * k + j];
            words[k] = pack4(s[0], s[1], s[2], s[3]);
        }
    } else if (kKind == kKindNibble) {   // (even | odd << 4) & 0xff
        uint32_t w = 0;
#pragma unroll
        for (int i = 0; i < 8; i++)
            w |= ((uint32_t)(c0[i] + g[i] + c2[i]) & (i % 2 ? 0xfu : 0xffu))
                 << (4 * i);
        words[0] = w;
    }
}

// a whole group's bytes (an aligned address) into shared memory
template <int kKind>
__device__ __forceinline__ void store_group(uint8_t *p,
                                            const uint32_t *words) {
    if (kKind == kKind32 || kKind == kKind16) {
#pragma unroll
        for (int k = 0; k < bytes_of(kKind, 8) / 16; k++)
            reinterpret_cast<int4 *>(p)[k] = make_int4(
                (int)words[4 * k], (int)words[4 * k + 1],
                (int)words[4 * k + 2], (int)words[4 * k + 3]);
    } else if (kKind == kKind24 || kKind == kKind8) {
#pragma unroll
        for (int k = 0; k < bytes_of(kKind, 8) / 8; k++)
            reinterpret_cast<uint2 *>(p)[k] =
                make_uint2(words[2 * k], words[2 * k + 1]);
    } else if (kKind == kKindNibble) {
        *reinterpret_cast<uint32_t *>(p) = words[0];
    } else {
        *p = (uint8_t)words[0];
    }
}

// kFull: every group has 8 pixels, the luma rows are 8-byte and the chroma
// rows 4-byte aligned (the common case: one vector load each, no per-pixel
// bounds, fixed-width stores, no stack); it stays beside the general path
// because it times faster (`tools/time_pixels.py --general`, PERF.md's Y row)
template <int kKind, bool kTab, bool kFull>
__global__ void __launch_bounds__(kThreads, 6)
yuv2rgb_packed_kernel(const uint8_t *__restrict__ y,
                      const uint8_t *__restrict__ cb,
                      const uint8_t *__restrict__ cr,
                      const int32_t *__restrict__ tables,
                      const __grid_constant__ Packing geo,
                      uint8_t *__restrict__ out, unsigned n_tiles) {
    __shared__ __align__(16) uint8_t s_out[kTileBytes];
    // tables: offsets, dither, arena; computed: K_r[V], K_gu[U], K_gv[V],
    // K_b[U] (cy off + bh, bh counted once in K_g)
    __shared__ __align__(16) int32_t s_tab[kTab ? kTables : kOffsets];
    if (kTab) {
        for (int i = threadIdx.x; i < kOffsets + kDither + geo.n_arena;
             i += kThreads)
            s_tab[i] = tables[i];
    } else {
        for (int i = threadIdx.x; i < kOffsets; i += kThreads) {
            const int t = i / 256;
            s_tab[i] = geo.cy * div_round(geo.coef[t], i % 256) +
                       (t == 2 ? 0 : geo.bh);
        }
    }
    __syncthreads();

    const int w = geo.width, cw = w / 2, ch = geo.height / 2;
    const int gw = (w + 7) / 8;                     // groups a row
    const int chunks = (gw + kGroups - 1) / kGroups;
    const unsigned n_rows = (unsigned)(geo.frames * ch);   // chroma rows
    const int row_bytes = bytes_of(kKind, w);
    const int k = chunks == 1 ? kGroups / gw : 1;   // chroma rows a tile
    // the computed path's 24-bit output in b, g, r order takes K_b first
    const bool swap = kKind == kKind24 && !geo.is_rgb;
    // a tile of whole rows: this thread's row and group in every tile
    int rl = threadIdx.x / gw, gl = threadIdx.x - rl * gw;

    for (unsigned tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        // the tile: k whole chroma rows, or one row's chunk of groups
        unsigned r0;
        int rows, g0, gn;
        if (chunks == 1) {
            r0 = tile * (unsigned)k;
            rows = (int)min((unsigned)k, n_rows - r0);
            g0 = 0;
            gn = gw;
        } else {
            r0 = tile / (unsigned)chunks;
            rows = 1;
            g0 = (int)(tile % (unsigned)chunks) * kGroups;
            gn = min(kGroups, gw - g0);
            rl = threadIdx.x / gn;
            gl = threadIdx.x - rl * gn;
        }
        // the tile's bytes a luma row, and their pitch in s_out
        const int span = bytes_of(kKind, min(w, 8 * (g0 + gn)) - 8 * g0);
        const int pitch = chunks == 1 ? span : (span + 15) & ~15;
        if (rl < rows) {
            const unsigned rc = r0 + rl;           // chroma row, all frames
            const int x0 = 8 * (g0 + gl);
            const int n = kFull ? 8 : min(8, w - x0);   // even: w is even
            int k0[4], k1[4], k2[4];               // per chroma sample
            if (kKind != kKindMono) {
                uint32_t uv[2], vv[2];
                const unsigned long long c0 =
                    (unsigned long long)rc * (unsigned)cw + (unsigned)(x0 / 2);
                if (kFull) {
                    uv[0] = *reinterpret_cast<const uint32_t *>(cb + c0);
                    vv[0] = *reinterpret_cast<const uint32_t *>(cr + c0);
                } else {
                    load_bytes(cb + c0, n / 2, uv);
                    load_bytes(cr + c0, n / 2, vv);
                }
#pragma unroll
                for (int p = 0; p < 4; p++) {
                    const int u = byte_of(uv, p), v = byte_of(vv, p);
                    const int kr = s_tab[v], kb = s_tab[768 + u];
                    k1[p] = s_tab[256 + u] + s_tab[512 + v];
                    k0[p] = !kTab && swap ? kb : kr;
                    k2[p] = !kTab && swap ? kr : kb;
                }
            }
            // the tables path's dither rows need the row in its frame
            const int lrow = kTab ? 2 * (int)(rc % (unsigned)ch) : 0;
            const int bo = bytes_of(kKind, 8 * gl);     // the group's bytes
#pragma unroll
            for (int dy = 0; dy < 2; dy++) {
                uint32_t yv[2], words[8];
                const uint8_t *yp = y + (unsigned long long)(2 * rc + dy) *
                                            (unsigned)w + (unsigned)x0;
                if (kFull) {
                    const uint2 t = *reinterpret_cast<const uint2 *>(yp);
                    yv[0] = t.x;
                    yv[1] = t.y;
                } else {
                    load_bytes(yp, n, yv);
                }
                int c0[8], g[8], c2[8];
                if (kTab) {
                    const int32_t *dith = s_tab + kOffsets +
                                          ((lrow + dy) & 7) * 8;
                    const int32_t *arena = s_tab + kOffsets + kDither;
                    const int hi = geo.n_arena - 1;
                    int d[3][8];
#pragma unroll
                    for (int c = 0; c < 3; c++) {
                        const int4 a = reinterpret_cast<const int4 *>(
                            dith + 64 * c)[0];
                        const int4 b = reinterpret_cast<const int4 *>(
                            dith + 64 * c)[1];
                        d[c][0] = a.x; d[c][1] = a.y; d[c][2] = a.z;
                        d[c][3] = a.w; d[c][4] = b.x; d[c][5] = b.y;
                        d[c][6] = b.z; d[c][7] = b.w;
                    }
                    if (kKind == kKindMono) {
                        uint32_t bits = 0;   // sum of v << (7 - i), uint8
#pragma unroll
                        for (int i = 0; i < 8; i++)
                            bits += (uint32_t)arena[clampi(
                                byte_of(yv, i) + geo.base_g + d[1][i], 0,
                                hi)] << (7 - i);
                        words[0] = bits & 0xff;
                    } else {
#pragma unroll
                        for (int i = 0; i < 8; i++) {
                            const int py = byte_of(yv, i), p = i / 2;
                            const int r = arena[clampi(
                                py + k0[p] + geo.base_r + d[0][i], 0, hi)];
                            g[i] = arena[clampi(
                                py + k1[p] + geo.base_g + d[1][i], 0, hi)];
                            const int b = arena[clampi(
                                py + k2[p] + geo.base_b + d[2][i], 0, hi)];
                            c0[i] = kKind == kKind24 && !geo.is_rgb ? b : r;
                            c2[i] = kKind == kKind24 && !geo.is_rgb ? r : b;
                        }
                        pack_row<kKind>(c0, g, c2, words);
                    }
                } else {
#pragma unroll
                    for (int i = 0; i < 8; i++) {
                        const int a = geo.cy * byte_of(yv, i), p = i / 2;
                        int t0 = a + k0[p], t1 = a + k1[p], t2 = a + k2[p];
                        if (kKind == kKind16) {
                            t0 += geo.cyd[0][dy][i & 1];
                            t1 += geo.cyd[1][dy][i & 1];
                            t2 += geo.cyd[2][dy][i & 1];
                        }
                        c0[i] = __vimin_s32_relu(t0 >> 16, 255);
                        g[i] = __vimin_s32_relu(t1 >> 16, 255);
                        c2[i] = __vimin_s32_relu(t2 >> 16, 255);
                        if (kKind != kKind24) {
                            c0[i] = (c0[i] >> geo.rshift[0]) << geo.lshift[0];
                            g[i] = (g[i] >> geo.rshift[1]) << geo.lshift[1];
                            c2[i] = (c2[i] >> geo.rshift[2]) << geo.lshift[2];
                        }
                    }
                    pack_row<kKind>(c0, g, c2, words);
                }
                uint8_t *dst = s_out + (2 * rl + dy) * pitch + bo;
                if (kFull)
                    store_group<kKind>(dst, words);
                else
                    store_bytes(dst, words, bytes_of(kKind, n));
            }
        }
        __syncthreads();

        // the tile's luma rows 2 r0 .. 2 (r0 + rows) - 1 of the output
        uint8_t *dst = out + (unsigned long long)(2 * r0) *
                                 (unsigned)row_bytes +
                       bytes_of(kKind, 8 * g0);
        if (chunks == 1) {   // whole rows: one contiguous run
            copy_out(dst, s_out, 2 * rows * row_bytes);
        } else {
            copy_out(dst, s_out, span);
            copy_out(dst + row_bytes, s_out + pitch, span);
        }
        __syncthreads();
    }
}

template <int kKind, bool kTab, bool kFull>
cudaError_t launch_one(const void *y, const void *cb, const void *cr,
                       const void *tables, const Packing &geo, void *out,
                       long long tiles, cudaStream_t stream) {
    auto kernel = yuv2rgb_packed_kernel<kKind, kTab, kFull>;
    int dev = 0, sms = 1, per_sm = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
    long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
    if (grid > tiles) grid = tiles;
    kernel<<<(unsigned)grid, kThreads, 0, stream>>>(
        (const uint8_t *)y, (const uint8_t *)cb, (const uint8_t *)cr,
        (const int32_t *)tables, geo, (uint8_t *)out, (unsigned)tiles);
    return cudaGetLastError();
}

template <int kKind, bool kTab>
cudaError_t launch(const void *y, const void *cb, const void *cr,
                   const void *tables, const Packing &geo, void *out,
                   long long tiles, cudaStream_t stream) {
    const bool full = geo.width % 8 == 0 && (uintptr_t)y % 8 == 0 &&
                      (uintptr_t)cb % 4 == 0 && (uintptr_t)cr % 4 == 0;
    return full ? launch_one<kKind, kTab, true>(y, cb, cr, tables, geo, out,
                                                tiles, stream)
                : launch_one<kKind, kTab, false>(y, cb, cr, tables, geo,
                                                 out, tiles, stream);
}

}  // namespace

// geom: struct Packing (kernels/yuv2rgb_dither.py packs it); tables: the
// int32 buffer of kernel_tables() on the device (read by the tables path)
extern "C" int amv_yuv2rgb_packed(const void *y, const void *cb,
                                  const void *cr, const void *tables,
                                  const void *geom, void *out,
                                  void *stream) {
    const Packing geo = *(const Packing *)geom;
    if (geo.n_arena > kArenaMax || geo.n_arena < 1 || geo.width < 2 ||
        geo.height < 2 || geo.width % 2 || geo.height % 2 ||
        geo.kind < kKind32 || geo.kind > kKindMono ||
        (geo.computed && geo.kind > kKind16))
        return (int)cudaErrorInvalidValue;
    const long long rows = geo.frames * (geo.height / 2);
    const long long gw = (geo.width + 7) / 8;
    const long long chunks = (gw + kGroups - 1) / kGroups;
    const long long tiles = chunks == 1
        ? (rows + kGroups / gw - 1) / (kGroups / gw) : rows * chunks;
    if (rows >= (1LL << 31) || tiles >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    if (tiles == 0) return (int)cudaGetLastError();
    const cudaStream_t s = (cudaStream_t)stream;
    if (geo.computed) {
        switch (geo.kind) {
        case kKind32: return (int)launch<kKind32, false>(
            y, cb, cr, tables, geo, out, tiles, s);
        case kKind24: return (int)launch<kKind24, false>(
            y, cb, cr, tables, geo, out, tiles, s);
        default: return (int)launch<kKind16, false>(
            y, cb, cr, tables, geo, out, tiles, s);
        }
    }
    switch (geo.kind) {
    case kKind32: return (int)launch<kKind32, true>(
        y, cb, cr, tables, geo, out, tiles, s);
    case kKind24: return (int)launch<kKind24, true>(
        y, cb, cr, tables, geo, out, tiles, s);
    case kKind16: return (int)launch<kKind16, true>(
        y, cb, cr, tables, geo, out, tiles, s);
    case kKind8: return (int)launch<kKind8, true>(
        y, cb, cr, tables, geo, out, tiles, s);
    case kKindNibble: return (int)launch<kKindNibble, true>(
        y, cb, cr, tables, geo, out, tiles, s);
    default: return (int)launch<kKindMono, true>(
        y, cb, cr, tables, geo, out, tiles, s);
    }
}
