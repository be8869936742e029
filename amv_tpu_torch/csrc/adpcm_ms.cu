// Kernel M: the MS-ADPCM expand of WAVE input (adpcm.c:743-756), a thread
// per lane.
//
// Not the port of a Pallas kernel: the JAX package runs this expand as one
// jax.lax.scan over the samples (amv_tpu/kernels/adpcm.py:225
// decode_ms_nibbles), which XLA compiles into a single device loop; the
// port's plain version is a torch loop of ~14 launches a sample.
// Semantics, as the JAX package's (int32 wraps as C's `int` does): per
// nibble n of a lane, from the block header's state (s1, s2, idelta) and
// coefficients (c1, c2),
//   p  = (s1 c1 + s2 c2) wrapped to int32, then / 256 toward zero
//        ((p + ((p >> 31) & 255)) >> 8);
//   s1' = clip(p + signed(n) idelta, -32768, 32767), the sum wrapped;
//   idelta' = max((adapt[n] idelta) wrapped >> 8, 16);  s2' = s1;
// and the output sample is s1'.  Products and sums are formed in uint32
// and cast back, which is the two's-complement wrap.
//
// What bounds it: a lane is a serial recurrence; the card holds 12,998
// lanes of 2,034 samples at chip_smoke phase 12's shape, 407 warps for 528
// warp schedulers, so one lane's 2,034 dependent steps are the floor,
// beside 1 byte in and 2 out a sample (0.024 ms at 3.35 TB/s).  Two
// designs fell short of it: a thread reading and writing its own row
// straight from device memory (0.264 ms: every access of a warp touches
// 32 rows' sectors, and the L1's throughput binds), and the rows through
// shared tiles with each sample's nibble and adaptation factor read from
// shared memory inside the walk (0.141 ms: the two dependent loads' latency
// sits in the adaptation chain).  Design: a warp of kRows = 32 lanes a CTA,
// a thread a lane; the rows pass through shared memory in tiles of kTile
// samples, so device memory sees whole lines: the warp copies the next
// tile's 32 rows with cp.async (4-byte words from the word at or before
// each row's start, a row a warp instruction) while it walks the current
// one; each thread reads its row's next 16 nibbles as five words a group
// ahead (word strides of kInWords, odd: no bank conflicts), forms the
// adaptation factor from a 64-bit constant, not a table in memory, keeps
// s2 c2 a step ahead so the chain from s1 to s1' is one multiply-add, the
// division's three operations, a fused add-max (DPX) and a min; and it
// writes its samples as packed pairs into an output tile that the warp
// then stores, coalesced, 4 words of a row a lane with the shared loads of
// 8 rows ahead of their global stores.  On an H100 this takes ~0.100 ms
// (tools/ms_variants.py), 4x the chain's floor.  What binds it: one warp
// alone takes as long as all 12,998 lanes, ~94 cycles a sample, of which
// the walk alone is ~81 for its 24.4 instructions a sample (3.3 cycles
// each: a warp's own issue at one warp a scheduler, not its chain nor the
// integer pipe): leaving out the clip, the division or idelta's
// recurrence saves ~5 cycles each, the add-max as two plain instructions
// nothing, and a table for the sign and factor (18.7 instructions, a
// shared load each) is slower.  The tile's copies and stores add ~13 (the
// stores a row at a time, each load just before its store: 0.127 ms).
// Fewer rows a warp (24, 16, 8) shorten a warp but not its instructions,
// and put a second warp on some of the 528 schedulers: slower; 32 stay.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;               // rows a warp walks, a lane each
constexpr int kTile = 256;              // samples a tile
constexpr int kInWords = kTile / 4 + 1; // a row's tile and its offset
constexpr int kOutWords = kTile / 2 + 1;
constexpr int kGroup = 16;              // samples walked from 5 words

// adapt[v] (adpcm.c's AdaptationTable) as 10-bit fields indexed by
// max(d - 3, 0), d = v < 8 ? v : 16 - v: 230, 307, 409, 512, 614, 768
constexpr unsigned long long kAdaptBits =
    230ull | 307ull << 10 | 409ull << 20 | 512ull << 30 | 614ull << 40 |
    768ull << 50;

__device__ __forceinline__ int adapt(int v) {
    const int d = v < 8 ? v : 16 - v;
    return (int)(kAdaptBits >> (10 * max(d - 3, 0))) & 1023;
}

struct Lane {
    int c1, c2, s1, s2c2, idl;    // s2c2 = s2 c2, formed a step ahead

    // one sample of nibble v -> s1'; the chain from s1 to s1' is a
    // multiply-add, the division's three operations and a fused add-max
    // and a min
    __device__ __forceinline__ int step(int v) {
        int p = (int)((uint32_t)s1 * (uint32_t)c1 + (uint32_t)s2c2);
        p /= 256;                 // toward zero: (p + (p >> 31 & 255)) >> 8
        const int sv = v & 8 ? v - 16 : v;
        const int q = (int)((uint32_t)sv * (uint32_t)idl);
        s2c2 = (int)((uint32_t)s1 * (uint32_t)c2);
        s1 = min(__viaddmax_s32(p, q, -32768), 32767);
        idl = max((int)((uint32_t)adapt(v) * (uint32_t)idl) >> 8, 16);
        return s1;
    }
};

// cp.async of tile t of the warp's rows into in[r][...]: the words from
// the one holding the tile's first byte to the one holding its last
__device__ __forceinline__ void issue_tile(uint32_t (*in)[kInWords],
                                           const uint8_t *nib, long long n,
                                           long long row0, int rows,
                                           long long t, int lane) {
    const long long at = t * kTile;
    const int cnt = (int)min((long long)kTile, n - at);
    for (int r = 0; r < rows; ++r) {
        const uintptr_t a = (uintptr_t)(nib + (row0 + r) * n + at);
        const int sh = (int)(a & 3);
        const uint32_t *w = (const uint32_t *)(a - sh);
        const int words = (sh + cnt + 3) >> 2;
        for (int k = lane; k < words; k += 32)
            __pipeline_memcpy_async(&in[r][k], w + k, 4);
    }
    __pipeline_commit();
}

__global__ void __launch_bounds__(32)
ms_expand_kernel(const uint8_t *__restrict__ nib, long long b, long long n,
                 const int32_t *__restrict__ coeff1,
                 const int32_t *__restrict__ coeff2,
                 const int32_t *__restrict__ idelta,
                 const int32_t *__restrict__ sample1,
                 const int32_t *__restrict__ sample2, bool out4,
                 int16_t *__restrict__ out) {
    static_assert(kRows <= 32, "a lane a row");
    __shared__ uint32_t s_in[2][kRows][kInWords];
    __shared__ uint32_t s_out[kRows][kOutWords];
    const int lane = threadIdx.x;
    const long long row0 = (long long)blockIdx.x * kRows;
    const int rows = (int)min((long long)kRows, b - row0);
    // lanes past the last row walk its row again; their tiles go nowhere
    const long long row = row0 + min(lane, rows - 1);
    Lane st{coeff1[row], coeff2[row], sample1[row],
            (int)((uint32_t)sample2[row] * (uint32_t)coeff2[row]),
            idelta[row]};
    const int sh = (int)((uintptr_t)(nib + row * n) & 3);
    const long long tiles = (n + kTile - 1) / kTile;
    const int slot = lane < kRows ? lane : 0;   // its row's tiles
    issue_tile(s_in[0], nib, n, row0, rows, 0, lane);
    for (long long t = 0; t < tiles; ++t) {
        const int buf = (int)(t & 1);
        if (t + 1 < tiles) {
            issue_tile(s_in[buf ^ 1], nib, n, row0, rows, t + 1, lane);
            __pipeline_wait_prior(1);
        } else {
            __pipeline_wait_prior(0);
        }
        __syncwarp();
        const int cnt = (int)min((long long)kTile, n - t * kTile);
        const uint32_t *rw = s_in[buf][slot];
        uint32_t *dst = s_out[slot];
        if (kRows < 32 && lane >= kRows) {
            // no row of its own: the lane only copies and stores
        } else if (cnt == kTile) {
            // each group's five words are read a group ahead
            uint32_t w[5];
#pragma unroll
            for (int k = 0; k < 5; ++k) w[k] = rw[k];
            for (int g = 0; g < kTile / kGroup; ++g) {
                uint32_t nw[5];
                const int at = min(g + 1, kTile / kGroup - 1) * 4;
#pragma unroll
                for (int k = 0; k < 5; ++k) nw[k] = rw[at + k];
                uint32_t x[4];
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    x[k] = __funnelshift_r(w[k], w[k + 1], 8 * sh);
#pragma unroll
                for (int j = 0; j < kGroup; j += 2) {
                    const int lo = st.step((x[j >> 2] >> (8 * (j & 3))) & 15);
                    const int hi = st.step(
                        (x[j >> 2] >> (8 * ((j + 1) & 3))) & 15);
                    dst[(g * kGroup + j) >> 1] =
                        (uint32_t)(uint16_t)lo | (uint32_t)hi << 16;
                }
#pragma unroll
                for (int k = 0; k < 5; ++k) w[k] = nw[k];
            }
        } else {
            const uint8_t *src = (const uint8_t *)rw + sh;
            uint16_t *h = (uint16_t *)dst;
            for (int k = 0; k < cnt; ++k)
                h[k] = (uint16_t)st.step(src[k] & 15);
        }
        __syncwarp();
        // the tile's rows out, coalesced
        if (out4 && cnt == kTile) {
            // a full tile: 4 words of each row a lane, the shared loads of
            // 8 rows ahead of their stores
            int16_t *d0 = out + row0 * n + t * kTile;
            for (int r0 = 0; r0 < rows; r0 += 8) {
                uint32_t v[8][kTile / 64];
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int k = 0; k < kTile / 64; ++k)
                        v[i][k] = s_out[min(r0 + i, kRows - 1)][lane + 32 * k];
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    if (r0 + i < rows) {
                        uint32_t *d = reinterpret_cast<uint32_t *>(
                            d0 + (r0 + i) * n);
#pragma unroll
                        for (int k = 0; k < kTile / 64; ++k)
                            d[lane + 32 * k] = v[i][k];
                    }
                }
            }
        } else {
            for (int r = 0; r < rows; ++r) {
                int16_t *d = out + (row0 + r) * n + t * kTile;
                if (out4) {
                    for (int w = lane; w < cnt >> 1; w += 32)
                        reinterpret_cast<uint32_t *>(d)[w] = s_out[r][w];
                } else {
                    const uint16_t *h = (const uint16_t *)s_out[r];
                    for (int k = lane; k < cnt; k += 32)
                        d[k] = (int16_t)h[k];
                }
            }
        }
        __syncwarp();
    }
}

}  // namespace

// nib uint8 [b, n] (0..15, emit order), coeff1, coeff2, idelta, sample1,
// sample2 int32 [b]; out int16 [b, n].
extern "C" int amv_ms_expand(const void *nib, long long b, long long n,
                             const void *coeff1, const void *coeff2,
                             const void *idelta, const void *sample1,
                             const void *sample2, void *out, void *stream) {
    // packed 32-bit stores where every row starts 4-byte aligned
    const bool out4 = n % 2 == 0 && (uintptr_t)out % 4 == 0;
    if (b > 0 && n > 0)
        ms_expand_kernel<<<(unsigned)((b + kRows - 1) / kRows), 32, 0,
                           (cudaStream_t)stream>>>(
            (const uint8_t *)nib, b, n, (const int32_t *)coeff1,
            (const int32_t *)coeff2, (const int32_t *)idelta,
            (const int32_t *)sample1, (const int32_t *)sample2, out4,
            (int16_t *)out);
    return (int)cudaGetLastError();
}
