// Kernel A: IMA-ADPCM (AMV flavour) decode, a warp per chunk, as two
// clipped-add scans.
//
// Replaces the Pallas kernels
//   amv_tpu/kernels/adpcm_pallas.py:decode_layout (the batched chunk
//     decode), and
//   amv_tpu/kernels/adpcm_pallas.py:decode_layout_wrap (the same over a
//     logically tiled input: output row i reads input row i % C).
// Semantics: adpcm_ima_expand_nibble with shift 3 (adpcm.c:716-740) per
// nibble, the high nibble of each byte first (adpcm.c:1281-1282), from
// the chunk's header state {predictor, step_index} with the step index
// clamped to 0..88; every payload byte decodes to two samples.
//
// Both recurrences of the decoder are clipped additions,
//   s' = clip(s + idx(nib & 7), 0, 88)              (nibbles only)
//   p' = clip(p +- ((2d + 1) step[s]) >> 3, -32768, 32767)  (s only),
// and maps x -> min(max(x + a, lo), hi) are closed under composition
// (amv_tpu/kernels/adpcm.py:1-25, _compose_clipped_add), so the decode
// is two associative scans, as the JAX package's `decode_nibbles` computes
// it: nothing in a chunk is serial but a lane's own run.
//
// What bounds it: 5 bytes of traffic per payload byte (1 in, 4 out), so
// at the file's shape (4,800 chunks of 689 bytes) 16.5 MB, 5 us at the
// memory rate; the work is ~40 integer instructions a sample.  Design: a
// warp per chunk (output row), kWarps warps a CTA.  The warp stages its
// row's bytes in shared memory (16-byte loads at 16-byte aligned
// addresses, the partial vectors at both ends byte by byte) in tiles of
// kTile bytes; each lane owns a run of ceil(tile / 32) bytes and walks it
// three times: (1) it composes its run's step-index maps; a warp
// exclusive scan (__shfl_up_sync, 5 rounds) gives every lane its starting
// step index; (2) it composes its run's predictor maps from that index,
// keeping each sample's difference magnitude in the sample's slot of a
// shared output tile; a second scan gives every lane its starting
// predictor; (3) it replays its run's clipped additions from that
// predictor, exactly the serial step, the samples replacing the
// magnitudes, and the warp stores the tile as 16-byte vectors.  The state after a tile (the whole
// tile's maps applied) starts the next one.  A composed map's offset is
// bounded by the tile (2 kTile samples of at most 61,438: below 2^27), so
// no chunk length can overflow it; the header's predictor is clamped to
// +-2^20 first, which changes no sample (|diff| <= 61,438 keeps a
// predictor beyond the rail on it).  The integer pipe binds the walks, so
// tables in shared memory stand for arithmetic: each byte value's composed
// step-index map (walk 1), and for each step index and nibble magnitude the
// difference magnitude ((2d + 1) step[s]) >> 3 beside the next step index
// (walk 2).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__constant__ int16_t kStepTable[89] = {
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37, 41,
    45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173, 190,
    209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658, 724,
    796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066, 2272,
    2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894, 6484, 7132,
    7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289, 16818, 18500,
    20350, 22385, 24623, 27086, 29794, 32767};

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 1024;        // payload bytes a warp stages at a time
constexpr int kBig = 1 << 30;      // the identity map's bounds
constexpr int kPredRail = 1 << 20; // the header predictor's clamp

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return min(max(x, lo), hi);
}

// a clipped-add map x -> min(max(x + a, lo), hi)
struct Map {
    int a, lo, hi;
    __device__ __forceinline__ int apply(int x) const {
        return clampi(x + a, lo, hi);
    }
    // this map, then the step x -> clip(x + d, l, h)
    __device__ __forceinline__ void then(int d, int l, int h) {
        a += d;
        lo = clampi(lo + d, l, h);
        hi = clampi(hi + d, l, h);
    }
};

// f, then g
__device__ __forceinline__ Map compose(const Map &f, const Map &g) {
    return {f.a + g.a, clampi(f.lo + g.a, g.lo, g.hi),
            clampi(f.hi + g.a, g.lo, g.hi)};
}

// inclusive scan of the lanes' maps (lane 0's first); the exclusive
// prefix of each lane (identity for lane 0) and the whole warp's map
__device__ __forceinline__ void warp_scan(Map m, int lane, Map &excl,
                                          Map &total) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        Map p = {__shfl_up_sync(0xffffffffu, m.a, d),
                 __shfl_up_sync(0xffffffffu, m.lo, d),
                 __shfl_up_sync(0xffffffffu, m.hi, d)};
        if (lane >= d) m = compose(p, m);
    }
    excl = {__shfl_up_sync(0xffffffffu, m.a, 1),
            __shfl_up_sync(0xffffffffu, m.lo, 1),
            __shfl_up_sync(0xffffffffu, m.hi, 1)};
    if (lane == 0) excl = {0, -kBig, kBig};
    total = {__shfl_sync(0xffffffffu, m.a, 31),
             __shfl_sync(0xffffffffu, m.lo, 31),
             __shfl_sync(0xffffffffu, m.hi, 31)};
}

__device__ __forceinline__ int index_step(int nib) {
    const int d = nib & 7;
    return d < 4 ? -1 : 2 * d - 6;
}

// the step-index map of a byte's two nibbles (high, then low), packed:
// offset + 2 in bits 0-7, lo in 8-15, hi in 16-23
__device__ __forceinline__ uint32_t byte_map(int byte) {
    Map m = {0, -kBig, kBig};
    m.then(index_step(byte >> 4), 0, 88);
    m.then(index_step(byte), 0, 88);
    return (uint32_t)(m.a + 2) | (uint32_t)m.lo << 8 | (uint32_t)m.hi << 16;
}

__device__ __forceinline__ int sign(int nib, int mag) {
    return (nib & 8) ? -mag : mag;
}

// bytes [0, n) at g into s + (g & 15), s 16-byte aligned: whole aligned
// vectors as int4, the partial ones at both ends byte by byte
__device__ __forceinline__ void stage_in(const uint8_t *g, int n, uint8_t *s,
                                         int lane) {
    const int off = (int)((uintptr_t)g & 15);
    const uint8_t *g0 = g - off;
    const int nv = (off + n + 15) >> 4;
    for (int v = lane; v < nv; v += 32) {
        const int b0 = v << 4;
        if (b0 >= off && b0 + 16 <= off + n) {
            *reinterpret_cast<int4 *>(s + b0) =
                __ldg(reinterpret_cast<const int4 *>(g0 + b0));
        } else {
            for (int b = max(b0, off); b < min(b0 + 16, off + n); b++)
                s[b] = g0[b];
        }
    }
}

// n 4-byte words from s + (g & 15) to g (g 4-byte aligned), the same way
__device__ __forceinline__ void stage_out(const uint8_t *s, int n,
                                          uint8_t *g, int lane) {
    const int off = (int)((uintptr_t)g & 15);
    uint8_t *g0 = g - off;
    const int end = off + 4 * n;
    const int nv = (end + 15) >> 4;
    for (int v = lane; v < nv; v += 32) {
        const int b0 = v << 4;
        if (b0 >= off && b0 + 16 <= end) {
            *reinterpret_cast<int4 *>(g0 + b0) =
                *reinterpret_cast<const int4 *>(s + b0);
        } else {
            for (int b = max(b0, off); b < min(b0 + 16, end); b += 4)
                *reinterpret_cast<uint32_t *>(g0 + b) =
                    *reinterpret_cast<const uint32_t *>(s + b);
        }
    }
}

__global__ void __launch_bounds__(kThreads)
adpcm_decode_kernel(const uint8_t *__restrict__ payload, int nbytes,
                    const int32_t *__restrict__ pred,
                    const int32_t *__restrict__ sidx, unsigned c_in,
                    unsigned c_out, int16_t *__restrict__ out) {
    // step_tab[8 s + d]: for nibble magnitude d at step index s, the
    // difference magnitude ((2 d + 1) step[s]) >> 3 (at most 61,438) in the
    // low 16 bits and the next step index in the high ones; byte_tab: the
    // step-index map of each byte value
    __shared__ uint32_t step_tab[89 * 8];
    __shared__ uint32_t byte_tab[256];
    __shared__ __align__(16) uint8_t s_in[kWarps][kTile + 16];
    __shared__ __align__(16) uint8_t s_out[kWarps][4 * kTile + 16];
    for (int i = threadIdx.x; i < 89 * 8; i += kThreads) {
        const int s = i >> 3, d = i & 7;
        step_tab[i] = (uint32_t)(((2 * d + 1) * kStepTable[s]) >> 3) |
                      (uint32_t)clampi(s + index_step(d), 0, 88) << 16;
    }
    for (int i = threadIdx.x; i < 256; i += kThreads) byte_tab[i] = byte_map(i);
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const unsigned row = blockIdx.x * kWarps + warp;
    if (row >= c_out) return;
    const unsigned src = row % c_in;
    const uint8_t *g_in = payload + (size_t)src * nbytes;
    uint8_t *g_out = reinterpret_cast<uint8_t *>(out + (size_t)row * 2 * nbytes);
    uint8_t *const sin = s_in[warp];
    uint8_t *const sout = s_out[warp];
    int p = clampi(pred[src], -kPredRail, kPredRail);
    int s = clampi(sidx[src], 0, 88);

    for (int t0 = 0; t0 < nbytes; t0 += kTile) {
        const int tb = min(kTile, nbytes - t0);
        const uint8_t *gi = g_in + t0;
        uint8_t *go = g_out + 4 * (size_t)t0;
        const int ia = (int)((uintptr_t)gi & 15);
        const int oa = (int)((uintptr_t)go & 15);
        stage_in(gi, tb, sin, lane);
        __syncwarp();
        const int run = (tb + 31) >> 5;
        const int k0 = min(lane * run, tb), k1 = min(k0 + run, tb);

        // (1) the run's step-index map, scanned
        Map ms = {0, -kBig, kBig};
#pragma unroll 2
        for (int k = k0; k < k1; k++) {
            const uint32_t e = byte_tab[sin[ia + k]];
            ms.then((int)(e & 0xff) - 2, (e >> 8) & 0xff, e >> 16);
        }
        Map excl, total;
        warp_scan(ms, lane, excl, total);
        const int s_run = excl.apply(s);
        s = total.apply(s);

        // (2) the run's predictor map, scanned; each sample's difference
        // magnitude kept in its output slot
        Map mp = {0, -kBig, kBig};
        int ss = s_run;
#pragma unroll 2
        for (int k = k0; k < k1; k++) {
            const int byte = sin[ia + k];
            const int hi = byte >> 4;
            const uint32_t e0 = step_tab[8 * ss + (hi & 7)];
            const int m0 = e0 & 0xffff;
            const uint32_t e1 = step_tab[8 * (e0 >> 16) + (byte & 7)];
            const int m1 = e1 & 0xffff;
            ss = e1 >> 16;
            mp.then(sign(hi, m0), -32768, 32767);
            mp.then(sign(byte, m1), -32768, 32767);
            *reinterpret_cast<uint32_t *>(sout + oa + 4 * k) =
                (uint32_t)m0 | (uint32_t)m1 << 16;
        }
        warp_scan(mp, lane, excl, total);
        int pp = excl.apply(p);
        p = total.apply(p);

        // (3) the run decoded from its true predictor: the samples replace
        // the magnitudes
#pragma unroll 2
        for (int k = k0; k < k1; k++) {
            const int byte = sin[ia + k];
            uint32_t *slot = reinterpret_cast<uint32_t *>(sout + oa + 4 * k);
            const uint32_t mags = *slot;
            pp = clampi(pp + sign(byte >> 4, mags & 0xffff), -32768, 32767);
            const uint32_t first = (uint16_t)pp;
            pp = clampi(pp + sign(byte, mags >> 16), -32768, 32767);
            // little-endian: the high nibble's sample first
            *slot = first | ((uint32_t)(uint16_t)pp << 16);
        }
        __syncwarp();
        stage_out(sout, tb, go, lane);
        __syncwarp();
    }
}

}  // namespace

extern "C" int amv_adpcm_decode(const void *payload, long long nbytes,
                                const void *pred, const void *sidx,
                                long long c_in, long long c_out, void *out,
                                void *stream) {
    if (c_out > 0 && nbytes > 0) {
        const long long grid = (c_out + kWarps - 1) / kWarps;
        adpcm_decode_kernel<<<(unsigned)grid, kThreads, 0,
                              (cudaStream_t)stream>>>(
            (const uint8_t *)payload, (int)nbytes, (const int32_t *)pred,
            (const int32_t *)sidx, (unsigned)c_in, (unsigned)c_out,
            (int16_t *)out);
    }
    return (int)cudaGetLastError();
}
