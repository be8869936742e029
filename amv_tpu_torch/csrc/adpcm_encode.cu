// Kernel Q: IMA-ADPCM (AMV flavour) encode, segment-parallel and exact.
//
// Replaces the Pallas kernels
//   amv_tpu/kernels/adpcm_encode_pallas.py:encode_layout (the stream
//     encode behind encode_streams_pallas), and
//   amv_tpu/kernels/adpcm_encode_pallas.py:encode_layout_wrap (the same
//     over a logically tiled input: output stream i reads input stream
//     i % B).
// Semantics: adpcm_ima_compress_sample (adpcm.c:219-227) per sample; the
// predictor takes the sample where the reset flag is set (a chunk start,
// adpcm.c:464) and starts at 0; the step index starts at sidx0 clamped to
// 0..88.  Outputs per sample pair t: the packed byte (first nibble high)
// and sidx_even, the step index before sample 2t (what a chunk header
// starting there stores).
//
// What bounds it: the quantizer feeds back, so a stream is one serial
// chain (6.6 M samples for 5 minutes at 22,050 Hz), and the card's floor
// is the latency of the serial walks, not its ~27 MB of bytes.
// The predictor restarts at every reset, so only the step index (0..88)
// carries from one reset segment to the next.  A stream is cut into
// windows of kWindow samples; the segment of window w starts at the
// window's first even sample with a reset (window 0 at sample 0) and runs
// to the next window's segment start, so a window without an even reset
// has an empty segment (the identity map) and no table of segments is
// built on the host.  A reset elsewhere in a segment is applied inside it.
// Each sample is one division-free quantizer step (three compare-and-
// subtract stages for min(7, 4 |delta| / step)) and one load of a
// transition table in shared memory (the reconstruction, the next step and
// step index).  Five launches and a memset on the caller's stream:
//   1. window_ends: warps take windows from a counter, find their
//      segments, and walk each from all 89 starts (three to a lane) on
//      samples staged in shared memory with coalesced loads.  Equal
//      (predictor, step index) states have equal futures: every 64 samples
//      the warp counts its distinct states, and once at most 32 remain
//      each keeps one lane and a start -> lane map gives the 89 ends.
//      Every kTile samples it records each start's state (a checkpoint),
//      and it lists the segment's runs of kTile samples for pass 3.
//   2. group_maps: the composed map of each group of kGroup windows;
//      group_chain: one thread per stream walks the group maps from
//      sidx0; window_chain: one thread per group walks its window maps
//      from the group's start.  The maps are staged in shared memory with
//      16-byte loads.
//   3. window_encode: a warp takes 32 runs, one a lane, each from its
//      segment's resolved start or from the checkpoint of that start, so
//      a serial walk is at most kTile samples long; the lanes' samples
//      arrive by cp.async into two buffers while the lanes walk, and the
//      warp stores each lane's bytes and step indices coalesced.
// The one-segment stream (a single reset at sample 0) is correct; its
// pass 1 is one serial walk of the whole stream.

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

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 8;        // warps a pass-1 CTA
constexpr int kTile = 256;       // samples staged a warp; a pass-3 run
constexpr int kCheck = 64;       // samples between merge checks
constexpr int kSlots = 96;       // 89 starts, three to a lane
constexpr int kChainTile = 128;  // maps staged a tile by the chain walks
constexpr int kMap = 96;         // bytes a map row: 89 entries, padded
constexpr int kWindow = 512;     // samples a window
constexpr int kGroup = 64;       // windows a group of the chain
// pass 1 looks for a window's first even reset at the window's start plus
// 2 lane, so a window starts on an even sample
static_assert(kWindow % 2 == 0, "kWindow must be even");

struct Geometry {
    long long B, n, W, NG;       // streams, samples, windows, groups
    long long CK;                // checkpoints a row: n / kTile + 1
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// The quantizer's transitions, in shared memory: entry 8 s + mag holds
// the reconstruction (step(s) (2 mag + 1)) >> 3 and the next state, its
// step and 8 times its index, so a sample takes one table load.
struct Tables {
    uint2 next[89 * 8];   // x: recon; y: step(s') | 8 s' << 16
    int step[89];
};

__device__ __forceinline__ void load_tables(Tables &tb) {
    for (int i = threadIdx.x; i < 89 * 8; i += blockDim.x) {
        const int s = i >> 3, mag = i & 7;
        const int s2 = clampi(s + (mag < 4 ? -1 : 2 * mag - 6), 0, 88);
        tb.next[i] = make_uint2((kStepTable[s] * (2 * mag + 1)) >> 3,
                                kStepTable[s2] | (8 * s2) << 16);
    }
    for (int i = threadIdx.x; i < 89; i += blockDim.x)
        tb.step[i] = kStepTable[i];
    __syncthreads();
}

// A quantizer state: the predictor, the step and 8 times the step index.
struct State {
    int p, step, ix;
    __device__ __forceinline__ void start(int s, const Tables &tb) {
        p = 0;
        step = tb.step[s];
        ix = 8 * s;
    }
    __device__ __forceinline__ int index() const { return ix >> 3; }
    // one adpcm_ima_compress_sample step; returns the nibble.  The
    // magnitude min(7, 4 |delta| / step) by three compare-and-subtract
    // stages in place of the division: exact for every |delta| <= 65,535
    // and all 89 steps (tests/test_torch_adpcm_passes.py).
    __device__ __forceinline__ int compress(int x, const Tables &tb) {
        const int delta = x - p;
        int q = (delta < 0 ? -delta : delta) << 2;
        int mag = 0;
        if (q >= step << 2) { mag = 4; q -= step << 2; }
        if (q >= step << 1) { mag += 2; q -= step << 1; }
        if (q >= step) mag += 1;
        const uint2 e = tb.next[ix + mag];
        p = clampi(delta < 0 ? p - (int)e.x : p + (int)e.x, -32768, 32767);
        step = e.y & 0xFFFF;
        ix = e.y >> 16;
        return mag | (delta < 0 ? 8 : 0);
    }
};

// a staged sample: the int16 in the low half, the reset flag in bit 16
__device__ __forceinline__ int sample(int v) { return (int16_t)(v & 0xFFFF); }

// Stage samples [a, a + cnt) of a stream as packed words, lanes on
// consecutive samples.  With lim >= 0, stop at the first even sample at or
// past lim with a reset: returns the samples staged before it.
__device__ __forceinline__ int stage(const int16_t *xr, const uint8_t *rr,
                                     long long a, int cnt, long long lim,
                                     int *tile, int lane) {
    for (int j0 = 0; j0 < cnt; j0 += 32) {
        const int j = j0 + lane;
        const long long t = a + j;
        int v = 0;
        bool stop = false;
        if (j < cnt) {
            const int r = rr[t];
            v = (uint16_t)xr[t] | (r ? 0x10000 : 0);
            stop = lim >= 0 && r && !(t & 1) && t >= lim;
        }
        tile[j] = v;
        const unsigned m = __ballot_sync(kFull, stop);
        if (m) return j0 + __ffs(m) - 1;
    }
    return cnt;
}

struct EndsSmem {
    int tile[kTile];
    int key[kSlots];
    int rank[kSlots];
    int st_p[32], st_s[32];
    uint8_t lane_of[kSlots];
};

// The next window for a warp: windows are handed out in order from a
// counter, so a warp that finds an empty window moves on at once and every
// segment gets a warp as soon as one is free.
__device__ __forceinline__ long long next_window(unsigned long long *counter,
                                                 int lane) {
    unsigned long long g = 0;
    if (lane == 0) g = atomicAdd(counter, 1ull);
    return (long long)__shfl_sync(kFull, g, 0);
}

__device__ __forceinline__ void window_ends(
        const int16_t *__restrict__ x, const uint8_t *__restrict__ reset,
        const Geometry &geo, long long g, uint8_t *__restrict__ ends,
        long long *__restrict__ bounds, long long *__restrict__ list,
        unsigned long long *__restrict__ n_list, uint32_t *__restrict__ ckpt,
        const Tables &tb, EndsSmem &sm, int lane) {
    const long long base = g % (geo.B * geo.W);
    const long long b = base / geo.W, w = base % geo.W;
    const int16_t *xr = x + b * geo.n;
    const uint8_t *rr = reset + b * geo.n;
    const long long lo = w * kWindow, hi = min(lo + kWindow, geo.n);
    uint8_t *e = ends + g * kMap;

    long long start = w == 0 ? 0 : -1;
    for (long long t0 = lo; t0 < hi && start < 0; t0 += 64) {
        const long long t = t0 + 2 * lane;
        const unsigned m = __ballot_sync(kFull, t < hi && rr[t]);
        if (m) start = t0 + 2 * (__ffs(m) - 1);
    }
    if (start < 0) {                       // no segment: the identity map
        for (int i = lane; i < 89; i += 32) e[i] = (uint8_t)i;
        if (lane == 0) bounds[2 * base] = bounds[2 * base + 1] = lo;
        return;
    }

    State st[3], st1;
#pragma unroll
    for (int k = 0; k < 3; k++) st[k].start(min(lane + 32 * k, 88), tb);
    st1.start(0, tb);
    bool merged = false;
    long long end = geo.n;
    for (long long a = start; a < end; a += kTile) {
        __syncwarp();
        const int want = (int)min((long long)kTile, end - a);
        const int cnt = stage(xr, rr, a, want, hi, sm.tile, lane);
        if (cnt < want) end = a + cnt;
        __syncwarp();
        for (int j0 = 0; j0 < cnt; j0 += kCheck) {
            if (!merged && a + j0 > start) {
                // merge check: the first slot of each state keeps it
#pragma unroll
                for (int k = 0; k < 3; k++) {
                    const int i = lane + 32 * k;
                    sm.key[i] = i < 89 ? ((st[k].p + 32768) << 7) |
                                         st[k].index() : -1 - i;
                }
                __syncwarp();
                unsigned first[3];
                int rep[3];
#pragma unroll
                for (int k = 0; k < 3; k++) {
                    const int i = lane + 32 * k;
                    const int key = sm.key[i];
                    int r = i;
                    for (int j = 0; i < 89 && j < i; j++)
                        if (sm.key[j] == key) { r = j; break; }
                    rep[k] = r;
                    first[k] = __ballot_sync(kFull, i < 89 && r == i);
                }
                const int n0 = __popc(first[0]), n1 = __popc(first[1]);
                if (n0 + n1 + __popc(first[2]) <= 32) {
                    const unsigned below = (1u << lane) - 1;
#pragma unroll
                    for (int k = 0; k < 3; k++) {
                        const int i = lane + 32 * k;
                        if (i < 89 && rep[k] == i) {
                            const int r = (k > 0 ? n0 : 0) + (k > 1 ? n1 : 0)
                                          + __popc(first[k] & below);
                            sm.rank[i] = r;
                            sm.st_p[r] = st[k].p;
                            sm.st_s[r] = st[k].index();
                        }
                    }
                    __syncwarp();
#pragma unroll
                    for (int k = 0; k < 3; k++) {
                        const int i = lane + 32 * k;
                        if (i < 89) sm.lane_of[i] = (uint8_t)sm.rank[rep[k]];
                    }
                    const int d = n0 + n1 + __popc(first[2]);
                    st1.start(lane < d ? sm.st_s[lane] : 0, tb);
                    st1.p = lane < d ? sm.st_p[lane] : 0;
                    merged = true;
                }
                __syncwarp();
            }
            if (j0 == 0 && a > start) {
                // checkpoint: every start's state before sample a, where
                // pass 3 resumes the walk (p, 8 s << 16)
                uint32_t *ck = ckpt + ((g / geo.W) * geo.CK + a / kTile) * 89;
#pragma unroll
                for (int k = 0; k < 3; k++) {
                    const int i = lane + 32 * k;
                    int p = st[k].p, ix = st[k].ix;
                    if (merged) {
                        const int src = i < 89 ? sm.lane_of[i] : 0;
                        p = __shfl_sync(kFull, st1.p, src);
                        ix = __shfl_sync(kFull, st1.ix, src);
                    }
                    if (i < 89)
                        ck[i] = (uint32_t)(uint16_t)p | (uint32_t)ix << 16;
                }
            }
            const int j1 = min(j0 + kCheck, cnt);
            if (merged) {
                for (int j = j0; j < j1; j++) {
                    const int v = sm.tile[j];
                    if (v >> 16) st1.p = sample(v);
                    st1.compress(sample(v), tb);
                }
            } else {
                for (int j = j0; j < j1; j++) {
                    const int v = sm.tile[j];
                    const int xv = sample(v);
#pragma unroll
                    for (int k = 0; k < 3; k++) {
                        if (v >> 16) st[k].p = xv;
                        st[k].compress(xv, tb);
                    }
                }
            }
        }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 3; k++) {
        const int i = lane + 32 * k;
        int v = st[k].index();
        if (merged)
            v = __shfl_sync(kFull, st1.index(), i < 89 ? sm.lane_of[i] : 0);
        if (i < 89) e[i] = (uint8_t)v;
    }
    if (lane == 0) {
        bounds[2 * base] = start;
        bounds[2 * base + 1] = end;
    }
    // pass 3's units: the segment's runs of kTile samples, (g, q)
    const long long nsub = (end - start + kTile - 1) / kTile;
    unsigned long long at = 0;
    if (lane == 0) at = atomicAdd(n_list, (unsigned long long)nsub);
    at = __shfl_sync(kFull, at, 0);
    for (long long q = lane; q < nsub; q += 32) list[at + q] = g << 24 | q;
}

// pass 1: each warp takes windows from the counter: window g (of an
// output row) -> ends[g][0..88], and the window's segment bounds
__global__ void __launch_bounds__(32 * kWarps)
window_ends_kernel(const int16_t *__restrict__ x,
                   const uint8_t *__restrict__ reset, const Geometry geo,
                   long long n_win, unsigned long long *__restrict__ counter,
                   uint8_t *__restrict__ ends, long long *__restrict__ bounds,
                   long long *__restrict__ list, uint32_t *__restrict__ ckpt) {
    __shared__ Tables tb;
    __shared__ EndsSmem smem[kWarps];
    load_tables(tb);
    const int lane = threadIdx.x & 31;
    EndsSmem &sm = smem[threadIdx.x >> 5];
    for (long long g = next_window(counter, lane); g < n_win;
         g = next_window(counter, lane))
        window_ends(x, reset, geo, g, ends, bounds, list, counter + 1, ckpt,
                    tb, sm, lane);
}

// Stage m maps (rows of kMap bytes, 16-byte aligned) into shared memory
// with 16-byte loads.
__device__ __forceinline__ void stage_maps(const uint8_t *maps, int m,
                                           uint8_t *tile) {
    const uint4 *src = reinterpret_cast<const uint4 *>(maps);
    uint4 *dst = reinterpret_cast<uint4 *>(tile);
#pragma unroll 4
    for (int j = threadIdx.x; j < m * (kMap / 16); j += blockDim.x)
        dst[j] = src[j];
}

// pass 2a: CTA gi (group grp of chain c) -> the composed map of its
// windows' maps
__global__ void __launch_bounds__(kSlots)
group_maps_kernel(const uint8_t *__restrict__ ends, const Geometry geo,
                  uint8_t *__restrict__ gmaps) {
    __shared__ __align__(16) uint8_t tile[kChainTile * kMap];
    const long long gi = blockIdx.x;
    const long long c = gi / geo.NG, grp = gi % geo.NG;
    const long long w0 = grp * kGroup;
    const int m = (int)min((long long)kGroup, geo.W - w0);
    const uint8_t *src = ends + (c * geo.W + w0) * kMap;
    int s = min((int)threadIdx.x, 88);
    for (int k = 0; k < m; k += kChainTile) {
        const int mk = min(kChainTile, m - k);
        __syncthreads();
        stage_maps(src + k * kMap, mk, tile);
        __syncthreads();
        for (int j = 0; j < mk; j++) s = tile[j * kMap + s];
    }
    if (threadIdx.x < 89) gmaps[gi * kMap + threadIdx.x] = (uint8_t)s;
}

// Walk a chain of m maps from s: out[j] = the state before map j.  Thread
// 0 walks; the CTA stages the maps.
__device__ __forceinline__ void walk_chain(const uint8_t *maps, long long m,
                                           int s, uint8_t *out,
                                           uint8_t *tile) {
    for (long long k = 0; k < m; k += kChainTile) {
        const int mk = (int)min((long long)kChainTile, m - k);
        __syncthreads();
        stage_maps(maps + k * kMap, mk, tile);
        __syncthreads();
        if (threadIdx.x == 0) {
            for (int j = 0; j < mk; j++) {
                out[k + j] = (uint8_t)s;
                s = tile[j * kMap + s];
            }
        }
    }
}

// pass 2b: CTA c (an output row) walks its group maps from sidx0
__global__ void __launch_bounds__(128)
group_chain_kernel(const uint8_t *__restrict__ gmaps,
                   const int32_t *__restrict__ sidx0, const Geometry geo,
                   uint8_t *__restrict__ gstart) {
    __shared__ __align__(16) uint8_t tile[kChainTile * kMap];
    const long long c = blockIdx.x;
    walk_chain(gmaps + c * geo.NG * kMap, geo.NG,
               clampi(sidx0[c % geo.B], 0, 88), gstart + c * geo.NG, tile);
}

// pass 2c: CTA gi walks its group's window maps from the group's start
__global__ void __launch_bounds__(128)
window_chain_kernel(const uint8_t *__restrict__ ends,
                    const uint8_t *__restrict__ gstart, const Geometry geo,
                    uint8_t *__restrict__ starts) {
    __shared__ __align__(16) uint8_t tile[kChainTile * kMap];
    const long long gi = blockIdx.x;
    const long long c = gi / geo.NG, grp = gi % geo.NG;
    const long long w0 = c * geo.W + grp * kGroup;
    walk_chain(ends + w0 * kMap, min((long long)kGroup, geo.W - grp * kGroup),
               gstart[gi], starts + w0, tile);
}

constexpr int kPairs = 64;       // pairs a lane encodes between stores

struct EncodeSmem {
    uint32_t x[2][32][kPairs + 1];       // lanes' sample pairs, 2 buffers
    uint32_t r[2][32][kPairs / 2 + 3];   // their reset bytes, as words
    uint8_t bytes[32][kPairs + 4], sidx[32][kPairs + 4];
};

__device__ __forceinline__ void copy_async4(void *dst, const void *src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src));
}

// Start the copies of the lanes' next pairs (from sample t of the
// buffers, up to end) into buffer bi: each lane's run of samples and of
// reset bytes (as 4-byte aligned words; the last word of the reset buffer,
// n_all bytes, byte by byte), the warp on consecutive words of one run at
// a time.
__device__ __forceinline__ void prefetch(const int16_t *x,
                                         const uint8_t *reset,
                                         long long n_all, EncodeSmem &sm,
                                         int bi, long long t, long long end,
                                         int lane) {
    const int cnt = (int)max(0ll, min((long long)kPairs, (end - t) / 2));
    for (int l = 0; l < 32; l++) {
        const int c = __shfl_sync(kFull, cnt, l);
        const long long t0 = __shfl_sync(kFull, t, l);
        for (int k = lane; k < c; k += 32)
            copy_async4(&sm.x[bi][l][k], x + t0 + 2 * k);
        const int nw = ((int)(t0 & 3) + 2 * c + 3) >> 2;
        for (int k = lane; k < nw; k += 32) {
            const long long at = (t0 & ~3ll) + 4 * k;
            if (at + 4 <= n_all) {
                copy_async4(&sm.r[bi][l][k], reset + at);
            } else {
                uint8_t *d = reinterpret_cast<uint8_t *>(&sm.r[bi][l][k]);
                for (int q = 0; q < 4; q++)
                    d[q] = at + q < n_all ? reset[at + q] : 0;
            }
        }
    }
    asm volatile("cp.async.commit_group;\n" ::);
}

// pass 3: a CTA of one warp (so that the few warps this pass needs spread
// over the SMs) takes 32 segments from pass 1's list, one a lane, and
// encodes them from their resolved starts: the lanes walk in step while
// the copies of their next pairs are in flight, and the warp stores each
// lane's run of bytes and step indices coalesced
__global__ void __launch_bounds__(32)
window_encode_kernel(const int16_t *__restrict__ x,
                     const uint8_t *__restrict__ reset, const Geometry geo,
                     unsigned long long *__restrict__ counter,
                     const long long *__restrict__ list,
                     const uint32_t *__restrict__ ckpt,
                     const long long *__restrict__ bounds,
                     const uint8_t *__restrict__ starts,
                     uint8_t *__restrict__ bytes,
                     uint8_t *__restrict__ sidx_even) {
    __shared__ Tables tb;
    __shared__ __align__(16) EncodeSmem sm;
    load_tables(tb);
    const int lane = threadIdx.x;
    const long long n_seg = (long long)counter[1];
    for (long long k0 = 32 * next_window(counter + 2, lane); k0 < n_seg;
         k0 = 32 * next_window(counter + 2, lane)) {
        long long t = 0, end = 0, orow = 0;   // t, end: in the x buffer
        State st;
        st.start(0, tb);
        if (k0 + lane < n_seg) {
            const long long u = list[k0 + lane];
            const long long g = u >> 24, q = u & 0xFFFFFF;
            const long long base = g % (geo.B * geo.W), c = g / geo.W;
            const long long row = base / geo.W * geo.n;
            const long long a = bounds[2 * base] + q * kTile;
            t = row + a;
            end = row + min(a + kTile, bounds[2 * base + 1]);
            orow = c * (geo.n / 2) - row / 2;
            st.start(starts[g], tb);
            if (q > 0) {              // resume from pass 1's checkpoint
                const uint32_t v =
                    ckpt[(c * geo.CK + a / kTile) * 89 + st.index()];
                st.p = (int16_t)(v & 0xFFFF);
                st.ix = (int)(v >> 16);
                st.step = tb.step[st.ix >> 3];
            }
        }
        __syncwarp();
        const long long n_all = geo.B * geo.n;
        prefetch(x, reset, n_all, sm, 0, t, end, lane);
        for (int bi = 0; __any_sync(kFull, t < end); bi ^= 1) {
            prefetch(x, reset, n_all, sm, bi ^ 1, t + 2 * kPairs, end, lane);
            asm volatile("cp.async.wait_group 1;\n" ::);
            __syncwarp();
            const int cnt = (int)max(0ll, min((long long)kPairs,
                                              (end - t) / 2));
            const uint8_t *rb = reinterpret_cast<const uint8_t *>(
                sm.r[bi][lane]) + (t & 3);
            for (int k = 0; k < cnt; k++) {
                const uint32_t v = sm.x[bi][lane][k];
                const uint16_t r = *reinterpret_cast<const uint16_t *>(
                    rb + 2 * k);
                sm.sidx[lane][k] = (uint8_t)st.index();
                if (r & 0xFF) st.p = (int16_t)(v & 0xFFFF);
                const int n0 = st.compress((int16_t)(v & 0xFFFF), tb);
                if (r >> 8) st.p = (int16_t)(v >> 16);
                const int n1 = st.compress((int16_t)(v >> 16), tb);
                sm.bytes[lane][k] = (uint8_t)((n0 << 4) | n1);
            }
            __syncwarp();
            for (int l = 0; l < 32; l++) {       // store lane l's run
                const int c = __shfl_sync(kFull, cnt, l);
                const long long o = __shfl_sync(kFull, orow + t / 2, l);
                for (int k = lane; k < c; k += 32) {
                    bytes[o + k] = sm.bytes[l][k];
                    sidx_even[o + k] = sm.sidx[l][k];
                }
            }
            __syncwarp();
            t += 2 * kPairs;
        }
        asm volatile("cp.async.wait_group 0;\n" ::);
    }
}


// The scratch kernel Q needs, carved from one buffer: the window maps
// ends [R B W, 96], the segment bounds int64 [B W, 2], pass 1's list of
// segments int64 [R B W], three counters uint64 (pass 1's windows, the
// list's length, pass 3's batches), the group maps gmaps [R B NG, 96],
// the group starts [R B NG] and the window starts [R B W]; W = ceil(n /
// kWindow), NG = ceil(W / kGroup).
struct Scratch {
    uint8_t *ends;
    uint32_t *ckpt;
    long long *bounds, *list;
    unsigned long long *counters;
    uint8_t *gmaps, *gstart, *starts;
    long long bytes;
};

Scratch carve(uint8_t *base, long long B, long long n, long long repeat) {
    const long long W = (n + kWindow - 1) / kWindow;
    const long long NG = (W + kGroup - 1) / kGroup;
    const long long rw = repeat * B * W, rg = repeat * B * NG;
    const long long rc = repeat * B * (n / kTile + 1);
    Scratch s;
    long long at = 0;
    auto take = [&](long long bytes) {
        uint8_t *p = base ? base + at : nullptr;
        at += (bytes + 15) & ~15ll;
        return p;
    };
    s.ends = take(rw * kMap);
    s.bounds = (long long *)take(B * W * 16);
    s.list = (long long *)take((rw + rc) * 8);
    s.ckpt = (uint32_t *)take(rc * 89 * 4);
    s.counters = (unsigned long long *)take(3 * 8);
    s.gmaps = take(rg * kMap);
    s.gstart = take(rg);
    s.starts = take(rw);
    s.bytes = at;
    return s;
}

}  // namespace

extern "C" long long amv_adpcm_encode_scratch(long long B, long long n,
                                              long long repeat) {
    return carve(nullptr, B, n, repeat).bytes;
}

// x int16 [B, n], reset bool [B, n], sidx0 int32 [B] -> bytes and
// sidx_even uint8 [B * repeat, n / 2]; scratch: amv_adpcm_encode_scratch
// bytes, 16-byte aligned.
extern "C" int amv_adpcm_encode(const void *x, const void *reset,
                                const void *sidx0, long long B, long long n,
                                long long repeat, void *scratch, void *bytes, void *sidx_even,
                                void *stream) {
    if (B > 0 && n > 0) {
        const cudaStream_t st = (cudaStream_t)stream;
        const long long W = (n + kWindow - 1) / kWindow;
        const Geometry geo{B, n, W, (W + kGroup - 1) / kGroup, n / kTile + 1};
        const long long n_win = repeat * B * W, n_grp = repeat * B * geo.NG;
        const unsigned grid = (unsigned)((n_win + kWarps - 1) / kWarps);
        const Scratch sc = carve((uint8_t *)scratch, B, n, repeat);
        unsigned long long *count = sc.counters;
        void *ends = sc.ends, *bounds = sc.bounds, *list = sc.list;
        void *gmaps = sc.gmaps, *gstart = sc.gstart, *starts = sc.starts;
        int rc = (int)cudaMemsetAsync(count, 0, 3 * 8, st);
        if (rc) return rc;
        window_ends_kernel<<<grid, 32 * kWarps, 0, st>>>(
            (const int16_t *)x, (const uint8_t *)reset, geo, n_win, count,
            (uint8_t *)ends, (long long *)bounds, (long long *)list,
            sc.ckpt);
        if ((rc = (int)cudaGetLastError())) return rc;
        group_maps_kernel<<<(unsigned)n_grp, kSlots, 0, st>>>(
            (const uint8_t *)ends, geo, (uint8_t *)gmaps);
        if ((rc = (int)cudaGetLastError())) return rc;
        group_chain_kernel<<<(unsigned)(repeat * B), 128, 0, st>>>(
            (const uint8_t *)gmaps, (const int32_t *)sidx0, geo,
            (uint8_t *)gstart);
        if ((rc = (int)cudaGetLastError())) return rc;
        window_chain_kernel<<<(unsigned)n_grp, 128, 0, st>>>(
            (const uint8_t *)ends, (const uint8_t *)gstart, geo,
            (uint8_t *)starts);
        if ((rc = (int)cudaGetLastError())) return rc;
        const long long n_units = n_win + repeat * B * geo.CK;
        window_encode_kernel<<<(unsigned)((n_units + 31) / 32), 32, 0, st>>>(
            (const int16_t *)x, (const uint8_t *)reset, geo, count,
            (const long long *)list, sc.ckpt, (const long long *)bounds,
            (const uint8_t *)starts, (uint8_t *)bytes, (uint8_t *)sidx_even);
    }
    return (int)cudaGetLastError();
}
