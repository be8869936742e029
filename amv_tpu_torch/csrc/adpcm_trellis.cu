// Kernel L: the Viterbi IMA-ADPCM (AMV) quantizer of `-trellis`, a warp
// per chunk.
//
// Not the port of a Pallas kernel: the JAX package runs this quantizer on
// the host in numpy (amv_tpu/codecs/adpcm_trellis.py:trellis_encode_fast),
// and the port must do what the JAX package does.  Semantics, bit for bit:
// per sample, each of the 89 step indices takes the best of its in-edges
// (a source state s and a nibble nb with clip(s + index(nb), 0, 88) = d):
// the least int64 sum of squared errors ssd[s] + (p - x)^2, with the
// candidate predictor p = clip(pred[s] +- ((2 (nb & 7) + 1) step[s]) >> 3,
// -32768, 32767); the in-edges are scanned source ascending, then nibble
// ascending, and the first minimum wins.  A source of ssd >= 2^60 (INF,
// unreachable) gives INF, and a row of INF takes in-edge 0 with its
// predictor, as numpy's argmin does.  The final state is the lowest index
// of least ssd, and the nibbles are read back from it through the
// winning in-edge of every (sample, state).
//
// The chunks form a chain (chunk k + 1 starts from chunk k's final state);
// the wrapper resolves it in rounds of launches, each over the chunks whose
// start changed (kernels/adpcm_trellis.py:encode_chain).
//
// What bounds it: the integer operations.  The yardstick counts all 1,424
// in-edges of a sample at ~16 operations each; this design evaluates each
// in-edge's error in 32 bits (1,157 of the 1,424: the -1 move's far group
// needs only its m = 0) and forms 445 int64 keys a sample (5 per state),
// ~265 instructions of the integer pipe a lane a sample.  Design, for the
// H100's 64 integer lanes an SM:
//
// * A warp per chunk, kChunks chunks a CTA, no block barrier.  Lane l
//   holds states 3l, 3l + 1 and 3l + 2 in registers (the key base ssd <<
//   11 | 16 s, the predictor less the sample, the step's eight
//   differences, which come back through shared memory once so that the
//   compiler keeps them as values); states 89..95 are dummies kept >= INF.
// * Push, not pull: each state, as a source, forms one record for each of
//   its five moves (index -1: the best of its 8 nibbles 0-3 and 8-11;
//   index +2, +4, +6, +8: the better of nibbles m and m + 8), and the
//   warp hands the records' keys to their targets with __shfl_sync (12
//   64-bit keys a lane a sample); a target takes the least of its five in
//   a tree, the -1 move's (the longest to form) last.  Within a move's
//   candidates the errors compare in 32 bits: the -1 group by the key
//   |p - x| * 16 + nibble, whose minimum is the first minimum in nibble
//   order (the group on the side of e = pred - x has its minimum at m = 0,
//   so four candidates and that one); a +- pair by tp <= tn, where tp =
//   min(e + d, hi) and tn = min(-e + d, x + 32768) are the two clipped
//   errors with the second negated (|tp| <= |tn| for tp >= -tn; the
//   +-32767 clip stays exact, ties go to the + nibble).
// * Order without branches: a record's key is (ssd + err^2) << 11 | (16 s
//   + nibble), so the least key is the first minimum in the in-edge order
//   (source, then nibble) and the ordering costs nothing at the targets.
//   Sums stay below 2^49 for chunks of up to 2^17 samples (checked by the
//   wrapper), keys below 2^60; INF in this design is 2^61 (a state's key
//   >= 2^61 is unreachable; ORed into the dummies after every sample),
//   since only reachable states reach the bytes and the final state.
// * A record's error (for the new predictor) goes to a table in shared
//   memory at word 17 s + (nibble & 7), and the target reads its winner's
//   by the key's rank: the merges move and select keys only.
// * The clipped targets: the records into state 0 are the index -1 moves
//   of sources 0 and 1 (lane 0 puts source 0's in place of the wrapped
//   shuffle's); state 88's 24 +- pairs from sources 80..88 land on the
//   unclipped targets 88..96, i.e. on state 88, the dummies 89..95 and one
//   record (88, +8), and lanes 29..31 reduce them onto state 88.
// * Back-pointers: 4 bits a (sample, state) -- the nibble, which names the
//   source for states 1..87; state 0 sets bit 2 for source 1 (its nibbles
//   leave it 0), and state 88's source less 80 takes dummy state 89's
//   slot.  A lane packs 8 samples of its three states into three words
//   and the warp stores them coalesced: 384 bytes every 8 samples, 66 KB
//   a chunk of 1,378 samples, too much to keep on chip for more than
//   three chunks an SM, so they go to device memory (half the bytes of
//   one byte a state) and come back in windows of kWindowGroups words
//   (128 samples, 6 KB) staged in shared memory, where lane 0 walks the
//   traceback and writes the packed bytes, high nibble first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunks = 4;            // warps (chunks) a CTA
constexpr int kThreads = 32 * kChunks;
constexpr int kGroup = 8;             // samples a back-pointer word
constexpr int kWords = 96;            // words a group: 3 slots x 32 lanes
constexpr int kWindowGroups = 16;     // traceback window: 128 samples
constexpr int kArea = 96 * 17;        // words a warp: the errors' table
constexpr int kMinWarps = 16;         // resident warps an SM (<= 128
                                      // registers a thread)
constexpr int kRankBits = 11;
constexpr unsigned long long kInf = 1ULL << 61;
constexpr unsigned kInfHi = (unsigned)(kInf >> 32);
constexpr unsigned kFull = 0xffffffffu;

__constant__ int16_t kStepTable[89] = {
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37, 41,
    45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173, 190,
    209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658, 724,
    796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066, 2272,
    2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894, 6484, 7132,
    7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289, 16818, 18500,
    20350, 22385, 24623, 27086, 29794, 32767};

typedef unsigned long long u64;

// the lesser of two keys (the keys of one target differ in their rank)
__device__ __forceinline__ u64 lo(u64 a, u64 b) { return b < a ? b : a; }

__device__ __forceinline__ u64 shfl(u64 v, int src) {
    return __shfl_sync(kFull, v, src);
}

// base (ssd << 11 | 16 source | nibble) plus err^2 << 11
__device__ __forceinline__ u64 key(u64 base, int tw) {
    return base + (u64)((long long)tw * (long long)(tw * (1 << kRankBits)));
}

__global__ void __launch_bounds__(kThreads, kMinWarps / kChunks)
trellis_kernel(const int16_t *__restrict__ x,
               const long long *__restrict__ starts,
               const int32_t *__restrict__ pairs,
               const int32_t *__restrict__ step0,
               const int32_t *__restrict__ pred0, long long a,
               long long groups_max, uint32_t *__restrict__ back,
               uint8_t *__restrict__ out, int32_t *__restrict__ final_state) {
    // a warp's own area: each sample's errors (tw of source s and move m at
    // word 17 s + m), then the traceback's window
    __shared__ int32_t s_area[kChunks][kArea];
    __shared__ int4 s_diff[kChunks][96 * 2];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const long long c = (long long)blockIdx.x * kChunks + w;
    if (c >= a) return;                         // the whole warp
    const long long start = starts[c];
    const int len = 2 * pairs[c];
    const int st0 = step0[c];
    const int16_t *xl = x + start;
    uint32_t *bl = back + c * groups_max * kWords;
    int32_t *area = s_area[w];

    // the lane's three states: base = ssd << 11 | 16 q (| INF), e = pred - x
    const int l1 = (lane + 31) & 31, l2 = (lane + 30) & 31,
              l3 = (lane + 29) & 31, lp = (lane + 1) & 31;
    const bool is0 = lane == 0, is29 = lane == 29, is31 = lane == 31;
    int s16[3], step[3];
    unsigned poison[3];
    u64 base[3];
    int e[3];
    int xv = lane < len ? xl[lane] : 0;
    int xv2 = 32 + lane < len ? xl[32 + lane] : 0;
    int xc = __shfl_sync(kFull, xv, 0);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        const int q = 3 * lane + j;
        step[j] = kStepTable[min(q, 88)];
        int dq[8];
#pragma unroll
        for (int m = 0; m < 8; ++m) dq[m] = ((2 * m + 1) * step[j]) >> 3;
        s_diff[w][2 * q] = make_int4(dq[0], dq[1], dq[2], dq[3]);
        s_diff[w][2 * q + 1] = make_int4(dq[4], dq[5], dq[6], dq[7]);
        s16[j] = q << 4;
        poison[j] = q > 88 ? kInfHi : 0u;
        base[j] = (q == st0 ? 0ULL : kInf) | (unsigned)s16[j];
        e[j] = (q == st0 ? pred0[c] : 0) - xc;
    }
    // the step differences come back through shared memory, so that the
    // compiler keeps them as values in registers (one fused add-and-min a
    // candidate) rather than rebuilding them from the step at every use
    __syncwarp();
    int d[3][8];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        const int4 da = s_diff[w][6 * lane + 2 * j];
        const int4 db = s_diff[w][6 * lane + 2 * j + 1];
        d[j][0] = da.x, d[j][1] = da.y, d[j][2] = da.z, d[j][3] = da.w;
        d[j][4] = db.x, d[j][5] = db.y, d[j][6] = db.z, d[j][7] = db.w;
    }
    int32_t *tws = area + 17 * (3 * lane);       // this lane's sources

    for (int g0 = 0; g0 < len; g0 += kGroup) {
        if (g0 > 0 && (g0 & 31) == 0) {         // the next 32 samples
            xv = xv2;
            xv2 = g0 + 32 + lane < len ? xl[g0 + 32 + lane] : 0;
        }
        const int ng = min(kGroup, len - g0);
        uint32_t acc[3] = {0, 0, 0};
        for (int r = 0; r < ng; ++r) {
        const int r32 = (g0 + r) & 31;
        const int x0 = xc;
        xc = __shfl_sync(kFull, r32 == 31 ? xv2 : xv, (r32 + 1) & 31);
        const int hi = 32767 - x0, nlo = x0 + 32768, dx = x0 - xc;

        // index -1: nibbles 0-3 (err min(e + d, hi)) and 8-11 (-err min(-e
        // + d, x + 32768)).  The group on the side of e's sign is >= 0 and
        // nondecreasing in m, so its m = 0 is its first minimum ("far");
        // the other group crosses 0: all four by the key |err| * 16 + m.
        u64 av[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            const int E = abs(e[j]), nE = -E;
            const bool pos = e[j] >= 0;        // the crossing group is -
            const int H = pos ? nlo : hi, Hf = 65535 - H;   // hi + nlo
            const unsigned n8 = pos ? 8u : 0u;
            int kv[4];
#pragma unroll
            for (int m = 0; m < 4; ++m)
                kv[m] = abs(__viaddmin_s32(nE, d[j][m], H)) * 16 + m;
            const int kc = min(__vimin3_s32(kv[0], kv[1], kv[2]), kv[3]);
            const int f = __viaddmin_s32(E, d[j][0], Hf);
            const int kf = f * 16 + (int)(n8 ^ 8u);
            const int kb = min(kc | (int)n8, kf);
            const unsigned nb = (unsigned)kb & 15;
            const int dd = ((2 * (int)(nb & 3) + 1) * step[j]) >> 3;
            const int tw = kb == kf ? f : __viaddmin_s32(nE, dd, H);
            tws[17 * j + (nb & 7)] = tw;
            av[j] = key(base[j] | nb, tw);
        }
        // index +8, +6, +4, +2: the pairs m = 7..4 to state s + 2m - 6;
        // tp = min(e + d, hi) is the + nibble's error and tn = min(-e + d,
        // x + 32768) minus the - nibble's; + wins iff |tp| <= |tn|, i.e.
        // tp <= tn (tp >= -tn always), and the record keeps min(tp, tn)
        u64 bv[4][3];
#pragma unroll
        for (int m = 4; m < 8; ++m)
#pragma unroll
            for (int j = 0; j < 3; ++j) {
                bool plus;
                const int tw = __vibmin_s32(
                    __viaddmin_s32(e[j], d[j][m], hi),
                    __viaddmin_s32(-e[j], d[j][m], nlo), &plus);
                tws[17 * j + m] = tw;
                bv[m - 4][j] = key(base[j] | (unsigned)m | (plus ? 0u : 8u),
                                   tw);
            }
        __syncwarp();
        // the keys into each target (its five sources), merged as a tree
        // with the -1 move's (the longest to form) last
        u64 in7[3], in6[3], in5[3], in4[3];
        in7[0] = shfl(bv[3][1], l3);
        in7[1] = shfl(bv[3][2], l3);
        in7[2] = shfl(bv[3][0], l2);
        in6[0] = shfl(bv[2][0], l2);
        in6[1] = shfl(bv[2][1], l2);
        in6[2] = shfl(bv[2][2], l2);
        in5[0] = shfl(bv[1][2], l2);
        in5[1] = shfl(bv[1][0], l1);
        in5[2] = shfl(bv[1][1], l1);
        in4[0] = shfl(bv[0][1], l1);
        in4[1] = shfl(bv[0][2], l1);
        in4[2] = bv[0][0];
        u64 ina = shfl(av[0], lp);
        if (is31) ina |= kInf;                  // wrapped from lane 0
        if (is0) in7[0] = av[0];                // state 0: source 0's -1
        u64 best[3];
        best[0] = lo(lo(lo(in7[0], in6[0]), lo(in5[0], in4[0])), av[1]);
        best[1] = lo(lo(lo(in7[1], in6[1]), lo(in5[1], in4[1])), av[2]);
        best[2] = lo(lo(lo(in7[2], in6[2]), lo(in5[2], in4[2])), ina);

        // state 88: the least of targets 88..95 (lanes 29..31) and (88, +8)
        {
            const u64 t = lo(lo(best[1], best[2]), is29 ? bv[3][1] : best[0]);
            const u64 f = lo(t, lo(shfl(t, 30), shfl(t, 31)));
            if (is29) best[1] = f;
        }

        // the new states and their back-pointers; a winner's error from the
        // table by its rank (word 17 s + (nibble & 7))
        uint32_t code[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            const unsigned k = (unsigned)best[j];
            const unsigned idx = k & 0x7f7;
            const int tw = area[idx + (idx >> 4)];
            code[j] = k & 15;
            e[j] = dx + (k & 8 ? -tw : tw);
            base[j] = (best[j] & ~((1ULL << kRankBits) - 1)) |
                      ((u64)poison[j] << 32) | (unsigned)s16[j];
        }
        __syncwarp();
        // state 0: bit 2 names source 1; dummy 89: state 88's source - 80
        if (is0) code[0] |= ((unsigned)best[0] >> 2) & 4;
        if (is29) code[2] = ((((unsigned)best[1] >> 4) & 127) - 80) & 15;
#pragma unroll
        for (int j = 0; j < 3; ++j) acc[j] = acc[j] << 4 | code[j];
        }
        const int g = g0 / kGroup, sh = 4 * (kGroup - ng);
#pragma unroll
        for (int j = 0; j < 3; ++j) bl[(g * 3 + j) * 32 + lane] = acc[j] << sh;
    }

    // the final state: the lowest index of least ssd
    unsigned long long fk = kInf << 1;
#pragma unroll
    for (int j = 0; j < 3; ++j)
        fk = min(fk, (base[j] & ~((1ULL << kRankBits) - 1)) |
                         (unsigned long long)(3 * lane + j));
#pragma unroll
    for (int off = 16; off; off >>= 1)
        fk = min(fk, __shfl_sync(kFull, fk, lane ^ off));
    int s = (int)(fk & 127);
    if (lane == 0) final_state[c] = s;

    // the traceback, a window of kWindowGroups groups at a time
    uint32_t *win = (uint32_t *)area;
    uint8_t *o = out + start / 2;
    const int groups = (len + kGroup - 1) / kGroup;
    int lo_nib = 0;
    for (int g0 = (groups - 1) / kWindowGroups * kWindowGroups; g0 >= 0;
         g0 -= kWindowGroups) {
        const int ng = min(kWindowGroups, groups - g0);
        __syncwarp();
        for (int t = lane; t < ng * kWords; t += 32)
            win[t] = bl[g0 * kWords + t];
        __syncwarp();
        if (lane == 0) {
            for (int i = min(len, (g0 + ng) * kGroup) - 1; i >= g0 * kGroup;
                 --i) {
                const uint32_t *wg = win + (i / kGroup - g0) * kWords;
                const int sh = 4 * (7 - (i & 7));
                const int s3 = s / 3;
                const int code = (wg[(s - 3 * s3) * 32 + s3] >> sh) & 15;
                int nib = code, prev;
                if (s == 0) {
                    nib = code & 11;
                    prev = (code >> 2) & 1;
                } else if (s == 88) {
                    prev = 80 + ((wg[2 * 32 + 29] >> sh) & 15);
                } else {
                    const int m = code & 7;
                    prev = m < 4 ? s + 1 : s + 6 - 2 * m;
                }
                if (i & 1)
                    lo_nib = nib;
                else
                    o[i >> 1] = (uint8_t)(nib << 4 | lo_nib);
                s = prev;
            }
        }
    }
}

}  // namespace

// Back-pointer scratch bytes for a chunks of up to len_max samples.
extern "C" long long amv_trellis_scratch(long long a, long long len_max) {
    return a * ((len_max + kGroup - 1) / kGroup) * kWords * 4;
}

// x int16 [total], starts int64 [a] (even), pairs int32 [a] (a chunk is
// 2 * pairs samples, at most len_max <= 2^17), step0 int32 [a] in 0..88,
// pred0 int32 [a]; back: amv_trellis_scratch(a, len_max) bytes, 4-byte
// aligned; out uint8 [total / 2] (chunk k's bytes at starts[k] / 2),
// final_state int32 [a].
extern "C" int amv_trellis(const void *x, const void *starts,
                           const void *pairs, const void *step0,
                           const void *pred0, long long a, long long len_max,
                           void *back, void *out, void *final_state,
                           void *stream) {
    if (len_max < 0 || len_max > (1LL << 17))
        return (int)cudaErrorInvalidValue;
    if (a > 0)
        trellis_kernel<<<(unsigned)((a + kChunks - 1) / kChunks), kThreads, 0,
                         (cudaStream_t)stream>>>(
            (const int16_t *)x, (const long long *)starts,
            (const int32_t *)pairs, (const int32_t *)step0,
            (const int32_t *)pred0, a, (len_max + kGroup - 1) / kGroup,
            (uint32_t *)back, (uint8_t *)out, (int32_t *)final_state);
    return (int)cudaGetLastError();
}
