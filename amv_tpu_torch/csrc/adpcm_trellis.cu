// Kernel L: the Viterbi IMA-ADPCM (AMV) quantizer of `-trellis`, a CTA
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
// What bounds it: the operations.  A sample scans all 1,424 in-edges of
// the 89 states (about 16 integer operations each, int64 sums among them),
// against 89 bytes of back-pointers written and 2 read.  Design: one CTA of
// 96 threads per chunk.  Thread d < 88 takes state d (8 to 16 in-edges);
// state 88 has 48, so threads 88, 89 and 90 take 16 of them each and thread
// 88 merges the three in order, so no warp scans more than 16.  Each thread
// keeps its in-edges' source and step difference in registers; ssd and the
// predictor are double-buffered in shared memory, one __syncthreads() a
// sample.  The winning in-edge index goes to a scratch of one byte per
// (sample, state) in device memory (122.6 KB a chunk at 22,050 Hz and 16
// fps, 327 KB at 44,100 Hz and 12 fps: too much for shared memory at the
// larger rate), and one thread walks the traceback and writes the packed
// bytes, high nibble first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStates = 89;
constexpr int kEdges = 48;      // the most in-edges of a state (state 88)
constexpr int kSplit = 16;      // the most in-edges a thread scans
constexpr int kThreads = 96;
constexpr long long kInf = 1LL << 60;

__constant__ int16_t kStepTable[89] = {
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37, 41,
    45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173, 190,
    209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658, 724,
    796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066, 2272,
    2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894, 6484, 7132,
    7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289, 16818, 18500,
    20350, 22385, 24623, 27086, 29794, 32767};
__constant__ int8_t kIndexTable[8] = {-1, -1, -1, -1, 2, 4, 6, 8};

__global__ void __launch_bounds__(kThreads)
trellis_kernel(const int16_t *__restrict__ x,
               const long long *__restrict__ starts,
               const int32_t *__restrict__ pairs,
               const int32_t *__restrict__ step0,
               const int32_t *__restrict__ pred0, long long len_max,
               uint8_t *__restrict__ back, uint8_t *__restrict__ out,
               int32_t *__restrict__ final_state) {
    __shared__ long long s_ssd[2][kThreads];
    __shared__ int32_t s_pred[2][kThreads];
    __shared__ uint8_t s_src[kEdges * kThreads];   // [in-edge][state]
    __shared__ uint8_t s_nib[kEdges * kThreads];
    __shared__ long long s_part_ssd[2];             // threads 89 and 90
    __shared__ int32_t s_part_pred[2], s_part_k[2];

    const int t = threadIdx.x;
    const long long lane = blockIdx.x;
    // the in-edges of state t, in the order source, nibble
    int cnt = 0;
    if (t < kStates) {
        for (int s = 0; s < kStates; ++s)
            for (int nb = 0; nb < 16; ++nb)
                if (min(max(s + kIndexTable[nb & 7], 0), kStates - 1) == t) {
                    s_src[cnt * kThreads + t] = (uint8_t)s;
                    s_nib[cnt * kThreads + t] = (uint8_t)nb;
                    ++cnt;
                }
    }
    // this thread's state and in-edges [k0, k0 + m)
    int d = t, k0 = 0, m = t < kStates - 1 ? cnt : 0;
    if (t >= kStates - 1 && t < kStates + 2) {
        d = kStates - 1;
        k0 = (t - (kStates - 1)) * kSplit;
        m = kSplit;
    }
    const long long start = starts[lane];
    const int len = 2 * pairs[lane];
    const int st0 = step0[lane];
    if (t < kStates) {
        s_ssd[0][t] = t == st0 ? 0 : kInf;
        s_pred[0][t] = t == st0 ? pred0[lane] : 0;
    }
    __syncthreads();
    int r_src[kSplit], r_sd[kSplit];
#pragma unroll
    for (int j = 0; j < kSplit; ++j) {
        const int k = k0 + j;
        r_src[j] = 0;
        r_sd[j] = 0;
        if (j < m) {
            const int s = s_src[k * kThreads + d], nb = s_nib[k * kThreads + d];
            const int diff = ((2 * (nb & 7) + 1) * kStepTable[s]) >> 3;
            r_src[j] = s;
            r_sd[j] = nb & 8 ? -diff : diff;
        }
    }

    uint8_t *bl = back + lane * len_max * kStates;
    const int16_t *xl = x + start;
    int cur = 0;
    int xv = len > 0 ? xl[0] : 0;
    for (int i = 0; i < len; ++i) {
        const int xt = xv;
        if (i + 1 < len) xv = xl[i + 1];
        const long long *ss = s_ssd[cur];
        const int32_t *pp = s_pred[cur];
        long long best = kInf;
        int bpred = 0, bk = k0;
#pragma unroll
        for (int j = 0; j < kSplit; ++j) {
            if (j < m) {
                const int s = r_src[j];
                const int cp = min(max(pp[s] + r_sd[j], -32768), 32767);
                const unsigned e = (unsigned)(cp - xt);
                const long long sv = ss[s];
                // |cp - xt| <= 65,535: its square fits 32 unsigned bits
                const long long c = sv >= kInf ? kInf
                                               : sv + (long long)(e * e);
                if (j == 0 || c < best) {
                    best = c;
                    bpred = cp;
                    bk = k0 + j;
                }
            }
        }
        if (t == kStates || t == kStates + 1) {
            s_part_ssd[t - kStates] = best;
            s_part_pred[t - kStates] = bpred;
            s_part_k[t - kStates] = bk;
        }
        __syncwarp();
        if (t == kStates - 1) {
            for (int p = 0; p < 2; ++p)
                if (s_part_ssd[p] < best) {
                    best = s_part_ssd[p];
                    bpred = s_part_pred[p];
                    bk = s_part_k[p];
                }
        }
        const int nxt = cur ^ 1;
        if (t < kStates) {
            s_ssd[nxt][t] = best;
            s_pred[nxt][t] = bpred;
            bl[(long long)i * kStates + t] = (uint8_t)bk;
        }
        __syncthreads();
        cur = nxt;
    }

    if (t == 0) {
        const long long *ss = s_ssd[cur];
        int s = 0;
        long long bv = ss[0];
        for (int q = 1; q < kStates; ++q)
            if (ss[q] < bv) {
                bv = ss[q];
                s = q;
            }
        final_state[lane] = s;
        uint8_t *o = out + start / 2;
        int lo = 0;
        for (int i = len - 1; i >= 0; --i) {
            const int k = bl[(long long)i * kStates + s];
            const int nib = s_nib[k * kThreads + s];
            s = s_src[k * kThreads + s];
            if (i & 1)
                lo = nib;
            else
                o[i >> 1] = (uint8_t)(nib << 4 | lo);
        }
    }
}

}  // namespace

// x int16 [total], starts int64 [a] (even), pairs int32 [a] (a chunk is
// 2 * pairs samples), step0 int32 [a] in 0..88, pred0 int32 [a]; back uint8
// [a, len_max, 89] scratch (len_max >= 2 * pairs); out uint8 [total / 2]
// (chunk k's bytes at starts[k] / 2), final_state int32 [a].
extern "C" int amv_trellis(const void *x, const void *starts,
                           const void *pairs, const void *step0,
                           const void *pred0, long long a, long long len_max,
                           void *back, void *out, void *final_state,
                           void *stream) {
    if (a > 0)
        trellis_kernel<<<(unsigned)a, kThreads, 0, (cudaStream_t)stream>>>(
            (const int16_t *)x, (const long long *)starts,
            (const int32_t *)pairs, (const int32_t *)step0,
            (const int32_t *)pred0, len_max, (uint8_t *)back, (uint8_t *)out,
            (int32_t *)final_state);
    return (int)cudaGetLastError();
}
