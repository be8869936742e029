// Kernel K: G.729 Annex A encoding of B independent streams over T frames
// in one launch (analysis-by-synthesis against the decoder's exact integer
// reconstruction).
//
// Not the port of a Pallas kernel: the JAX package encodes with the XLA
// program of amv_tpu/codecs/g729a_encoder_tpu.py:437 encode_frame_batch
// under :588 encode_frames_scan (a lax.scan over frames).  The port's plain
// version is codecs/g729a_encoder_batch.py:encode_frame_batch.
//
// What bounds it: float operations, each one an instruction (-fmad=false
// below), and a stream's frames are one chain: each frame's shadow state
// feeds the next.  A frame needs ~0.84 M of them: the pitch candidates
// that may be coded (253 in subframe 0, 30 in subframe 1), each its 820
// products and 780 sums through the impulse response and the two 40-term
// scores (0.50 M), the 2 x 8,192 ACELP combinations at 12 (0.20 M), the
// Chebyshev grid and the rest; against 320 bytes in and 64 out.
//
// Design: a CTA a stream, its shadow state (546 words) and three frames of
// input in shared memory for all T frames; 64 threads (two warps, 8 CTAs an
// SM: 1,056 streams resident on an H100) once the streams pass what the
// card holds at 128 threads and 4 CTAs an SM (528), 128 below that.
// * The pitch grid scores only the candidates that may be coded; the best
//   starts at (-1, candidate 0), which is the plain version's argmax where
//   every codable candidate scores -1.  A thread holds the impulse response
//   in registers (loaded once a subframe) and its candidate's 40 sums of
//   y, so a candidate costs 40 loads of its vector and none a product.
// * The ACELP search reads a signed matrix phi[k][l] sgn[k] sgn[l], formed
//   once a subframe (a product by +-1 is exact: a sign flip).  A thread
//   takes a pair of positions on tracks 0-1 with its two matrix rows at
//   track 3's 16 positions in registers, forms the sums' prefixes that do
//   not depend on track 3 once a track-2 position, and walks track 3 with
//   one (broadcast) matrix load a combination.  The correlation matrix is
//   40 running sums, one a diagonal (its entries are prefixes of one
//   sequence of products), mirrored.
// * Warp 0 runs the chains: the shadow decoder (g729_common.cuh's steps,
//   which G runs too), the impulse responses of both subframes and the
//   zero-input response (three lanes in step), the chosen vectors'
//   responses, d, and after the ACELP search the code vector, its energy
//   (an integer sum: any order), the gains' correlations and the 128 gain
//   pairs, with warp barriers alone; the other warps meanwhile do the
//   interpolation and the correlation matrix, and while warp 0 ends a
//   frame, warp 1 runs the next frame's head (its input, the window, the
//   autocorrelation and Levinson), which needs nothing of the shadow
//   state.  The LSF quantizer runs a warp per MA predictor, its codebooks
//   in shared memory (the constant cache serves one address a warp at a
//   time).  The input is a ring of three frames, so the past input never
//   moves.
// * Why so few shared loads: with 8 CTAs an SM, the CTAs' serial chains
//   wait on their own shared loads, so a loop that issues more of them
//   slows the other CTAs and the whole even where it runs faster itself;
//   and why one copy of the grid's loop, not a second path for lags of 40
//   and up: both measured in turns by tools/k_variants.py.
// Block and warp reductions break ties to the lowest index (the first
// maximum of torch.argmax/argmin).  Built with -DK_PHASES
// (tools/time_g729.py), thread 0 stamps each phase's cycles
// (g729_encode_phases.cuh).
//
// Numeric contract: bit for bit with the plain version (parms, state and
// hist).  Both sides perform the same float32 operations in the same order:
// every sum runs sequentially from 0.0f in the plain version's order, this
// source is built with -fmad=false (a product and a sum round separately,
// as torch's separate multiply and add do), divisions are IEEE (nvcc's
// default -prec-div=true), and cosines come from one polynomial both sides
// evaluate (cos5 here, _cos5 there) with the constants of the generated
// g729_encode_tables.cuh.  Where a sum here starts from its first product
// instead of 0.0f + it (the pitch grid's y), or adds products with 0.0
// that the plain version leaves out (the impulse response's taps before
// the impulse), the two differ at most in the sign of a zero, which no
// later operation reads (the sums it enters start from +0.0 and so never
// hold -0.0).  The integer parts equal the JAX package's; its float searches,
// which XLA sums in other orders, agree within the tolerance
// tests/test_torch_g729_encoder.py states.

#include <math.h>

#include "g729_common.cuh"
#include "g729_encode_phases.cuh"
#include "g729_encode_tables.cuh"

namespace {

using namespace g729;

constexpr int kUps = 144, kGrid = 512, kBisect = 12;
constexpr int kValid0 = 253;     // subframe 0's codable candidates
constexpr int kWin1 = 30;        // subframe 1's: 10 lags x 3 fractions
constexpr int kTriples = 512;    // ACELP positions of tracks 0-2
constexpr int kRow = kSub + 1;   // the signed matrix's row stride
constexpr int kMaxWarps = 4;

struct Shared {
    int st[kStateWords];
    float xs[3][80];             // frames t - 2, t - 1, t at slots t % 3
    // tables read at a lane's own index (the constant cache serves one
    // address a warp at a time): the LSF codebooks, the window, and the
    // 128 gain pairs' pitch gains and halved code gain factors
    int16_t cb1[128][10], cb23[32][10];
    float wlp[240];
    int gp128[128], gc128[128];
    union {                      // the analysis's arrays, then the subframes'
        struct {
            float w[240], vals[2][kGrid], d1[2][128], d23[2][8][2][32];
        } a;
        struct {
            float u[3 * kUps], phs[kSub][kRow];
        } s;
    };
    float r[11], c5[2][5], mid[2], roots[10];
    int ok[2], target[2][10], pred[2][10];
    float lq_t[2][10];
    int l1c[2][8], l23[2][8][2], err[2][8];
    int parm[16], lp[20];
    float h[2][kSub], tgt[kSub], h2[kMaxWarps][kSub];
    float y_ac[kSub], rres[kSub], dabs[kSub], y_fc[kSub];
    int sneg[kSub], fc[kSub], sp[kSub];
    int base;
    float red_v[kMaxWarps];
    int red_i[kMaxWarps];
    K_PHASE_CLOCK
};

enum Phase {
    kPhAnalysis, kPhGrid, kPhQuant, kPhShadowLsf, kPhShadowLp, kPhShadow,
    kPhSub = 6,                  // then, a subframe at kPhSub + 9 sf:
    kPhZir = 0, kPhPitch, kPhChain, kPhSigned, kPhAcelp, kPhCode,
    kPhGains, kPhUpdate, kPhTail,
    kPhases = kPhSub + 18
};

// cos(k w), k = 1..5, for w in [0, pi]: cos w = -sin(w - pi/2) by the
// polynomial of kSinCoef, then T_k+1 = 2 c T_k - T_k-1
__device__ __forceinline__ void cos5(float w, float *c) {
    const float u = w - kHalfPi, u2 = u * u;
    float s = kSinCoef[0];
#pragma unroll
    for (int k = 1; k < 5; ++k) s = s * u2 + kSinCoef[k];
    const float c1 = -((s * u2 + 1.0f) * u);
    c[0] = c1;
    c[1] = 2.0f * c1 * c1 - 1.0f;
#pragma unroll
    for (int k = 2; k < 5; ++k) c[k] = 2.0f * c1 * c[k - 1] - c[k - 2];
}

// mid + 2 sum_k c5[k] cos((k + 1) w)
__device__ __forceinline__ float cheb_value(const float *c5, float mid,
                                            float w) {
    float c[5];
    cos5(w, c);
    float s = c5[0] * c[0];
#pragma unroll
    for (int k = 1; k < 5; ++k) s = s + c5[k] * c[k];
    return mid + 2.0f * s;
}

// (v, i) before (w, j): the larger value, the lower index on a tie
__device__ __forceinline__ bool before(float v, int i, float w, int j) {
    return v > w || (v == w && i < j);
}

// The warp's best (v, i) by `before`, to every lane.  (warp)
__device__ __forceinline__ void warp_best(float &v, int &i) {
#pragma unroll
    for (int o = 16; o; o >>= 1) {
        const float ov = __shfl_xor_sync(kFull, v, o);
        const int oi = __shfl_xor_sync(kFull, i, o);
        if (before(ov, oi, v, i)) {
            v = ov;
            i = oi;
        }
    }
}

// The block's best (v, i) by `before`, to every thread.  (all threads)
template <int kThreads>
__device__ int block_best(float v, int i, Shared &S) {
    warp_best(v, i);
    if ((threadIdx.x & 31) == 0) {
        S.red_v[threadIdx.x >> 5] = v;
        S.red_i[threadIdx.x >> 5] = i;
    }
    __syncthreads();
    v = S.red_v[0];
    i = S.red_i[0];
#pragma unroll
    for (int k = 1; k < kThreads / 32; ++k)
        if (before(S.red_v[k], S.red_i[k], v, i)) {
            v = S.red_v[k];
            i = S.red_i[k];
        }
    __syncthreads();
    return i;
}

// A frame's LP analysis head on one warp: its input into the ring at
// `slot`, the window, the autocorrelation and Levinson -> c5, mid.  It
// reads and writes nothing of the frame before's subframes, so warp 1
// runs frame t + 1's while warp 0 finishes frame t.  (warp)
__device__ void lp_head(Shared &S, int lane, int slot,
                        const float *__restrict__ in) {
    for (int n = lane; n < 80; n += 32) S.xs[slot][n] = in[n] * 0.5f;
    __syncwarp();
    for (int n = lane; n < 240; n += 32)
        S.a.w[n] = S.xs[(slot + 1 + n / 80) % 3][n % 80] * S.wlp[n];
    __syncwarp();
    if (lane < 11) {
        float acc = 0.0f;
#pragma unroll 8
        for (int n = 0; n < 240; ++n)
            acc = acc + S.a.w[n] * (n + lane < 240 ? S.a.w[n + lane] : 0.0f);
        if (lane == 0) acc = fmaxf(acc * 1.0001f + 10.0f, 1e-3f);
        S.r[lane] = acc * kLagWindow[lane];
    }
    __syncwarp();
    if (lane == 0) {                      // Levinson, then P and Q deflated
        float r[11], a[11], na[11];
#pragma unroll
        for (int j = 0; j < 11; ++j) {
            r[j] = S.r[j];
            a[j] = j == 0 ? 1.0f : 0.0f;
        }
        float err = r[0];
#pragma unroll
        for (int i = 1; i < 11; ++i) {
            float acc = r[i];
#pragma unroll
            for (int j = 1; j < i; ++j) acc = acc + a[j] * r[i - j];
            const float k = err > 0.0f ? -acc / err : 0.0f;
#pragma unroll
            for (int j = 1; j <= i; ++j) na[j] = a[j] + k * a[i - j];
#pragma unroll
            for (int j = 1; j <= i; ++j) a[j] = na[j];
            err = fmaxf(err * (1.0f - k * k), 1e-6f);
        }
        float pd[11], qd[11];
        pd[0] = a[0] + 0.0f;
        qd[0] = a[0] - 0.0f;
#pragma unroll
        for (int i = 1; i < 11; ++i) {
            pd[i] = (a[i] + a[11 - i]) - pd[i - 1];
            qd[i] = (a[i] - a[11 - i]) + qd[i - 1];
        }
#pragma unroll
        for (int k = 0; k < 5; ++k) {
            S.c5[0][k] = pd[4 - k];
            S.c5[1][k] = qd[4 - k];
        }
        S.mid[0] = pd[5];
        S.mid[1] = qd[5];
    }
}

// The rest of the frame's LP analysis, from its head's c5 and mid: the
// LSF (the roots of the symmetric and antisymmetric polynomials on the
// grid, bisected), and the two-stage switched-MA LSF quantizer searched
// through the decoder's exact reconstruction (a warp per MA predictor)
// -> parm[0..3].
template <int kThreads>
__device__ void analyse(Shared &S, int tid) {
    const int lane = tid & 31, warp = tid >> 5;
    for (int j2 = tid; j2 < 2 * kGrid; j2 += kThreads) {
        const int p = j2 / kGrid, j = j2 % kGrid;
        S.a.vals[p][j] = cheb_value(S.c5[p], S.mid[p], (float)j * kPi511);
    }
    __syncthreads();
    if (warp < 2) {                      // warp p: polynomial p's roots
        const float *v = S.a.vals[warp];
        int found = 0, idx = 0;
        for (int r = 0; r < (kGrid + 31) / 32; ++r) {
            const int j = 32 * r + lane;
            unsigned m = __ballot_sync(kFull, j < kGrid - 1 &&
                                                  v[j] * v[j + 1] < 0.0f);
            while (m && found < 5) {
                if (lane == found) idx = 32 * r + __ffs(m) - 1;
                ++found;
                m &= m - 1;
            }
        }
        if (lane == 0) S.ok[warp] = found >= 5;
        if (lane < 5) {
            const int i0 = lane < found ? idx : 0;
            float lo = (float)i0 * kPi511, hi = (float)(i0 + 1) * kPi511;
            float flo = v[i0];
            for (int it = 0; it < kBisect; ++it) {
                const float mw = 0.5f * (lo + hi);
                const float fm = cheb_value(S.c5[warp], S.mid[warp], mw);
                const bool take_hi = flo * fm <= 0.0f;
                hi = take_hi ? mw : hi;
                lo = take_hi ? lo : mw;
                flo = take_hi ? flo : fm;
            }
            S.roots[5 * warp + lane] = 0.5f * (lo + hi);
        }
    }
    __syncthreads();
    K_STAMP(S, kPhGrid);
    // ---- the LSF quantizer: warp l0 searches MA predictor l0
    if (warp < 2) {
        const int l0 = warp;
        if (lane < 10) {                 // the sorted LSF's Q13 target
            const float l = S.roots[lane];
            int rank = 0;
#pragma unroll
            for (int j = 0; j < 10; ++j) {
                const float o = S.roots[j];
                rank += o < l || (o == l && j < lane);
            }
            const bool ok = S.ok[0] && S.ok[1];
            const int tg = (int)rintf(fminf(
                fmaxf((ok ? l : kUniformLsf[rank]) * 8192.0f, 40.0f),
                25681.0f));
            S.target[l0][rank] = tg;
        }
        __syncwarp();
        if (lane < 10) {
            int pred = 0;
#pragma unroll
            for (int k = 0; k < 4; ++k)
                pred = wadd(pred, wmul(S.st[kLqPrev + 10 * k + lane],
                                       kMaPred[l0][k][lane]));
            S.pred[l0][lane] = pred;
            S.lq_t[l0][lane] = ((float)S.target[l0][lane] * 32768.0f -
                                (float)pred) / (float)kMaSum[l0][lane];
        }
        __syncwarp();
        for (int c = lane; c < 128; c += 32) {
            float acc = 0.0f;
#pragma unroll
            for (int i = 0; i < 10; ++i)
                acc = acc + fabsf((float)S.cb1[c][i] - S.lq_t[l0][i]);
            S.a.d1[l0][c] = acc;
        }
        __syncwarp();
        // the 8 least distances, ascending, ties to the lower index: 8
        // rounds of a warp minimum (the larger negated distance) over the
        // entries c = lane + 32 j not yet taken
        unsigned taken = 0;
        float nd[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) nd[j] = -S.a.d1[l0][lane + 32 * j];
        for (int r = 0; r < 8; ++r) {
            float v = -INFINITY;
            int i = 1 << 30;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = lane + 32 * j;
                if (!(taken >> j & 1) && before(nd[j], c, v, i)) {
                    v = nd[j];
                    i = c;
                }
            }
            warp_best(v, i);
            if ((i & 31) == lane) taken |= 1u << (i >> 5);
            if (lane == 0) S.l1c[l0][r] = i;
        }
        __syncwarp();
        for (int q = lane; q < 512; q += 32) {
            const int j = q & 31, half = (q >> 5) & 1, k = q >> 6;
            const int c1 = S.l1c[l0][k];
            float acc = 0.0f;
#pragma unroll
            for (int i0 = 0; i0 < 5; ++i0) {
                const int i = 5 * half + i0;
                const float resid = S.lq_t[l0][i] - (float)S.cb1[c1][i];
                const float e = (float)S.cb23[j][i] - resid;
                acc = acc + e * e;
            }
            S.a.d23[l0][k][half][j] = acc;
        }
        __syncwarp();
        if (lane < 16) {
            const float *d = S.a.d23[l0][lane >> 1][lane & 1];
            int best = 0;
            for (int j = 1; j < 32; ++j)
                if (d[j] < d[best]) best = j;
            S.l23[l0][lane >> 1][lane & 1] = best;
        }
        __syncwarp();
        if (lane < 8) {                  // each candidate's exact error
            const int k = lane, c1 = S.l1c[l0][k];
            int lq[10];
#pragma unroll
            for (int i = 0; i < 10; ++i)
                lq[i] = S.cb1[c1][i] + S.cb23[S.l23[l0][k][i / 5]][i];
#pragma unroll
            for (int J = 10; J >= 5; J -= 5)
#pragma unroll
                for (int i = 1; i < 10; ++i) {
                    const int diff = (lq[i - 1] - lq[i] + J) >> 1;
                    if (diff > 0) {
                        lq[i - 1] -= diff;
                        lq[i] += diff;
                    }
                }
            int err = 0;
#pragma unroll
            for (int i = 0; i < 10; ++i) {
                const int rec = wadd(wmul(lq[i], kMaSum[l0][i]),
                                     S.pred[l0][i]) >> 15;
                const int e = wsub(rec, S.target[l0][i]);
                err = wadd(err, wmul(e, e));
            }
            S.err[l0][k] = err;
        }
    }
    __syncthreads();
    if (tid == 0) {
        int bl0 = 0, bk = 0, be = 0;
        for (int l0 = 0; l0 < 2; ++l0) {
            int k = 0;
            for (int j = 1; j < 8; ++j)
                if (S.err[l0][j] < S.err[l0][k]) k = j;
            if (l0 == 0 || S.err[l0][k] < be) {
                bl0 = l0;
                bk = k;
                be = S.err[l0][k];
            }
        }
        S.parm[0] = bl0;
        S.parm[1] = S.l1c[bl0][bk];
        S.parm[2] = S.l23[bl0][bk][0];
        S.parm[3] = S.l23[bl0][bk][1];
    }
    __syncthreads();
    K_STAMP(S, kPhQuant);
}

// 1/A(z) of subframe sf's LP filter run for 40 samples (lanes 0-2 of warp
// 0 in step): lane j < 2 the impulse response of subframe j into h[j]
// (from rest, s_0 = 1), lane 2 subframe sf's zero-input response from the
// synthesis memory, subtracted from the input into tgt.  s_n = -sum_i a_i
// s_n-1-i, the sum from 0.0f with i ascending; the impulse response's taps
// before the impulse are products with 0.0, which the plain version leaves
// out (their sum differs at most in a zero's sign, which s_n does not
// keep: see the contract above).  `with_h`: lanes 0-1 run too.  (lanes)
__device__ __forceinline__ void responses(Shared &S, int lane, int sf,
                                          const float *x, bool with_h) {
    const bool imp = lane < 2;
    if (lane > 2 || (imp && !with_h)) return;
    const int s = imp ? lane : sf;
    float a[10], y[10 + kSub];
#pragma unroll
    for (int i = 0; i < 10; ++i) {
        a[i] = (float)S.lp[10 * s + i] / 4096.0f;
        y[i] = imp ? 0.0f : (float)S.st[kSynMem + i];
    }
#pragma unroll
    for (int n = 0; n < kSub; ++n) {
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < 10; ++i) acc = acc + a[i] * y[n + 9 - i];
        y[10 + n] = imp && n == 0 ? 1.0f : -acc;
    }
    if (imp) {
#pragma unroll
        for (int n = 0; n < kSub; ++n) S.h[s][n] = y[10 + n];
    } else {
#pragma unroll
        for (int n = 0; n < kSub; ++n) S.tgt[n] = x[kSub * sf + n] - y[10 + n];
    }
}

// The interpolation at its 3 phases over the last 144 positions before
// subframe sf, threads `from`, `from` + step, ...
__device__ __forceinline__ void interpolate(Shared &S, int sf, int from,
                                            int step) {
    const int *exc = S.st + kExc;
    for (int q2 = from; q2 < 3 * kUps; q2 += step) {
        const int f = q2 / kUps, q = q2 % kUps;
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < 20; ++k) {
            const int at = clampi(k < 10 ? q + 10 - k : q + k + 1, 0, 153);
            const float c = (float)(k < 10
                                        ? kInterpFlat[3 * k + f]
                                        : kInterpFlat[3 * (k - 10) + 3 - f]);
            acc = acc + (float)exc[kSub * sf + at] * c;
        }
        S.s.u[q2] = acc / 16384.0f;
    }
}

// the score: (y.t)^2 / y.y with y.t at least 0, or -1 where y.y = 0
__device__ __forceinline__ float pitch_score(float e, float cc) {
    cc = fmaxf(cc, 0.0f);
    return e > 0.0f ? cc * cc / fmaxf(e, 1e-9f) : -1.0f;
}

// Pitch candidate c's score: its vector (the upsampled history at its
// fraction, a lag under 40 repeating its period) through the impulse
// response hr (in registers), k outer and each product into the 40 sums
// of y; each y[n] sums its products k ascending (from the first: see the
// contract above), y.y and y.t sum n ascending from 0.0f.  Each of the
// vector's 40 samples is loaded once (volatile: loaded where it is used,
// so it takes no register for long).
__device__ __forceinline__ float candidate_score(const float (&hr)[kSub],
                                                 const float *u,
                                                 const float *tgt, int c) {
    const int t = kPitchMin + c / 3, fr = c % 3 - 1;
    const int ti = fr > 0 ? t + 1 : t;
    const volatile float *w = u + (fr > 0 ? 2 : -fr) * kUps + kUps - ti;
    float y[kSub];
#pragma unroll
    for (int k = 0; k < kSub; ++k) {
        const float a = w[k < ti ? k : k - ti];
#pragma unroll
        for (int n = k; n < kSub; ++n) {
            const float p = a * hr[n - k];
            y[n] = k == 0 ? p : y[n] + p;
        }
    }
    float e = 0.0f, cc = 0.0f;
#pragma unroll
    for (int n = 0; n < kSub; ++n) {
        e = e + y[n] * y[n];
        cc = cc + y[n] * tgt[n];
    }
    return pitch_score(e, cc);
}

// Subframe sf, from its impulse response, target and upsampled history:
// the closed-loop pitch over the codable candidates, the ACELP search,
// the gain pair, and the shadow decoder's update (warp 0).  x: the
// frame's input.
template <int kThreads, int sf>
__device__ void subframe(Shared &S, int tid, const float *x) {
    const int lane = tid & 31, warp = tid >> 5, off = sf * kSub;
    constexpr int ph = kPhSub + 9 * sf;
    int *exc = S.st + kExc;
    // ---- the pitch grid: subframe 0's 253 codable candidates (c = 1..194
    // and every third from 196), subframe 1's window of 30 from its base,
    // each thread's ascending; the best starts at (-1, candidate 0)
    int k;
    {
        float hr[kSub];
#pragma unroll
        for (int n = 0; n < kSub; ++n) hr[n] = S.h[sf][n];
        const int slots = sf == 0 ? kValid0 : kWin1;
        const int c1 = 3 * (S.base - kPitchMin);
        float best_v = -1.0f;
        int best_i = 0;
        for (int s = tid; s < slots; s += kThreads) {
            const int c = sf ? c1 + s : s < 194 ? s + 1 : 3 * s - 386;
            const float v = candidate_score(hr, S.s.u, S.tgt, c);
            if (before(v, c, best_v, best_i)) {
                best_v = v;
                best_i = c;
            }
        }
        k = block_best<kThreads>(best_v, best_i, S);
    }
    const int t_int = kPitchMin + k / 3, t_frac = k % 3 - 1;
    if (tid == 0) {
        if (sf == 0) {
            const int p1 = t_int <= 84 ? 3 * t_int + t_frac - 58
                                       : t_int + 112;
            const int pidx = p1 >> 2;
            const uint32_t pword = pidx >= 32 ? 0x69969669u : 0x96696996u;
            S.parm[5] = p1;
            S.parm[4] = (int)((pword >> (pidx & 31)) & 1) ^ 1;
            S.base = clampi(t_int - 5, kPitchMin, kPitchMax - 9);
        } else {
            S.parm[6] = 3 * (t_int - S.base) + t_frac + 2;
        }
    }
    K_STAMP(S, ph + kPhPitch);
    // the impulse response sharpened at the lag, each warp its own copy
    const float gp_sh = (float)S.st[kPitchSharp] / 16384.0f;
    float *h2 = S.h2[warp];
    const float *h = S.h[sf];
    for (int n = lane; n < kSub; n += 32)
        h2[n] = h[n] + gp_sh * (n >= t_int ? h[n - t_int] : 0.0f);
    __syncwarp();
    float t_ya = 0.0f, ya2 = 0.0f;       // t.ya and ya.ya (warp 0)
    if (warp == 0) {
        // the chosen vector, exact, through the shadow decoder; its
        // response, the pitch gain, the residual target and d = H2' r
        ac_vector(exc, 3 * t_int + t_frac + 1, off, lane);
        for (int n = lane; n < kSub; n += 32) {
            float acc = 0.0f;
#pragma unroll 8
            for (int j = 0; j <= n; ++j)
                acc = acc + (float)exc[kExcOff + off + j] * h[n - j];
            S.y_ac[n] = acc;
        }
        __syncwarp();
#pragma unroll 8
        for (int n = 0; n < kSub; ++n) {
            t_ya = t_ya + S.y_ac[n] * S.tgt[n];
            ya2 = ya2 + S.y_ac[n] * S.y_ac[n];
        }
        const float gp_f = fminf(fmaxf(t_ya / fmaxf(ya2, 1e-9f), 0.0f),
                                 1.2f);
        for (int n = lane; n < kSub; n += 32)
            S.rres[n] = S.tgt[n] - gp_f * S.y_ac[n];
        __syncwarp();
        for (int n = lane; n < kSub; n += 32) {
            float acc = 0.0f;
#pragma unroll 8
            for (int j = 0; j < kSub - n; ++j)
                acc = acc + h2[j] * S.rres[n + j];
            S.sneg[n] = !(acc >= 0.0f);
            S.dabs[n] = fabsf(acc);
        }
    } else {
        // the correlation matrix of h2, a diagonal a lane: phi[a][a + dl]
        // = sum h2[j] h2[j - dl] over j = dl .. 39 - a ascending from
        // 0.0f, so one running sum over j gives the whole diagonal (a = 39
        // - j); phi[a + dl][a] has the same products in the same order
        for (int dl = tid - 32; dl < kSub; dl += kThreads - 32) {
            float acc = 0.0f;
#pragma unroll 8
            for (int j = dl; j < kSub; ++j) {
                acc = acc + h2[j] * h2[j - dl];
                S.s.phs[kSub - 1 - j][kSub - 1 - j + dl] = acc;
                S.s.phs[kSub - 1 - j + dl][kSub - 1 - j] = acc;
            }
        }
    }
    __syncthreads();
    K_STAMP(S, ph + kPhChain);
    for (int e = tid; e < kSub * kSub; e += kThreads) {  // the signs
        const int a = e / kSub, b = e % kSub;
        S.s.phs[a][b] = __int_as_float(__float_as_int(S.s.phs[a][b]) ^
                                       ((S.sneg[a] ^ S.sneg[b]) << 31));
    }
    __syncthreads();
    K_STAMP(S, ph + kPhSigned);
    // ---- the joint search over the 4 tracks: a thread a pair of tracks
    // 0-1 (kThreads / 64 threads a pair, each a share of track 2), its two
    // matrix rows at track 3's positions in registers; track 2, then
    // track 3's 16 positions, ascending inside
    {
        constexpr int kSplit = kThreads / 64, kK2 = 8 / kSplit;
        float d3[16], p33[16], q0[16], q1[16];
        const int pair = tid / kSplit, p0 = 5 * (pair >> 3),
                  p1 = 5 * (pair & 7) + 1;
        const float *r0 = S.s.phs[p0], *r1 = S.s.phs[p1];
#pragma unroll
        for (int k3 = 0; k3 < 16; ++k3) {
            const int p3 = k3 < 8 ? 5 * k3 + 3 : 5 * (k3 - 8) + 4;
            d3[k3] = S.dabs[p3];
            p33[k3] = S.s.phs[p3][p3];
            q0[k3] = r0[p3];
            q1[k3] = r1[p3];
        }
        const float n1 = S.dabs[p0] + S.dabs[p1];
        const float dd1 = r0[p0] + r1[p1];
        const float c01 = r0[p1];
        float best_v = 0.0f;
        int best_i = -1;
        for (int k2 = tid % kSplit * kK2; k2 < (tid % kSplit + 1) * kK2;
             ++k2) {
            const int p2 = 5 * k2 + 2;
            const float *r2 = S.s.phs[p2];
            const float n3 = n1 + S.dabs[p2];
            const float dd3 = dd1 + r2[p2];
            const float c2 = c01 + r0[p2], c12 = r1[p2];
#pragma unroll
            for (int k3 = 0; k3 < 16; ++k3) {
                const int p3 = k3 < 8 ? 5 * k3 + 3 : 5 * (k3 - 8) + 4;
                const float num = n3 + d3[k3];
                const float den_d = dd3 + p33[k3];
                const float den_c = (((c2 + q0[k3]) + c12) + q1[k3]) + r2[p3];
                const float den = den_d + 2.0f * den_c;
                const float score = (num * num) / fmaxf(den, 1e-9f);
                if (best_i < 0 || score > best_v) {
                    best_v = score;
                    best_i = pair << 7 | k2 << 4 | k3;
                }
            }
        }
        k = block_best<kThreads>(best_v, best_i, S);
    }
    K_STAMP(S, ph + kPhAcelp);
    if (warp != 0) return;
    // ---- warp 0: the code vector, its response and energy, the gain
    // pair, and the state update, the decoder's
    const int k3 = k & 15, k2 = (k >> 4) & 7, k1 = (k >> 7) & 7,
              k0 = k >> 10;
    const int p[4] = {5 * k0, 5 * k1 + 1, 5 * k2 + 2,
                      k3 < 8 ? 5 * k3 + 3 : 5 * (k3 - 8) + 4};
    int signs = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) signs |= !S.sneg[p[t]] << t;
    const int fci = k0 | (k1 << 3) | (k2 << 6) | ((k3 & 7) << 10) |
                    ((k3 >> 3) << 9);
    fc_vector(fci, signs, t_int, S.st[kPitchSharp], S.fc, lane);
    int e2 = 0;
    for (int n = lane; n < kSub; n += 32) {
        float acc = 0.0f;
#pragma unroll 8
        for (int j = 0; j <= n; ++j)
            acc = acc + (float)S.fc[j] * h[n - j];
        S.y_fc[n] = acc;
        e2 = wadd(e2, wmul(S.fc[n], S.fc[n]));
    }
    const int energy = warp_sum(e2);     // wrapping int sums: any order
    __syncwarp();
    float dot = 0.0f;                    // t.yf, yf.yf, ya.yf in lanes 0-2
    {
        const float *a = lane == 0 ? S.tgt : lane == 1 ? S.y_fc : S.y_ac;
#pragma unroll 8
        for (int n = 0; n < kSub; ++n) dot = dot + a[n] * S.y_fc[n];
    }
    const float t_yf = __shfl_sync(kFull, dot, 0),
                yf2 = __shfl_sync(kFull, dot, 1),
                yayf = __shfl_sync(kFull, dot, 2);
    K_STAMP(S, ph + kPhCode);
    // the code gain's prediction
    int pe = mul_sh15(l_log2(max(energy, 1)), -24660);
    pe = wshl(wadd(pe, kLog2Sub + 0xD8888 - 2), 10);
#pragma unroll
    for (int j = 0; j < 4; ++j)
        pe = wadd(pe, wmul(S.st[kPredEnerg + j], kMaCoeff[j]));
    pe = wmul(5439, pe >> 15) >> 8;
    const int expn = pe >> 15, emant = l_pow2(pe & 0x7FFF) & 0x7FFF;
    float best_v = 0.0f;
    int best_i = -1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {        // the pairs c = 16 ga + gb
        const int c = lane + 32 * j;
        const int prod = wmul(emant, S.gc128[c]);
        const int gc = i16(25 - expn > 0 ? prod >> min(25 - expn, 31)
                           : expn - 25 >= 32 ? 0 : wshl(prod, expn - 25));
        const float gp = (float)S.gp128[c] / 16384.0f;
        const float gcf = (float)gc / 16384.0f;
        const float err = ((((-2.0f * gp) * t_ya - (2.0f * gcf) * t_yf)
                            + (gp * gp) * ya2)
                           + ((2.0f * gp) * gcf) * yayf)
                          + (gcf * gcf) * yf2;
        if (best_i < 0 || before(-err, c, best_v, best_i)) {
            best_v = -err;
            best_i = c;
        }
    }
    warp_best(best_v, best_i);
    K_STAMP(S, ph + kPhGains);
    const int ga = best_i >> 4, gb = best_i & 15;
    int pred[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) pred[j] = S.st[kPredEnerg + j];
    const int gc = code_gain(energy, pred, ga, gb);
    const int gp = kCbGa[ga][0] + kCbGb[gb][0];
    mem_update(exc, S.fc, gp, gc, off, lane);
    K_STAMP(S, ph + kPhUpdate);
    int lp[10];
#pragma unroll
    for (int i = 0; i < 10; ++i) lp[i] = S.lp[10 * sf + i];
    synthesise(lp, exc, off, S.st + kSynMem, S.sp, lane);
    if (lane == 0) {
        S.parm[7 + sf] = fci;
        S.parm[9 + sf] = signs;
        S.parm[11 + sf] = ga;
        S.parm[13 + sf] = gb;
#pragma unroll
        for (int j = 0; j < 4; ++j) S.st[kPredEnerg + j] = pred[j];
        S.st[kGainPitch] = gp;
        S.st[kGainCode] = gc;
        S.st[kPitchSharp] = clampi(gp, kSharpMin, kSharpMax);
        S.st[kPitchPrev] = t_int;
    }
    __syncwarp();
    K_STAMP(S, ph + kPhTail);
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads, 512 / kThreads)
g729_encode_kernel(const float *__restrict__ frames, long long nt,
                   long long nb, int32_t *__restrict__ state,
                   float *__restrict__ hist, int32_t *__restrict__ parms) {
    __shared__ Shared S;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long b = blockIdx.x;
    int32_t *gst = state + b * kStateWords;
    float *gh = hist + b * 160;
    for (int k = tid; k < kStateWords; k += kThreads) S.st[k] = gst[k];
    for (int k = tid; k < 160; k += kThreads)  // frames -2 and -1: slots 1, 2
        S.xs[1 + k / 80][k % 80] = gh[k];
    for (int k = tid; k < 1280; k += kThreads)
        S.cb1[k / 10][k % 10] = (int16_t)kCbL1[k / 10][k % 10];
    for (int k = tid; k < 320; k += kThreads)
        S.cb23[k / 10][k % 10] = (int16_t)kCbL2L3[k / 10][k % 10];
    for (int k = tid; k < 240; k += kThreads) S.wlp[k] = kWlp[k];
    for (int c = tid; c < 128; c += kThreads) {
        S.gp128[c] = kCbGa[c >> 4][0] + kCbGb[c & 15][0];
        S.gc128[c] = (kCbGa[c >> 4][1] + kCbGb[c & 15][1]) >> 1;
    }
    __syncthreads();
    K_CLOCK_START(S);
    if (warp == 1) lp_head(S, lane, 0, frames + b * 80);
    for (long long t = 0; t < nt; ++t) {
        const int slot = (int)(t % 3);
        const float *x = S.xs[slot];
        __syncthreads();
        K_STAMP(S, kPhAnalysis);
        analyse<kThreads>(S, tid);
        if (warp == 0) {
            // the shadow decoder's LSF and LP, then both subframes'
            // impulse responses and subframe 0's zero-input response
            int lsf_prev[10], lsp_prev[10], lq[10], lsf[10], lp[20];
            int prev_mode = S.st[kPrevMode];
#pragma unroll
            for (int i = 0; i < 10; ++i) {
                lsf_prev[i] = S.st[kLsfPrev + i];
                lsp_prev[i] = S.st[kLspPrev + i];
            }
            decode_lsf(S.st + kLqPrev, false, S.parm[0], S.parm[1],
                       S.parm[2], S.parm[3], lsf_prev, prev_mode, lq, lsf);
            __syncwarp();
            K_STAMP(S, kPhShadowLsf);
            decode_lp(lsf, lsp_prev, lp);
            K_STAMP(S, kPhShadowLp);
            if (lane == 0) {
                rotate_lq(S.st + kLqPrev, lq);
                S.st[kPrevMode] = prev_mode;
#pragma unroll
                for (int i = 0; i < 10; ++i) {
                    S.st[kLsfPrev + i] = lsf_prev[i];
                    S.st[kLspPrev + i] = lsp_prev[i];
                }
#pragma unroll
                for (int i = 0; i < 20; ++i) S.lp[i] = lp[i];
            }
            __syncwarp();
            responses(S, lane, 0, x, true);
        } else {                         // subframe 0's interpolation
            interpolate(S, 0, tid - 32, kThreads - 32);
        }
        __syncthreads();
        K_STAMP(S, kPhShadow);
        subframe<kThreads, 0>(S, tid, x);
        __syncthreads();
        if (warp == 0)
            responses(S, lane, 1, x, false);
        else
            interpolate(S, 1, tid - 32, kThreads - 32);
        __syncthreads();
        K_STAMP(S, kPhSub + 9 + kPhZir);
        subframe<kThreads, 1>(S, tid, x);
        if (warp == 1 && t + 1 < nt)     // the next frame's head
            lp_head(S, lane, (int)((t + 1) % 3),
                    frames + ((t + 1) * nb + b) * 80);
        if (warp == 0) {
            shift_exc(S.st + kExc, lane);
            if (lane < 16)
                parms[(t * nb + b) * 16 + lane] = lane < 15 ? S.parm[lane]
                                                            : 0;
        }
    }
    __syncthreads();
    K_CLOCK_END(S);
    for (int k = tid; k < kStateWords; k += kThreads) gst[k] = S.st[k];
    for (int k = tid; k < 160; k += kThreads)  // frames T - 2 and T - 1
        gh[k] = S.xs[(int)((nt + 1 + k / 80) % 3)][k % 80];
}

}  // namespace

K_PHASE_ENTRIES(
    "the next frame's head past the tail,Chebyshev grid + roots,"
    "LSF quantizer,shadow LSF decode,shadow LP decode,"
    "responses + interpolation,"
    "sf0 -,sf0 pitch grid,sf0 warp 0 chain | matrix,sf0 signed matrix,"
    "sf0 ACELP search,sf0 code vector + y_fc + dots,sf0 gain pairs,"
    "sf0 code gain + mem_update,sf0 synthesis,"
    "sf1 ZIR + interpolation,sf1 pitch grid,sf1 warp 0 chain | matrix,"
    "sf1 signed matrix,sf1 ACELP search,sf1 code vector + y_fc + dots,"
    "sf1 gain pairs,sf1 code gain + mem_update,sf1 synthesis")

// frames float32 [t, b, 80] (the int16 samples), state int32 [b, 546] and
// hist float32 [b, 160] read before frame 0 and written after frame t,
// parms int32 [t, b, 16] (codecs/g729a.py:PARM_FIELDS, the erasure 0).
// 128 threads a stream while the card holds every stream at that size (4
// CTAs an SM: 528 on an H100); past that 64, whose 8 CTAs an SM hold
// twice the streams in one wave.
extern "C" int amv_g729_encode(const void *frames, long long t, long long b,
                               void *state, void *hist, void *parms,
                               void *stream) {
    if (t > 0 && b > 0) {
        int dev = 0, sms = 0, per_sm = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        // the most shared memory an SM can give, so 8 CTAs fit its L1
        cudaFuncSetAttribute(g729_encode_kernel<64>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, g729_encode_kernel<128>, 128, 0);
        if (b <= (long long)sms * per_sm)
            g729_encode_kernel<128><<<(unsigned)b, 128, 0,
                                      (cudaStream_t)stream>>>(
                (const float *)frames, t, b, (int32_t *)state, (float *)hist,
                (int32_t *)parms);
        else
            g729_encode_kernel<64><<<(unsigned)b, 64, 0,
                                     (cudaStream_t)stream>>>(
                (const float *)frames, t, b, (int32_t *)state, (float *)hist,
                (int32_t *)parms);
    }
    return (int)cudaGetLastError();
}
