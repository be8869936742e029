// Kernel K's first design, kept as tools/time_g729.py's baseline: the
// tool builds it with nvcc into a library of its own (its C entry has the
// shipped one's name and arguments) and times it in turns with
// csrc/g729_encode.cu on the same inputs, their outputs equal; built with
// -DK_PHASES it gives the same time by phase as the shipped source does
// (csrc/g729_encode_phases.cuh).  Not part of the port's library.
//
// A CTA of 128 threads a stream: every one of the 372 pitch candidates
// scored in both subframes (validity only in the score), each thread's
// candidate vector in registers and the impulse response read from shared
// memory a product at a time; the 8,192 ACELP combinations each with its
// 10 matrix entries, 20 signs and 4 magnitudes from shared memory; the
// recurrences on one thread; two waves of CTAs for 1,024 streams at 4 CTAs
// an SM.  Its numeric contract is the shipped source's.

#include <math.h>

#include "g729_common.cuh"
#include "g729_encode_tables.cuh"
#include "g729_encode_phases.cuh"

namespace {

using namespace g729;

constexpr int kThreads = 128;
constexpr int kUps = 144, kCand = 372, kGrid = 512, kBisect = 12;
constexpr int kCombos = 8 * 8 * 8 * 16;

struct Shared {
    int st[kStateWords];
    float hist[160], x[80], w[240], r[11];
    float c5[2][5], mid[2], vals[2][kGrid], roots[10];
    int ok[2], target[10];
    int pred[2][10];
    float lq_t[2][10], d1[2][128], d23[2][8][2][32];
    int l1c[2][8], l23[2][8][2], err[2][8];
    int parm[16], lp[20];
    float h[kSub], tgt[kSub], u[3 * kUps];
    float y_ac[kSub], h2[kSub], rres[kSub], d[kSub], phi[kSub][kSub + 1];
    float sgn[kSub], dabs[kSub], y_fc[kSub], dots[5];
    int fc[kSub], sp[kSub];
    float gp_f, gp_sh;
    int t_int, t_frac, base, energy, emant, expn;
    float red_v[kThreads / 32];
    int red_i[kThreads / 32];
    K_PHASE_CLOCK
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

// The block's best (v, i) by `before`, to every thread.  (all threads)
__device__ int block_best(float v, int i, Shared &S) {
#pragma unroll
    for (int o = 16; o; o >>= 1) {
        const float ov = __shfl_xor_sync(kFull, v, o);
        const int oi = __shfl_xor_sync(kFull, i, o);
        if (before(ov, oi, v, i)) {
            v = ov;
            i = oi;
        }
    }
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

// The frame's LP analysis: the windowed autocorrelation, Levinson, the
// LSF (the roots of the symmetric and antisymmetric polynomials on the
// grid, bisected), and the two-stage switched-MA LSF quantizer searched
// through the decoder's exact reconstruction -> parm[0..3].
__device__ void analyse(Shared &S, int tid) {
    const int lane = tid & 31, warp = tid >> 5;
    for (int n = tid; n < 240; n += kThreads)
        S.w[n] = (n < 160 ? S.hist[n] : S.x[n - 160]) * kWlp[n];
    __syncthreads();
    if (tid < 11) {
        float acc = 0.0f;
        for (int n = 0; n < 240; ++n)
            acc = acc + S.w[n] * (n + tid < 240 ? S.w[n + tid] : 0.0f);
        if (tid == 0) acc = fmaxf(acc * 1.0001f + 10.0f, 1e-3f);
        S.r[tid] = acc * kLagWindow[tid];
    }
    __syncthreads();
    if (tid == 0) {                      // Levinson, then P and Q deflated
        float a[11], na[11];
        a[0] = 1.0f;
        for (int j = 1; j < 11; ++j) a[j] = 0.0f;
        float err = S.r[0];
        for (int i = 1; i < 11; ++i) {
            float acc = S.r[i];
            for (int j = 1; j < i; ++j) acc = acc + a[j] * S.r[i - j];
            const float k = err > 0.0f ? -acc / err : 0.0f;
            for (int j = 1; j <= i; ++j) na[j] = a[j] + k * a[i - j];
            for (int j = 1; j <= i; ++j) a[j] = na[j];
            err = fmaxf(err * (1.0f - k * k), 1e-6f);
        }
        float pd[11], qd[11];
        pd[0] = a[0] + 0.0f;
        qd[0] = a[0] - 0.0f;
        for (int i = 1; i < 11; ++i) {
            pd[i] = (a[i] + a[11 - i]) - pd[i - 1];
            qd[i] = (a[i] - a[11 - i]) + qd[i - 1];
        }
        for (int k = 0; k < 5; ++k) {
            S.c5[0][k] = pd[4 - k];
            S.c5[1][k] = qd[4 - k];
        }
        S.mid[0] = pd[5];
        S.mid[1] = qd[5];
    }
    __syncthreads();
    K_STAMP(S, 0);
    for (int j2 = tid; j2 < 2 * kGrid; j2 += kThreads) {
        const int p = j2 / kGrid, j = j2 % kGrid;
        S.vals[p][j] = cheb_value(S.c5[p], S.mid[p], (float)j * kPi511);
    }
    __syncthreads();
    if (warp < 2) {                      // warp p: polynomial p's roots
        const float *v = S.vals[warp];
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
    if (tid == 0) {                      // sort; Q13 targets
        float l[10];
        for (int i = 0; i < 10; ++i) l[i] = S.roots[i];
        for (int i = 1; i < 10; ++i)
            for (int j = i; j > 0 && l[j] < l[j - 1]; --j) {
                const float t = l[j];
                l[j] = l[j - 1];
                l[j - 1] = t;
            }
        const bool ok = S.ok[0] && S.ok[1];
        for (int i = 0; i < 10; ++i) {
            const float v = ok ? l[i] : kUniformLsf[i];
            S.target[i] = (int)rintf(fminf(fmaxf(v * 8192.0f, 40.0f),
                                           25681.0f));
        }
    }
    __syncthreads();
    K_STAMP(S, 1);
    // ---- the LSF quantizer, for each MA predictor L0
    if (tid < 20) {
        const int l0 = tid / 10, i = tid % 10;
        int pred = 0;
        for (int k = 0; k < 4; ++k)
            pred = wadd(pred, wmul(S.st[kLqPrev + 10 * k + i],
                                   kMaPred[l0][k][i]));
        S.pred[l0][i] = pred;
        S.lq_t[l0][i] = ((float)S.target[i] * 32768.0f - (float)pred) /
                        (float)kMaSum[l0][i];
    }
    __syncthreads();
    for (int j2 = tid; j2 < 256; j2 += kThreads) {
        const int l0 = j2 / 128, c = j2 % 128;
        float acc = 0.0f;
        for (int i = 0; i < 10; ++i)
            acc = acc + fabsf((float)kCbL1[c][i] - S.lq_t[l0][i]);
        S.d1[l0][c] = acc;
    }
    __syncthreads();
    if (warp < 2) {
        // the 8 least distances of L0 = warp, ascending, ties to the lower
        // index: 8 rounds of a warp minimum (the larger negated distance)
        // over the entries c = lane + 32 j not yet taken
        unsigned taken = 0;
        for (int r = 0; r < 8; ++r) {
            float v = -INFINITY;
            int i = 1 << 30;
            for (int j = 0; j < 4; ++j) {
                const int c = lane + 32 * j;
                if (!(taken >> j & 1) && before(-S.d1[warp][c], c, v, i)) {
                    v = -S.d1[warp][c];
                    i = c;
                }
            }
#pragma unroll
            for (int o = 16; o; o >>= 1) {
                const float ov = __shfl_xor_sync(kFull, v, o);
                const int oi = __shfl_xor_sync(kFull, i, o);
                if (before(ov, oi, v, i)) {
                    v = ov;
                    i = oi;
                }
            }
            if ((i & 31) == lane) taken |= 1u << (i >> 5);
            if (lane == 0) S.l1c[warp][r] = i;
        }
    }
    __syncthreads();
    for (int q = tid; q < 1024; q += kThreads) {
        const int j = q & 31, half = (q >> 5) & 1, k = (q >> 6) & 7,
                  l0 = q >> 9;
        const int c1 = S.l1c[l0][k];
        float acc = 0.0f;
        for (int i = 5 * half; i < 5 * half + 5; ++i) {
            const float resid = S.lq_t[l0][i] - (float)kCbL1[c1][i];
            const float e = (float)kCbL2L3[j][i] - resid;
            acc = acc + e * e;
        }
        S.d23[l0][k][half][j] = acc;
    }
    __syncthreads();
    if (tid < 32) {
        const float *d = S.d23[tid >> 4][(tid >> 1) & 7][tid & 1];
        int best = 0;
        for (int j = 1; j < 32; ++j)
            if (d[j] < d[best]) best = j;
        S.l23[tid >> 4][(tid >> 1) & 7][tid & 1] = best;
    }
    __syncthreads();
    if (tid < 16) {                      // each candidate's exact error
        const int l0 = tid >> 3, k = tid & 7, c1 = S.l1c[l0][k];
        int lq[10];
        for (int i = 0; i < 10; ++i)
            lq[i] = kCbL1[c1][i] + kCbL2L3[S.l23[l0][k][i / 5]][i];
        for (int J = 10; J >= 5; J -= 5)
            for (int i = 1; i < 10; ++i) {
                const int diff = (lq[i - 1] - lq[i] + J) >> 1;
                if (diff > 0) {
                    lq[i - 1] -= diff;
                    lq[i] += diff;
                }
            }
        int err = 0;
        for (int i = 0; i < 10; ++i) {
            const int rec = wadd(wmul(lq[i], kMaSum[l0][i]),
                                 S.pred[l0][i]) >> 15;
            const int e = wsub(rec, S.target[i]);
            err = wadd(err, wmul(e, e));
        }
        S.err[l0][k] = err;
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
    K_STAMP(S, 2);
}

// Subframe sf: the closed-loop pitch over the whole (lag, fraction) grid,
// the ACELP search, the gain pair, and the shadow decoder's update.
__device__ void subframe(Shared &S, int tid, int sf) {
    const int lane = tid & 31, warp = tid >> 5, off = sf * kSub;
    const int ph = 4 + 9 * sf;
    int *exc = S.st + kExc;
    if (tid == 0) {                      // the impulse response of 1/A(z)
        float a[10];
        for (int i = 0; i < 10; ++i) a[i] = (float)S.lp[10 * sf + i] / 4096.0f;
        S.h[0] = 1.0f;
        for (int n = 1; n < kSub; ++n) {
            float acc = 0.0f;
            for (int i = 0; i < min(10, n); ++i)
                acc = acc + a[i] * S.h[n - 1 - i];
            S.h[n] = -acc;
        }
    } else if (tid == 32) {              // the target: less the ZIR
        float a[10], hist[10];
        for (int i = 0; i < 10; ++i) {
            a[i] = (float)S.lp[10 * sf + i] / 4096.0f;
            hist[i] = (float)S.st[kSynMem + i];
        }
        for (int n = 0; n < kSub; ++n) {
            float acc = 0.0f;
            for (int i = 0; i < 10; ++i) acc = acc + a[i] * hist[9 - i];
            const float s = -acc;
            for (int i = 0; i < 9; ++i) hist[i] = hist[i + 1];
            hist[9] = s;
            S.tgt[n] = S.x[off + n] - s;
        }
    }
    K_SYNC();
    K_STAMP(S, ph);
    // the interpolation at its 3 phases over the last 144 positions
    for (int q2 = tid; q2 < 3 * kUps; q2 += kThreads) {
        const int f = q2 / kUps, q = q2 % kUps;
        float acc = 0.0f;
        for (int k = 0; k < 20; ++k) {
            const int at = clampi(k < 10 ? q + 10 - k : q + k + 1, 0, 153);
            const float c = (float)(k < 10
                                        ? kInterpFlat[3 * k + f]
                                        : kInterpFlat[3 * (k - 10) + 3 - f]);
            acc = acc + (float)exc[off + at] * c;
        }
        S.u[q2] = acc / 16384.0f;
    }
    __syncthreads();
    K_STAMP(S, ph + 1);
    {   // the pitch candidates, 3 a thread
        float best_v = 0.0f;
        int best_i = -1;
        for (int c = tid; c < kCand; c += kThreads) {
            const int t = kPitchMin + c / 3, fr = c % 3 - 1;
            const bool valid = sf == 0
                ? (fr == 0 || t <= 84) && !(t == kPitchMin && fr == -1)
                : t >= S.base && t <= S.base + 9;
            const int fp = fr > 0 ? 2 : -fr, ti = fr > 0 ? t + 1 : t;
            float acv[kSub];
#pragma unroll
            for (int k = 0; k < kSub; ++k) {
                int q = k - ti;
                if (q >= 0) q -= ti;
                acv[k] = S.u[fp * kUps + q + kUps];
            }
            float e = 0.0f, cc = 0.0f;
#pragma unroll
            for (int n = 0; n < kSub; ++n) {
                float y = 0.0f;
#pragma unroll
                for (int k = 0; k <= n; ++k) y = y + acv[k] * S.h[n - k];
                e = e + y * y;
                cc = cc + y * S.tgt[n];
            }
            cc = fmaxf(cc, 0.0f);
            const float score = valid && e > 0.0f
                ? cc * cc / fmaxf(e, 1e-9f) : -1.0f;
            if (best_i < 0 || score > best_v) {
                best_v = score;
                best_i = c;
            }
        }
        const int k = block_best(best_v, best_i, S);
        if (tid == 0) {
            const int t = kPitchMin + k / 3, fr = k % 3 - 1;
            S.t_int = t;
            S.t_frac = fr;
            if (sf == 0) {
                const int p1 = t <= 84 ? 3 * t + fr - 58 : t + 112;
                const int pidx = p1 >> 2;
                const uint32_t pword = pidx >= 32 ? 0x69969669u
                                                  : 0x96696996u;
                S.parm[5] = p1;
                S.parm[4] = (int)((pword >> (pidx & 31)) & 1) ^ 1;
                S.base = clampi(t - 5, kPitchMin, kPitchMax - 9);
            } else {
                S.parm[6] = 3 * (t - S.base) + fr + 2;
            }
        }
    }
    __syncthreads();
    K_STAMP(S, ph + 2);
    const int t_int = S.t_int;
    // the chosen vector, exact, through the shadow decoder
    if (warp == 0) ac_vector(exc, 3 * t_int + S.t_frac + 1, off, lane);
    __syncthreads();
    if (tid < kSub) {
        float acc = 0.0f;
        for (int k = 0; k <= tid; ++k)
            acc = acc + (float)exc[kExcOff + off + k] * S.h[tid - k];
        S.y_ac[tid] = acc;
    }
    __syncthreads();
    if (tid == 0) {
        float ty = 0.0f, yy = 0.0f;
        for (int n = 0; n < kSub; ++n) {
            ty = ty + S.y_ac[n] * S.tgt[n];
            yy = yy + S.y_ac[n] * S.y_ac[n];
        }
        S.gp_f = fminf(fmaxf(ty / fmaxf(yy, 1e-9f), 0.0f), 1.2f);
        S.gp_sh = (float)S.st[kPitchSharp] / 16384.0f;
    }
    __syncthreads();
    if (tid < kSub) {
        S.h2[tid] = S.h[tid] +
                    S.gp_sh * (tid >= t_int ? S.h[tid - t_int] : 0.0f);
        S.rres[tid] = S.tgt[tid] - S.gp_f * S.y_ac[tid];
    }
    __syncthreads();
    K_STAMP(S, ph + 3);
    // ---- the fixed codebook: backward correlations, the matrix, and the
    // joint search over the 4 tracks
    if (tid < kSub) {
        float acc = 0.0f;
        for (int j = 0; j < kSub - tid; ++j)
            acc = acc + S.h2[j] * S.rres[tid + j];
        S.d[tid] = acc;
    }
    for (int e = tid; e < kSub * kSub; e += kThreads) {
        const int k = e / kSub, l = e % kSub;
        float acc = 0.0f;
        for (int m = max(k, l); m < kSub; ++m)
            acc = acc + S.h2[m - k] * S.h2[m - l];
        S.phi[k][l] = acc;
    }
    __syncthreads();
    if (tid < kSub) {
        S.sgn[tid] = S.d[tid] >= 0.0f ? 1.0f : -1.0f;
        S.dabs[tid] = fabsf(S.d[tid]);
    }
    __syncthreads();
    K_STAMP(S, ph + 4);
    {
        float best_v = 0.0f;
        int best_i = -1;
        for (int kf = tid; kf < kCombos; kf += kThreads) {
            const int k3 = kf & 15, k2 = (kf >> 4) & 7, k1 = (kf >> 7) & 7,
                      k0 = kf >> 10;
            const int p[4] = {5 * k0, 5 * k1 + 1, 5 * k2 + 2,
                              k3 < 8 ? 5 * k3 + 3 : 5 * (k3 - 8) + 4};
#define PHS(a, b) (S.phi[p[a]][p[b]] * S.sgn[p[a]] * S.sgn[p[b]])
            const float num = ((S.dabs[p[0]] + S.dabs[p[1]]) + S.dabs[p[2]])
                              + S.dabs[p[3]];
            const float den_d = ((PHS(0, 0) + PHS(1, 1)) + PHS(2, 2))
                                + PHS(3, 3);
            const float den_c = ((((PHS(0, 1) + PHS(0, 2)) + PHS(0, 3))
                                  + PHS(1, 2)) + PHS(1, 3)) + PHS(2, 3);
#undef PHS
            const float den = den_d + 2.0f * den_c;
            const float score = (num * num) / fmaxf(den, 1e-9f);
            if (best_i < 0 || score > best_v) {
                best_v = score;
                best_i = kf;
            }
        }
        const int kf = block_best(best_v, best_i, S);
        if (tid == 0) {
            const int k3 = kf & 15, k2 = (kf >> 4) & 7, k1 = (kf >> 7) & 7,
                      k0 = kf >> 10;
            const int p[4] = {5 * k0, 5 * k1 + 1, 5 * k2 + 2,
                              k3 < 8 ? 5 * k3 + 3 : 5 * (k3 - 8) + 4};
            int signs = 0;
            for (int t = 0; t < 4; ++t) signs |= (S.sgn[p[t]] > 0.0f) << t;
            S.parm[7 + sf] = k0 | (k1 << 3) | (k2 << 6) | ((k3 & 7) << 10) |
                             ((k3 >> 3) << 9);
            S.parm[9 + sf] = signs;
        }
    }
    __syncthreads();
    K_STAMP(S, ph + 5);
    if (warp == 0)
        fc_vector(S.parm[7 + sf], S.parm[9 + sf], t_int, S.st[kPitchSharp],
                  S.fc, lane);
    __syncthreads();
    if (tid < kSub) {
        float acc = 0.0f;
        for (int k = 0; k <= tid; ++k)
            acc = acc + (float)S.fc[k] * S.h[tid - k];
        S.y_fc[tid] = acc;
    } else if (tid == 64) {              // the code gain's prediction
        int energy = 0;
        for (int n = 0; n < kSub; ++n)
            energy = wadd(energy, wmul(S.fc[n], S.fc[n]));
        int e = mul_sh15(l_log2(max(energy, 1)), -24660);
        e = wshl(wadd(e, kLog2Sub + 0xD8888 - 2), 10);
        for (int k = 0; k < 4; ++k)
            e = wadd(e, wmul(S.st[kPredEnerg + k], kMaCoeff[k]));
        e = wmul(5439, e >> 15) >> 8;
        S.energy = energy;
        S.expn = e >> 15;
        S.emant = l_pow2(e & 0x7FFF) & 0x7FFF;
    }
    __syncthreads();
    K_STAMP(S, ph + 6);
    if (tid < 5) {                       // the gain search's correlations
        const float *a = tid < 2 ? S.tgt : tid == 4 ? S.y_ac
                         : tid == 2 ? S.y_ac : S.y_fc;
        const float *b = tid == 0 ? S.y_ac : tid == 1 ? S.y_fc
                         : tid == 2 ? S.y_ac : tid == 3 ? S.y_fc : S.y_fc;
        float acc = 0.0f;
        for (int n = 0; n < kSub; ++n) acc = acc + a[n] * b[n];
        S.dots[tid] = acc;               // t.ya, t.yf, ya.ya, yf.yf, ya.yf
    }
    __syncthreads();
    {
        const int c = tid;               // the pair 16 ga + gb
        const int ga = c >> 4, gb = c & 15;
        const int prod = wmul(S.emant, (kCbGa[ga][1] + kCbGb[gb][1]) >> 1);
        const int expn = S.expn;
        const int gc = i16(25 - expn > 0 ? prod >> min(25 - expn, 31)
                           : expn - 25 >= 32 ? 0 : wshl(prod, expn - 25));
        const float gp = (float)(kCbGa[ga][0] + kCbGb[gb][0]) / 16384.0f;
        const float gcf = (float)gc / 16384.0f;
        const float err = ((((-2.0f * gp) * S.dots[0]
                              - (2.0f * gcf) * S.dots[1])
                             + (gp * gp) * S.dots[2])
                           + ((2.0f * gp) * gcf) * S.dots[4])
                          + (gcf * gcf) * S.dots[3];
        const int best = block_best(-err, c, S);
        if (tid == 0) {
            S.parm[11 + sf] = best >> 4;
            S.parm[13 + sf] = best & 15;
        }
    }
    __syncthreads();
    K_STAMP(S, ph + 7);
    if (warp == 0) {                     // the state update, the decoder's
        const int ga = S.parm[11 + sf], gb = S.parm[13 + sf];
        int pred[4];
        for (int k = 0; k < 4; ++k) pred[k] = S.st[kPredEnerg + k];
        const int gc = code_gain(S.energy, pred, ga, gb);
        const int gp = kCbGa[ga][0] + kCbGb[gb][0];
        mem_update(exc, S.fc, gp, gc, off, lane);
        int lp[10];
        for (int i = 0; i < 10; ++i) lp[i] = S.lp[10 * sf + i];
        synthesise(lp, exc, off, S.st + kSynMem, S.sp, lane);
        if (lane == 0) {
            for (int k = 0; k < 4; ++k) S.st[kPredEnerg + k] = pred[k];
            S.st[kGainPitch] = gp;
            S.st[kGainCode] = gc;
            S.st[kPitchSharp] = clampi(gp, kSharpMin, kSharpMax);
            S.st[kPitchPrev] = t_int;
        }
    }
    __syncthreads();
    K_STAMP(S, ph + 8);
}

// at most 128 registers a thread (a 312-byte stack), so 4 CTAs fit an SM;
// unbounded it took 219 and 2 CTAs an SM, and 1,024 streams x 600 frames
// took 272.6 ms against 230.2 on an H100 (tools/time_g729.py, in turns)
__global__ void __launch_bounds__(kThreads, 4)
g729_encode_kernel(const float *__restrict__ frames, long long nt,
                   long long nb, int32_t *__restrict__ state,
                   float *__restrict__ hist, int32_t *__restrict__ parms) {
    __shared__ Shared S;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long b = blockIdx.x;
    int32_t *gst = state + b * kStateWords;
    float *gh = hist + b * 160;
    for (int k = tid; k < kStateWords; k += kThreads) S.st[k] = gst[k];
    for (int k = tid; k < 160; k += kThreads) S.hist[k] = gh[k];
    __syncthreads();
    K_CLOCK_START(S);
    for (long long t = 0; t < nt; ++t) {
        if (tid < 80) S.x[tid] = frames[(t * nb + b) * 80 + tid] * 0.5f;
        __syncthreads();
        analyse(S, tid);
        if (warp == 0) {                 // the shadow decoder's LSF and LP
            int lsf_prev[10], lsp_prev[10], lq[10], lsf[10], lp[20];
            int prev_mode = S.st[kPrevMode];
            for (int i = 0; i < 10; ++i) {
                lsf_prev[i] = S.st[kLsfPrev + i];
                lsp_prev[i] = S.st[kLspPrev + i];
            }
            decode_lsf(S.st + kLqPrev, false, S.parm[0], S.parm[1],
                       S.parm[2], S.parm[3], lsf_prev, prev_mode, lq, lsf);
            __syncwarp();
            decode_lp(lsf, lsp_prev, lp);
            if (lane == 0) {
                rotate_lq(S.st + kLqPrev, lq);
                S.st[kPrevMode] = prev_mode;
                for (int i = 0; i < 10; ++i) {
                    S.st[kLsfPrev + i] = lsf_prev[i];
                    S.st[kLspPrev + i] = lsp_prev[i];
                }
                for (int i = 0; i < 20; ++i) S.lp[i] = lp[i];
            }
        }
        __syncthreads();
        K_STAMP(S, 3);
        subframe(S, tid, 0);
        subframe(S, tid, 1);
        if (warp == 0) shift_exc(S.st + kExc, lane);
        if (tid < 16)
            parms[(t * nb + b) * 16 + tid] = tid < 15 ? S.parm[tid] : 0;
        // the past input moves down a frame (read, then write)
        float keep[2];
        for (int j = 0; j < 2; ++j) {
            const int n = tid + kThreads * j;
            keep[j] = n >= 160 ? 0.0f : n < 80 ? S.hist[n + 80] : S.x[n - 80];
        }
        __syncthreads();
        for (int j = 0; j < 2; ++j)
            if (tid + kThreads * j < 160) S.hist[tid + kThreads * j] = keep[j];
        __syncthreads();
        K_STAMP(S, 22);
    }
    K_CLOCK_END(S);
    for (int k = tid; k < kStateWords; k += kThreads) gst[k] = S.st[k];
    for (int k = tid; k < 160; k += kThreads) gh[k] = S.hist[k];
}

}  // namespace

K_PHASE_ENTRIES("autocorrelation + Levinson,Chebyshev grid + roots,LSF quantizer,shadow LSF/LP,sf0 IR + ZIR,sf0 interpolation,sf0 pitch grid,sf0 ac_vector + y_ac + gain,sf0 d + phi,sf0 ACELP search,sf0 fc_vector + energy + y_fc,sf0 gain search,sf0 state update,sf1 IR + ZIR,sf1 interpolation,sf1 pitch grid,sf1 ac_vector + y_ac + gain,sf1 d + phi,sf1 ACELP search,sf1 fc_vector + energy + y_fc,sf1 gain search,sf1 state update,history shift")

// frames float32 [t, b, 80] (the int16 samples), state int32 [b, 546] and
// hist float32 [b, 160] read before frame 0 and written after frame t,
// parms int32 [t, b, 16] (codecs/g729a.py:PARM_FIELDS, the erasure 0).
extern "C" int amv_g729_encode(const void *frames, long long t, long long b,
                               void *state, void *hist, void *parms,
                               void *stream) {
    if (t > 0 && b > 0)
        g729_encode_kernel<<<(unsigned)b, kThreads, 0,
                             (cudaStream_t)stream>>>(
            (const float *)frames, t, b, (int32_t *)state, (float *)hist,
            (int32_t *)parms);
    return (int)cudaGetLastError();
}
