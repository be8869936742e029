"""Kernel G's one-warp design, the baseline that `time_g729.py` and
`chip_smoke.py` time the frame pipeline (csrc/g729_decode.cu) against, in
turns on one card: a warp a stream, lane 0 on every recurrence of every
stage in sequence.  Built by `time_g729.baseline_library` from SOURCE into
its own library (its C entry keeps the name amv_g729_decode and the same
arguments) against csrc/g729_tables.cuh; its output equals the pipeline's
bit for bit.
"""

SOURCE = r'''// Kernel G: G.729 Annex A decoding of B independent streams over T frames
// in one launch (the C decoder, G.729/g729a_native.c, as the scalar oracle
// amv_tpu_torch/verify/ref_g729.py writes it).
//
// Not the port of a Pallas kernel: the JAX package decodes with the XLA
// program of amv_tpu/codecs/g729a.py:596 decode_frame_batch under :731
// decode_frames_scan (a lax.scan over frames); the port's plain version,
// codecs/g729a.py:decode_frame_batch, is torch ops over the streams with a
// Python loop over each recurrence's steps (thousands of launches a frame).
//
// What bounds it: a stream is one serial chain of frames, and a frame is
// mostly short recurrences (LP synthesis, 40 steps of 10 taps, two or three
// times a subframe; the adaptive codebook's interpolation when the lag is
// shorter than the subframe; the impulse response of the tilt filter, the
// AGC's gain and the 80-step high-pass).  The bytes (10 in and 160 out a
// frame) are nothing beside that, so the floor is the latency of one
// frame's dependent chain times T.  Design: a warp per stream (a CTA of 32
// threads, the CTAs spread over the SMs), its state (546 words) in shared
// memory for all T frames, the tables in __constant__ memory (every read
// of one is warp-uniform).  Scalars live in registers, computed alike by
// every lane.  The lanes split the work that is parallel over a subframe's
// samples: the interpolation of the adaptive codebook in rounds of
// lag - 10 samples (a round reads only samples the rounds before it wrote),
// the fixed codebook and its pitch sharpening (rounds of the lag), the
// excitation update, the residual FIR, the long-term filter's 15
// correlations (a lane each), the tilt's products and the energy sums
// (warp sums, which wrap as the C sums do).  Lane 0 alone runs the
// recurrences that write arrays (the syntheses, the AGC, the high-pass),
// between __syncwarp()s; it owns their filter memories.  Those are
// unrolled over their samples with the history in registers (no moves),
// each sum ordered so the newest sample enters last (a loop shifting its
// history a step took 20.2 us a frame at B = 1 on an H100, this 15.7-16.7).
//
// Arithmetic: int32 sums and products wrap (formed in uint32), right shifts
// are arithmetic, and the JAX package's int32 forms are kept where the
// oracle's Python integers would not wrap (the same bits for the inputs a
// stream can reach).

#include <cuda_runtime.h>
#include <stdint.h>

#include "g729_tables.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSub = 40, kPitchMin = 20, kPitchMax = 143;
constexpr int kExcLen = 253, kExcOff = 154;
constexpr int kSharpMin = 3277, kSharpMax = 13017;
constexpr int kGammaT = 26214, kGammaP = 16384;
constexpr int kLog2Sub = 131238;   // (l_log2(40) * 24660) >> 15, in 64 bits
// the state's words, in codecs/g729a.py:STATE_FIELDS order
constexpr int kExc = 0, kPitchPrev = 253, kLqPrev = 254, kLspPrev = 294,
              kLsfPrev = 304, kPredEnerg = 314, kGainPitch = 318,
              kGainCode = 319, kPitchSharp = 320, kResidual = 321,
              kSynMem = 508, kResMem = 518, kPosMem = 528, kHtPrev = 538,
              kGainCoeff = 539, kRand = 540, kPrevMode = 541, kHpfF = 542,
              kHpfZ = 544, kStateWords = 546;

__device__ __forceinline__ int wmul(int a, int b) {
    return (int)((uint32_t)a * (uint32_t)b);
}
__device__ __forceinline__ int wadd(int a, int b) {
    return (int)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
    return (int)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int wshl(int a, int s) {
    return (int)((uint32_t)a << s);
}
__device__ __forceinline__ int i16(int x) { return (int)(int16_t)x; }
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return min(max(x, lo), hi);
}
// (int64(a) * b) >> 15, cut to int32
__device__ __forceinline__ int mul_sh15(int a, int b) {
    return (int)(((long long)a * b) >> 15);
}
__device__ __forceinline__ int av_log2(uint32_t v) {
    return v ? 31 - __clz((int)v) : 0;
}
__device__ __forceinline__ int g729_round(int v) {
    return v > 0x7FFFFFFF - 0x8000 ? 32767 : wadd(v, 0x8000) >> 16;
}
__device__ __forceinline__ int interp(const int32_t *tab, int x0, int dx) {
    return (tab[x0] << 15) + dx * (tab[x0 + 1] - tab[x0]);
}
__device__ int l_log2(int value) {
    const int p = av_log2((uint32_t)value);
    const uint32_t r = (uint32_t)value << (31 - p);
    return (p << 15) + (interp(kTabLog2, (int)((r & 0x7C000000u) >> 26),
                               (int)((r & 0x03FFF800u) >> 11)) >> 15);
}
__device__ int l_pow2(int power) {
    return (interp(kTabPow2, (power & 0x7C00) >> 10, (power & 0x03FF) << 5)
            + 16384) >> 15;
}
__device__ int l_inv_sqrt(int arg) {
    const int p = (av_log2((uint32_t)arg) >> 1) + 1;
    const uint32_t r = (uint32_t)arg << (32 - (p << 1));
    return (int)((uint32_t)interp(kTabInvSqrt, (int)(r >> 26) - 16,
                                  (int)((r >> 11) & 0x7FE0)) >> p);
}
// l_div with the x86 shift-count masking; floor division (the oracle's)
__device__ int l_div(int num, int denom, int base) {
    if (num == 0) return 0;
    const bool sig = (num < 0) != (denom < 0);
    const int na = num < 0 ? wsub(0, num) : num;
    const int da = denom < 0 ? wsub(0, denom) : denom;
    const int diff = 26 - av_log2((uint32_t)max(na, 1));
    const int ns = wshl(na, min(base, diff) & 31);
    const int ds = max(da >> ((max(base, diff) - diff) & 31), 1);
    int q = ns / ds;
    if (ns % ds != 0 && ns < 0) q -= 1;
    return sig ? wsub(0, q) : q;
}
__device__ __forceinline__ int warp_sum(int v) {
    uint32_t s = (uint32_t)v;
#pragma unroll
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    return (int)s;
}

// 1/A(z) over in[0..39] from the last 10 outputs h (oldest first) -> out;
// returns whether a sample left int16 (kClip: such samples are clipped).
// Unrolled over the 40 samples with the outputs in registers, so no
// history moves; each sample's taps are summed oldest first with negated
// coefficients (the sum wraps, so its order does not change it), which
// leaves one multiply-add and the shift between a sample and the next.
template <bool kClip>
__device__ __forceinline__ bool synthesis(const int *lp, const int *in,
                                          int *h, int *out) {
    int y[10 + kSub];
    int nlp[10];
#pragma unroll
    for (int i = 0; i < 10; ++i) {
        y[i] = h[i];
        nlp[i] = wsub(0, lp[i]);
    }
    bool ovf = false;
#pragma unroll
    for (int n = 0; n < kSub; ++n) {
        int s = wshl(in[n], 12);
#pragma unroll
        for (int i = 9; i >= 0; --i) s = wadd(s, wmul(nlp[i], y[n + 9 - i]));
        s >>= 12;
        ovf |= s > 32767 || s < -32768;
        if (kClip) s = clampi(s, -32768, 32767);
        y[10 + n] = s;
        out[n] = s;
    }
#pragma unroll
    for (int i = 0; i < 10; ++i) h[i] = y[kSub + i];
    return ovf;
}

// LSF (Q13, sorted and spaced) -> LSP -> LP (Q12) of one subframe
__device__ __forceinline__ void lsp2lp(const int *lsp, int *lp) {
    int f[2][6];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        int *g = f[e];
        g[0] = 1 << 24;
        g[1] = wshl(-lsp[e], 10);
#pragma unroll
        for (int i = 2; i < 6; ++i) {
            const int q = lsp[2 * (i - 1) + e];
            g[i] = g[i - 2];
#pragma unroll
            for (int j = i; j > 1; --j)
                g[j] = wadd(wsub(g[j], wshl(mul_sh15(g[j - 1] >> 1, q), 2)),
                            g[j - 2]);
            g[1] = wsub(g[1], wshl(q, 10));
        }
    }
#pragma unroll
    for (int i = 0; i < 5; ++i) {
        const int ff1 = wadd(wadd(f[0][i + 1], f[0][i]), 1 << 12);
        const int ff2 = wsub(f[1][i + 1], f[1][i]);
        lp[i] = i16(wadd(ff1, ff2) >> 13);
        lp[9 - i] = i16(wsub(ff1, ff2) >> 13);
    }
}

__global__ void __launch_bounds__(32)
g729_decode_kernel(const int32_t *__restrict__ parms, long long nt,
                   long long nb, int32_t *__restrict__ state,
                   int16_t *__restrict__ pcm_out) {
    __shared__ int st[kStateWords];
    __shared__ int s_lp[20];            // the frame's two LP filters
    __shared__ int s_fc[kSub];          // the fixed-codebook vector
    __shared__ int s_sp[kSub];          // synthesised speech
    __shared__ int s_f1[kSub], s_f2[kSub];   // postfilter stages
    __shared__ int s_pcm[2 * kSub];     // the frame before the high-pass
    __shared__ int16_t s_out[2 * kSub];
    const int lane = threadIdx.x;
    const long long b = blockIdx.x;
    int32_t *gst = state + b * kStateWords;
    for (int k = lane; k < kStateWords; k += 32) st[k] = gst[k];
    __syncwarp();
    int *exc = st + kExc, *res = st + kResidual, *lq_prev = st + kLqPrev;
    // uniform scalars (every lane holds the same values)
    int pitch_prev = st[kPitchPrev], gain_pitch = st[kGainPitch];
    int gain_code = st[kGainCode], pitch_sharp = st[kPitchSharp];
    int ht_prev = st[kHtPrev], rand_value = st[kRand];
    int prev_mode = st[kPrevMode];
    int lsp_prev[10], lsf_prev[10], pred[4];
#pragma unroll
    for (int i = 0; i < 10; ++i) {
        lsp_prev[i] = st[kLspPrev + i];
        lsf_prev[i] = st[kLsfPrev + i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) pred[i] = st[kPredEnerg + i];
    // lane 0's recurrences' memories
    int syn_mem[10], res_mem[10];
#pragma unroll
    for (int i = 0; i < 10; ++i) {
        syn_mem[i] = st[kSynMem + i];
        res_mem[i] = st[kResMem + i];
    }
    int gain_coeff = st[kGainCoeff];
    int hf1 = st[kHpfF], hf2 = st[kHpfF + 1];
    int hz1 = st[kHpfZ], hz2 = st[kHpfZ + 1];

    const int32_t *pp = parms + b * 16 + min(lane, 15);
    int next = nt > 0 ? pp[0] : 0;
    for (long long t = 0; t < nt; ++t) {
        const int mine = next;
        if (t + 1 < nt) next = pp[(t + 1) * nb * 16];
        int p[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) p[k] = __shfl_sync(kFull, mine, k);
        const bool era = p[15] != 0;
        const int ac0 = p[5], ac1 = p[6];
        const int pidx = ac0 >> 2;
        const uint32_t pword = pidx >= 32 ? 0x69969669u : 0x96696996u;
        const bool bad_pitch =
            ((((pword >> (pidx & 31)) & 1) ^ p[4]) & 1) == 0;
        bool data_error = era;

        // ---- LSF: decoded, or restored from the previous frame's
        int lsf[10], lq[10];
        if (era) {
#pragma unroll
            for (int i = 0; i < 10; ++i) {
                int v = wshl(lsf_prev[i], 15);
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    v = wsub(v, wmul(lq_prev[10 * k + i],
                                     kMaPred[prev_mode][k][i]));
                lq[i] = wmul(v >> 15, kMaSumInv[prev_mode][i]) >> 12;
                lsf[i] = lsf_prev[i];
            }
        } else {
            const int l0 = p[0], l1 = p[1], l2 = p[2], l3 = p[3];
#pragma unroll
            for (int i = 0; i < 5; ++i) {
                lq[i] = kCbL1[l1][i] + kCbL2L3[l2][i];
                lq[i + 5] = kCbL1[l1][i + 5] + kCbL2L3[l3][i + 5];
            }
#pragma unroll
            for (int J = 10; J >= 5; J -= 5) {
#pragma unroll
                for (int i = 1; i < 10; ++i) {
                    const int diff = (lq[i - 1] - lq[i] + J) >> 1;
                    if (diff > 0) {
                        lq[i - 1] -= diff;
                        lq[i] += diff;
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < 10; ++i) {
                int s = wmul(lq[i], kMaSum[l0][i]);
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    s = wadd(s, wmul(lq_prev[10 * k + i], kMaPred[l0][k][i]));
                lsf[i] = i16(s >> 15);
                lsf_prev[i] = lsf[i];     // the values before the sort
            }
            prev_mode = l0;
#pragma unroll
            for (int j = 9; j > 0; --j) {
#pragma unroll
                for (int i = 0; i < j; ++i) {
                    const int a = lsf[i], c = lsf[i + 1];
                    lsf[i] = min(a, c);
                    lsf[i + 1] = max(a, c);
                }
            }
            lsf[0] = max(lsf[0], 40);
#pragma unroll
            for (int i = 0; i < 9; ++i)
                lsf[i + 1] = max(lsf[i + 1], lsf[i] + 321);
            lsf[9] = min(lsf[9], 25681);
        }
        __syncwarp();                 // every lane has read lq_prev
        if (lane == 0) {
#pragma unroll
            for (int i = 0; i < 10; ++i) {
                lq_prev[30 + i] = lq_prev[20 + i];
                lq_prev[20 + i] = lq_prev[10 + i];
                lq_prev[10 + i] = lq_prev[i];
                lq_prev[i] = lq[i];
            }
        }
        {   // LSF -> LSP; the first subframe's LP from the mean with the
            // previous frame's LSP
            int lsp[10], mid[10], lp[10];
#pragma unroll
            for (int i = 0; i < 10; ++i) {
                const int freq = i16(wmul(lsf[i], 20861) >> 15);
                const int ind = (freq >> 8) & 63;
                lsp[i] = i16(kBaseCos[ind] +
                             ((kSlopeCos[ind] * (freq & 0xFF)) >> 12));
                mid[i] = (lsp[i] >> 1) + (lsp_prev[i] >> 1);
                lsp_prev[i] = lsp[i];
            }
            lsp2lp(mid, lp);
            if (lane == 0)
#pragma unroll
                for (int i = 0; i < 10; ++i) s_lp[i] = lp[i];
            lsp2lp(lsp, lp);
            if (lane == 0)
#pragma unroll
                for (int i = 0; i < 10; ++i) s_lp[10 + i] = lp[i];
        }
        __syncwarp();

        for (int sf = 0; sf < 2; ++sf) {
            const int off = sf * kSub;
            int pd3x;
            if (sf == 0)
                pd3x = (bad_pitch || data_error) ? 3 * pitch_prev + 1
                       : ac0 >= 197 ? 3 * ac0 - 335 : ac0 + 59;
            else
                pd3x = data_error ? 3 * pitch_prev + 1
                       : ac1 + 3 * clampi(pitch_prev - 5, kPitchMin,
                                          kPitchMax - 9) - 1;
            const int pd_int = pd3x / 3;          // pd3x >= 1
            {   // adaptive codebook: 1/3 interpolation, rounds of
                // lag - 10 samples (at least 1); the filter is read flat,
                // so filter[i][3 - frac] is row i + 1's first tap at frac 0
                int frac = -(pd3x % 3 - 1), pd = pd_int;
                if (frac < 0) {
                    frac += 3;
                    pd += 1;
                }
                int c1[10], c2[10];
#pragma unroll
                for (int i = 0; i < 10; ++i) {
                    c1[i] = kInterpFlat[3 * i + frac];
                    c2[i] = kInterpFlat[3 * i + 3 - frac];
                }
                const int step = max(pd - 10, 1), base = kExcOff + off;
                for (int n0 = 0; n0 < kSub; n0 += step) {
                    const int end = min(n0 + step, kSub);
                    for (int n = n0 + lane; n < end; n += 32) {
                        const int *e = exc + base + n - pd;
                        int v = 0;
#pragma unroll
                        for (int i = 0; i < 10; ++i) {
                            v = clampi(v + e[-i] * c1[i], -(1 << 30),
                                       (1 << 30) - 1);
                            v = clampi(v + e[i + 1] * c2[i], -(1 << 30),
                                       (1 << 30) - 1);
                        }
                        exc[base + n] = g729_round(wshl(v, 1));
                    }
                    __syncwarp();
                }
            }
            // an erased frame draws its fixed-codebook parameters
            int fci = p[7 + sf], psi = p[9 + sf];
            if (data_error) {
                const int r1 = (31821 * rand_value + 13849) & 0xFFFF;
                const int r2 = (31821 * r1 + 13849) & 0xFFFF;
                rand_value = r2;
                fci = r1 & 0x1FFF;
                psi = r2 & 0x000F;
            }
            {   // fixed codebook: 4 pulses of +-1 (Q13)
                int idx[4], val[4];
#pragma unroll
                for (int i = 0; i < 3; ++i) {
                    idx[i] = (fci & 7) * 5 + i;
                    val[i] = psi & 1 ? 8191 : -8192;
                    fci >>= 3;
                    psi >>= 1;
                }
                idx[3] = ((fci >> 1) & 7) * 5 + 3 + (fci & 1);
                val[3] = psi & 1 ? 8191 : -8192;
#pragma unroll
                for (int i = 0; i < 4; ++i) data_error |= idx[i] >= kSub;
                for (int n = lane; n < kSub; n += 32) {
                    int v = 0;
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        if (idx[i] == n) v = val[i];
                    s_fc[n] = v;
                }
                __syncwarp();
                // pitch sharpening fc[n] += (fc[n - lag] sharp) >> 14, in
                // rounds of the lag
                if (pd_int == 0) {
                    for (int n = lane; n < kSub; n += 32)
                        s_fc[n] = i16(s_fc[n] +
                                      ((s_fc[n] * pitch_sharp) >> 14));
                    __syncwarp();
                } else {
                    for (int s = pd_int; s < kSub; s += pd_int) {
                        const int end = min(s + pd_int, kSub);
                        for (int n = s + lane; n < end; n += 32)
                            s_fc[n] = i16(s_fc[n] + ((s_fc[n - pd_int] *
                                                      pitch_sharp) >> 14));
                        __syncwarp();
                    }
                }
            }
            // gains
            if (data_error) {
                gain_pitch = min((29491 * gain_pitch) >> 15, 29491);
                gain_code = (8028 * gain_code) >> 13;
                const int avg = pred[3] + pred[2] + pred[1] + pred[0];
                pred[3] = pred[2];
                pred[2] = pred[1];
                pred[1] = pred[0];
                pred[0] = max((avg >> 2) - 4096, -14336);
            } else {
                const int ga = p[11 + sf], gb = p[13 + sf];
                int e2 = 0;
                for (int n = lane; n < kSub; n += 32)
                    e2 = wadd(e2, wmul(s_fc[n], s_fc[n]));
                int energy = warp_sum(e2);
                energy = mul_sh15(l_log2(max(energy, 1)), -24660);
                energy = wadd(energy, kLog2Sub + 0xD8888 - 2);
                energy = wshl(energy, 10);
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    energy = wadd(energy, wmul(pred[k], kMaCoeff[k]));
                energy = wmul(5439, energy >> 15) >> 8;
                const int expn = energy >> 15;
                energy = l_pow2(energy & 0x7FFF) & 0x7FFF;
                const int cb1 = kCbGa[ga][1] + kCbGb[gb][1];
                pred[3] = pred[2];
                pred[2] = pred[1];
                pred[1] = pred[0];
                pred[0] = i16(wmul(24660, (l_log2(cb1) >> 2) - (13 << 13))
                              >> 15);
                energy = wmul(energy, cb1 >> 1);
                if (25 - expn > 0)
                    energy >>= min(25 - expn, 31);
                else
                    energy = expn - 25 >= 32 ? 0 : wshl(energy, expn - 25);
                gain_code = i16(energy);
                gain_pitch = kCbGa[ga][0] + kCbGb[gb][0];
            }
            pitch_sharp = clampi(gain_pitch, kSharpMin, kSharpMax);
            const int a0 = kExcOff + off;
            for (int n = lane; n < kSub; n += 32) {
                const int s = wadd(wmul(exc[a0 + n], gain_pitch),
                                   wmul(s_fc[n], gain_code));
                exc[a0 + n] = g729_round(
                    wshl(clampi(s, -(32768 << 14), 32767 << 14), 2));
            }
            __syncwarp();
            // LP synthesis; on an overflow the whole excitation buffer is
            // scaled down by 4 and the subframe synthesised again, clipped
            int lp[10];
#pragma unroll
            for (int i = 0; i < 10; ++i) lp[i] = s_lp[10 * sf + i];
            int ovf = 0;
            if (lane == 0) {
                int h[10];
#pragma unroll
                for (int i = 0; i < 10; ++i) h[i] = syn_mem[i];
                ovf = synthesis<false>(lp, exc + a0, h, s_sp);
                if (!ovf)
#pragma unroll
                    for (int i = 0; i < 10; ++i) syn_mem[i] = h[i];
            }
            ovf = __shfl_sync(kFull, ovf, 0);
            if (ovf) {
                for (int k = lane; k < kExcLen; k += 32) exc[k] >>= 2;
                __syncwarp();
                if (lane == 0) synthesis<true>(lp, exc + a0, syn_mem, s_sp);
            }
            __syncwarp();

            // ---- postfilter
            int lp_gn[10], lp_gd[10];
#pragma unroll
            for (int i = 0; i < 10; ++i) {
                lp_gn[i] = i16(wmul(lp[i], kGammaPowsN[i]) >> 15);
                lp_gd[i] = i16(wmul(lp[i], kGammaPowsD[i]) >> 15);
            }
            int g2 = 0;
            for (int n = lane; n < kSub; n += 32)
                g2 = wadd(g2, wmul(s_sp[n] >> 4, s_sp[n] >> 4));
            const int gain_before = warp_sum(g2);
            // residual of A(z/GAMMA_N) into res[143..182]
            for (int n = lane; n < kSub; n += 32) {
                int s = wshl(s_sp[n], 12);
#pragma unroll
                for (int i = 0; i < 10; ++i) {
                    const int k = n - i - 1;
                    s = wadd(s, wmul(lp_gn[i],
                                     k >= 0 ? s_sp[k] : st[kPosMem + 10 + k]));
                }
                res[kPitchMax + n] = g729_round(
                    wshl(clampi(s, -(32768 << 12), 32767 << 12), 4));
            }
            __syncwarp();
            if (lane < 10) st[kPosMem + lane] = s_sp[kSub - 10 + lane];
            // long-term filter: lanes 0-6 the correlations at the 7 lags
            // around the pitch, 7-13 the lags' energies, 14 the energy now
            const int base = min(pd_int, kPitchMax - 3);
            const int kl = lane < 7 ? base - 3 + lane
                           : lane < 14 ? base - 10 + lane : 0;
            uint32_t acc = 0;
            for (int n = 0; n < kSub; ++n) {
                const int a = res[kPitchMax - kl + n] >> 1;
                const int c = lane >= 7 && lane < 14
                                  ? a : res[kPitchMax + n] >> 1;
                acc += (uint32_t)a * (uint32_t)c;
            }
            int best = 0, corr_max = __shfl_sync(kFull, (int)acc, 0);
#pragma unroll
            for (int j = 1; j < 7; ++j) {
                const int c = __shfl_sync(kFull, (int)acc, j);
                if (c > corr_max) {
                    corr_max = c;
                    best = j;
                }
            }
            int corr_t0 = __shfl_sync(kFull, (int)acc, 7 + best);
            int corr_0 = __shfl_sync(kFull, (int)acc, 14);
            const int int_t0 = base + best - 3;
            const int top = av_log2((uint32_t)max(max(max(corr_0, corr_t0),
                                                      corr_max), 1));
            if (top > 14) {
                corr_t0 >>= top - 14;
                corr_0 >>= top - 14;
                corr_max >>= top - 14;
            }
            int gl;
            if (wmul(corr_max, corr_max) < (wmul(corr_0, corr_t0) >> 1))
                gl = 0;
            else if (corr_t0 == 0 || corr_max > corr_t0)
                gl = 32768;
            else
                gl = l_div(corr_max, max(corr_t0, 1), 15);
            gl = (gl * kGammaP) >> 15;
            const int inv = gl < -32768 ? 0 : l_div(32768, 32768 + gl, 15);
            const int glgp = 32768 - inv;
            for (int n = lane; n < kSub; n += 32)
                s_f1[n] = i16(wadd(wmul(res[kPitchMax + n], inv),
                                   wmul(res[kPitchMax - int_t0 + n], glgp))
                              >> 15);
            {   // the residual moves down a subframe (read, then write)
                int keep[5];
#pragma unroll
                for (int j = 0; j < 5; ++j) {
                    const int k = lane + 32 * j;
                    keep[j] = k < kPitchMax ? res[kSub + k] : 0;
                }
                __syncwarp();
#pragma unroll
                for (int j = 0; j < 5; ++j) {
                    const int k = lane + 32 * j;
                    if (k < kPitchMax) res[k] = keep[j];
                }
            }
            {   // tilt compensation: the impulse response of
                // A(z/gn)/A(z/gd) over 22 samples, then its first-order
                // correction
                int h[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
                int rh0 = 0, rh1 = 0, prevh = 0;
#pragma unroll
                for (int t2 = 0; t2 < 22; ++t2) {
                    int s = t2 == 0 ? 4096 : t2 <= 10 ? lp_gn[t2 - 1] : 0;
#pragma unroll
                    for (int i = 9; i >= 0; --i)
                        s = wsub(s, wmul(lp_gd[i], h[9 - i]) >> 12);
                    s = i16(s);
#pragma unroll
                    for (int i = 0; i < 9; ++i) h[i] = h[i + 1];
                    h[9] = s;
                    rh0 = wadd(rh0, wmul(s, s));
                    if (t2 > 0) rh1 = wadd(rh1, wmul(prevh, s));
                    prevh = s;
                }
                rh0 >>= 12;
                rh1 = wmul(rh1 >> 12, kGammaT) >> 15;
                const int gt = rh1 > 0 ? wsub(0, l_div(rh1, max(rh0, 1), 12))
                                       : 0;
                __syncwarp();
                for (int n = lane; n < kSub; n += 32) {
                    const int pv = n ? s_f1[n - 1] : ht_prev;
                    s_f2[n] = i16(s_f1[n] + (wmul(gt, pv) >> 12));
                }
                ht_prev = s_f1[kSub - 1];
            }
            __syncwarp();
            if (lane == 0) synthesis<true>(lp_gd, s_f2, res_mem, s_sp);
            __syncwarp();
            g2 = 0;
            for (int n = lane; n < kSub; n += 32)
                g2 = wadd(g2, wmul(s_sp[n] >> 4, s_sp[n] >> 4));
            const int gain_after = warp_sum(g2);
            if (lane == 0) {          // adaptive gain control
                int *out = s_pcm + off;
                if (gain_after != 0) {
                    const int gain = gain_before != 0
                        ? l_inv_sqrt(max(l_div(gain_after,
                                               max(gain_before, 1), 12), 1))
                              >> 11
                        : 0;
                    int gp = gain_coeff;
#pragma unroll
                    for (int n = 0; n < kSub; ++n) {
                        gp = wadd(wmul(29491, gp), wmul(3276, gain)) >> 15;
                        out[n] = i16(wmul(s_sp[n], gp) >> 12);
                    }
                    gain_coeff = gp;
                } else {
                    for (int n = 0; n < kSub; ++n) out[n] = s_sp[n];
                }
            }
            pitch_prev = data_error ? min(pitch_prev + 1, kPitchMax) : pd_int;
            __syncwarp();
        }
        {   // the excitation buffer moves down a frame (read, then write)
            int keep[5];
#pragma unroll
            for (int j = 0; j < 5; ++j) {
                const int k = lane + 32 * j;
                keep[j] = k < kExcOff ? exc[2 * kSub + k] : 0;
            }
            __syncwarp();
#pragma unroll
            for (int j = 0; j < 5; ++j) {
                const int k = lane + 32 * j;
                if (k < kExcOff) exc[k] = keep[j];
            }
        }
        if (lane == 0) {              // the 100 Hz high-pass
#pragma unroll
            for (int n = 0; n < 2 * kSub; ++n) {
                const int x = s_pcm[n];
                int f0 = wadd(wadd(wmul(7699, x - 2 * hz1 + hz2),
                                   mul_sh15(hf2, -7667)),
                              mul_sh15(hf1, 15836));
                f0 = wshl(f0, 2);
                s_out[n] = (int16_t)clampi(f0 >> 14, -32768, 32767);
                hf2 = hf1;
                hf1 = f0;
                hz2 = hz1;
                hz1 = x;
            }
        }
        __syncwarp();
        int16_t *dst = pcm_out + (t * nb + b) * (2 * kSub);
        for (int n = lane; n < 2 * kSub; n += 32) dst[n] = s_out[n];
    }

    // the state after frame T
    __syncwarp();
    if (lane == 0) {
        st[kPitchPrev] = pitch_prev;
        st[kGainPitch] = gain_pitch;
        st[kGainCode] = gain_code;
        st[kPitchSharp] = pitch_sharp;
        st[kHtPrev] = ht_prev;
        st[kRand] = rand_value;
        st[kPrevMode] = prev_mode;
#pragma unroll
        for (int i = 0; i < 10; ++i) {
            st[kLspPrev + i] = lsp_prev[i];
            st[kLsfPrev + i] = lsf_prev[i];
            st[kSynMem + i] = syn_mem[i];
            st[kResMem + i] = res_mem[i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) st[kPredEnerg + i] = pred[i];
        st[kGainCoeff] = gain_coeff;
        st[kHpfF] = hf1;
        st[kHpfF + 1] = hf2;
        st[kHpfZ] = hz1;
        st[kHpfZ + 1] = hz2;
    }
    __syncwarp();
    for (int k = lane; k < kStateWords; k += 32) gst[k] = st[k];
}

}  // namespace

// The state's words a stream (kernels/g729.py checks its layout by it).
extern "C" long long amv_g729_state_words() { return kStateWords; }

// parms int32 [t, b, 16] (codecs/g729a.py:PARM_FIELDS), state int32
// [b, 546] read before frame 0 and written after frame t, pcm int16
// [t, b, 80].
extern "C" int amv_g729_decode(const void *parms, long long t, long long b,
                               void *state, void *pcm, void *stream) {
    if (t > 0 && b > 0)
        g729_decode_kernel<<<(unsigned)b, 32, 0, (cudaStream_t)stream>>>(
            (const int32_t *)parms, t, b, (int32_t *)state, (int16_t *)pcm);
    return (int)cudaGetLastError();
}
'''
