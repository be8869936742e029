// G.729 Annex A's decoder steps for kernels G (g729_decode.cu) and K
// (g729_encode.cu): the integer helpers, the LSF/LSP/LP decode, the
// adaptive and fixed codebooks, the gains, the excitation update and the
// LP synthesis with its overflow redo.  K's shadow decoder runs these
// same functions, so an encoder's state and a decoder's of its frames are
// one piece of code.
//
// A function marked "(warp)" is called by all 32 lanes of one warp, which
// split its parallel work and meet at __syncwarp(); "(uniform)" means
// every lane computes the same values in registers; "(lane 0)" is called
// by lane 0 alone.
//
// Arithmetic: int32 sums and products wrap (formed in uint32), right shifts
// are arithmetic, and the JAX package's int32 forms are kept where the
// oracle's Python integers would not wrap (the same bits for the inputs a
// stream can reach).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "g729_tables.cuh"

namespace g729 {

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
__device__ __forceinline__ int l_log2(int value) {
    const int p = av_log2((uint32_t)value);
    const uint32_t r = (uint32_t)value << (31 - p);
    return (p << 15) + (interp(kTabLog2, (int)((r & 0x7C000000u) >> 26),
                               (int)((r & 0x03FFF800u) >> 11)) >> 15);
}
__device__ __forceinline__ int l_pow2(int power) {
    return (interp(kTabPow2, (power & 0x7C00) >> 10, (power & 0x03FF) << 5)
            + 16384) >> 15;
}
__device__ __forceinline__ int l_inv_sqrt(int arg) {
    const int p = (av_log2((uint32_t)arg) >> 1) + 1;
    const uint32_t r = (uint32_t)arg << (32 - (p << 1));
    return (int)((uint32_t)interp(kTabInvSqrt, (int)(r >> 26) - 16,
                                  (int)((r >> 11) & 0x7FE0)) >> p);
}
// l_div with the x86 shift-count masking; floor division (the oracle's)
__device__ __forceinline__ int l_div(int num, int denom, int base) {
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
// (lane 0)
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

// LSP (Q15) -> LP (Q12) of one subframe (uniform)
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

// The frame's LSF (Q13, sorted and spaced) into lsf, and its quantizer
// output into lq: decoded from (l0, l1, l2, l3) and the MA memory lq_prev
// [4][10], or on an erasure restored from lsf_prev (which then stays);
// lsf_prev and prev_mode advance on a good frame.  The caller moves lq
// into lq_prev (`rotate_lq`) once every lane has read it.  (uniform)
__device__ __forceinline__ void decode_lsf(const int *lq_prev, bool era,
                                           int l0, int l1, int l2, int l3,
                                           int *lsf_prev, int &prev_mode,
                                           int *lq, int *lsf) {
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
        return;
    }
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
        lsf_prev[i] = lsf[i];         // the values before the sort
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
    for (int i = 0; i < 9; ++i) lsf[i + 1] = max(lsf[i + 1], lsf[i] + 321);
    lsf[9] = min(lsf[9], 25681);
}

// lq_prev [4][10] moves a frame down and takes lq (lane 0)
__device__ __forceinline__ void rotate_lq(int *lq_prev, const int *lq) {
#pragma unroll
    for (int i = 0; i < 10; ++i) {
        lq_prev[30 + i] = lq_prev[20 + i];
        lq_prev[20 + i] = lq_prev[10 + i];
        lq_prev[10 + i] = lq_prev[i];
        lq_prev[i] = lq[i];
    }
}

// LSF -> LSP; lp[0..9] the first subframe's LP filter (from the mean with
// the previous frame's LSP), lp[10..19] the second's; lsp_prev advances.
// (uniform)
__device__ __forceinline__ void decode_lp(const int *lsf, int *lsp_prev,
                                          int *lp) {
    int lsp[10], mid[10];
#pragma unroll
    for (int i = 0; i < 10; ++i) {
        const int freq = i16(wmul(lsf[i], 20861) >> 15);
        const int ind = (freq >> 8) & 63;
        lsp[i] = i16(kBaseCos[ind] + ((kSlopeCos[ind] * (freq & 0xFF)) >> 12));
        mid[i] = (lsp[i] >> 1) + (lsp_prev[i] >> 1);
        lsp_prev[i] = lsp[i];
    }
    lsp2lp(mid, lp);
    lsp2lp(lsp, lp + 10);
}

// The pitch lag of subframe sf as 3 x lag + frac + 1 (uniform)
__device__ __forceinline__ int pitch_3x(int sf, int ac, bool bad_pitch,
                                        bool data_error, int pitch_prev) {
    if (sf == 0)
        return (bad_pitch || data_error) ? 3 * pitch_prev + 1
               : ac >= 197 ? 3 * ac - 335 : ac + 59;
    return data_error ? 3 * pitch_prev + 1
           : ac + 3 * clampi(pitch_prev - 5, kPitchMin, kPitchMax - 9) - 1;
}

// The adaptive codebook's vector at lag pd3x / 3 (fraction pd3x % 3 - 1)
// written over exc[kExcOff + off + 0..39]: the 1/3 interpolation, in rounds
// of lag - 10 samples (at least 1; a round reads only samples the rounds
// before it wrote).  The filter is read flat, so filter[i][3 - frac] is
// row i + 1's first tap at frac 0.  (warp)
__device__ __forceinline__ void ac_vector(int *exc, int pd3x, int off,
                                          int lane) {
    int frac = -(pd3x % 3 - 1), pd = pd3x / 3;
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
                v = clampi(v + e[-i] * c1[i], -(1 << 30), (1 << 30) - 1);
                v = clampi(v + e[i + 1] * c2[i], -(1 << 30), (1 << 30) - 1);
            }
            exc[base + n] = g729_round(wshl(v, 1));
        }
        __syncwarp();
    }
}

// The fixed codebook's 4 pulses of +-1 (Q13) from (fci, psi) into fc[40],
// then its pitch sharpening fc[n] += (fc[n - lag] sharp) >> 14 in rounds
// of the lag; returns whether a pulse index left the subframe.  (warp)
__device__ __forceinline__ bool fc_vector(int fci, int psi, int pd_int,
                                          int pitch_sharp, int *fc,
                                          int lane) {
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
    bool err = false;
#pragma unroll
    for (int i = 0; i < 4; ++i) err |= idx[i] >= kSub;
    for (int n = lane; n < kSub; n += 32) {
        int v = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
            if (idx[i] == n) v = val[i];
        fc[n] = v;
    }
    __syncwarp();
    if (pd_int == 0) {
        for (int n = lane; n < kSub; n += 32)
            fc[n] = i16(fc[n] + ((fc[n] * pitch_sharp) >> 14));
        __syncwarp();
    } else {
        for (int s = pd_int; s < kSub; s += pd_int) {
            const int end = min(s + pd_int, kSub);
            for (int n = s + lane; n < end; n += 32)
                fc[n] = i16(fc[n] + ((fc[n - pd_int] * pitch_sharp) >> 14));
            __syncwarp();
        }
    }
    return err;
}

// The code gain of pair (ga, gb) for a fixed codebook vector of energy
// sum fc^2: the MA-predicted energy (pred, Q10 log) and the correction
// factor; pred advances.  (uniform)
__device__ __forceinline__ int code_gain(int energy, int *pred, int ga,
                                         int gb) {
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
    pred[0] = i16(wmul(24660, (l_log2(cb1) >> 2) - (13 << 13)) >> 15);
    energy = wmul(energy, cb1 >> 1);
    if (25 - expn > 0)
        energy >>= min(25 - expn, 31);
    else
        energy = expn - 25 >= 32 ? 0 : wshl(energy, expn - 25);
    return i16(energy);
}

// exc[kExcOff + off + n] = the gains' mix of itself and fc[n] (warp)
__device__ __forceinline__ void mem_update(int *exc, const int *fc, int gp,
                                           int gc, int off, int lane) {
    const int a0 = kExcOff + off;
    for (int n = lane; n < kSub; n += 32) {
        const int s = wadd(wmul(exc[a0 + n], gp), wmul(fc[n], gc));
        exc[a0 + n] = g729_round(wshl(clampi(s, -(32768 << 14), 32767 << 14),
                                      2));
    }
    __syncwarp();
}

// LP synthesis of the subframe at exc[kExcOff + off] into out[40] from
// syn_mem (lane 0's); on an overflow the whole excitation buffer is scaled
// down by 4 and the subframe synthesised again, clipped.  (warp)
__device__ __forceinline__ void synthesise(const int *lp, int *exc, int off,
                                           int *syn_mem, int *out,
                                           int lane) {
    const int a0 = kExcOff + off;
    int ovf = 0;
    if (lane == 0) {
        int h[10];
#pragma unroll
        for (int i = 0; i < 10; ++i) h[i] = syn_mem[i];
        ovf = synthesis<false>(lp, exc + a0, h, out);
        if (!ovf)
#pragma unroll
            for (int i = 0; i < 10; ++i) syn_mem[i] = h[i];
    }
    ovf = __shfl_sync(kFull, ovf, 0);
    if (ovf) {
        for (int k = lane; k < kExcLen; k += 32) exc[k] >>= 2;
        __syncwarp();
        if (lane == 0) synthesis<true>(lp, exc + a0, syn_mem, out);
    }
    __syncwarp();
}

// the excitation buffer moves down a frame (read, then write) (warp)
__device__ __forceinline__ void shift_exc(int *exc, int lane) {
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
    __syncwarp();
}

}  // namespace g729
