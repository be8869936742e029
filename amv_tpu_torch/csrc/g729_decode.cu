// Kernel G: G.729 Annex A decoding of B independent streams over T frames
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
// mostly short recurrences (LP synthesis, 40 steps of 10 taps, twice a
// subframe; the adaptive codebook's interpolation when the lag is shorter
// than the subframe; the AGC's gain and the 80-step high-pass).  The bytes
// (10 in and 160 out a frame) are nothing beside that, so the floor is
// the latency of a frame's longest dependent chain times T.
//
// Design: a CTA of four warps per stream, one warp per stage, run as a
// software pipeline over frames.  At step s the parameter warp decodes
// frame s (LSF -> LSP -> the two LP filters, the postfilter's weighted
// filters and tilt factor, the lags, the fixed codebook and the gains),
// the excitation warp frame s - 1 (adaptive codebook, excitation update,
// LP synthesis with its overflow redo), the postfilter warp frame s - 2
// (residual, long-term filter, tilt, 1/A(z/gd), AGC) and the high-pass
// warp frame s - 3 (the 100 Hz high-pass and the store).  No later stage
// feeds an earlier one: the only feedback, the overflow rescale of exc,
// stays inside the excitation warp, which owns exc and the synthesis
// memory; each warp owns its stage's state.  A frame crosses from stage
// to stage through a ring of 4 slots in shared memory, with one
// __syncthreads() a step, so a frame's time is the longest stage's and
// not their sum.  The pipeline fills over the first 3 steps and drains
// over the last 3; the state after frame T is each stage's after it.
// Within a stage the lanes split the work that is parallel over a
// subframe's samples (the interpolation in rounds of lag - 10 samples,
// the fixed codebook's sharpening in rounds of the lag, the excitation
// update, the residual FIR, the long-term filter's 15 correlations, the
// energy sums as warp sums, which wrap as the C sums do); lane 0 alone
// runs the recurrences that write arrays (the syntheses, the AGC, the
// high-pass), unrolled with the history in registers.  The tables live
// in __constant__ memory (every read of one is warp-uniform).  Two builds
// of the kernel differ in their register budget, and the launch takes the
// one that fits the number of streams (amv_g729_decode below).
//
// The decoder's steps are in g729_common.cuh, shared with kernel K's
// shadow decoder (g729_encode.cu).

#include "g729_common.cuh"

namespace {

using namespace g729;

constexpr int kWarps = 4, kSlots = 4;

// a frame in flight between the stages
struct Slot {
    int lp[20];            // the two subframes' LP filters (Q12)
    int lp_gn[20], lp_gd[20];   // A(z/gn) and A(z/gd) of each subframe
    int gt[2];             // the tilt factor of each subframe
    int pd3x[2], pd_int[2];     // the lags
    int gp[2], gc[2];      // the gains
    int fc[2 * kSub];      // the fixed codebook vectors, sharpened
    int sp[2 * kSub];      // the synthesised speech
    int pcm[2 * kSub];     // the postfilter's output
};

// kMinCtas CTAs an SM at the least: 4 lets a thread keep 128 registers
// (the unrolled syntheses' histories), 8 holds it to 64 (some spilled)
template <int kMinCtas>
__global__ void __launch_bounds__(32 * kWarps, kMinCtas)
g729_decode_kernel(const int32_t *__restrict__ parms, long long nt,
                   long long nb, int32_t *__restrict__ state,
                   int16_t *__restrict__ pcm_out) {
    __shared__ int st[kStateWords];
    __shared__ Slot ring[kSlots];
    __shared__ int s_f1[kSub], s_f2[kSub], s_sp[kSub];  // postfilter stages
    __shared__ int16_t s_out[2 * kSub];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long b = blockIdx.x;
    int32_t *gst = state + b * kStateWords;
    for (int k = threadIdx.x; k < kStateWords; k += 32 * kWarps)
        st[k] = gst[k];
    __syncthreads();
    int *exc = st + kExc, *res = st + kResidual, *lq_prev = st + kLqPrev;
    // each warp's state, uniform in its lanes (the arrays of a lane-0
    // recurrence are lane 0's)
    int pitch_prev = st[kPitchPrev], gain_pitch = st[kGainPitch];
    int gain_code = st[kGainCode], pitch_sharp = st[kPitchSharp];
    int rand_value = st[kRand], prev_mode = st[kPrevMode];
    int lsp_prev[10], lsf_prev[10], pred[4];
    int syn_mem[10];
    int res_mem[10], ht_prev = st[kHtPrev], gain_coeff = st[kGainCoeff];
    int hf1 = st[kHpfF], hf2 = st[kHpfF + 1];
    int hz1 = st[kHpfZ], hz2 = st[kHpfZ + 1];
#pragma unroll
    for (int i = 0; i < 10; ++i) {
        lsp_prev[i] = st[kLspPrev + i];
        lsf_prev[i] = st[kLsfPrev + i];
        syn_mem[i] = st[kSynMem + i];
        res_mem[i] = st[kResMem + i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) pred[i] = st[kPredEnerg + i];

    const int32_t *pp = parms + b * 16 + min(lane, 15);
    int next = warp == 0 && nt > 0 ? pp[0] : 0;
    for (long long s = 0; s < nt + kWarps - 1; ++s) {
        const long long t = s - warp;
        if (t >= 0 && t < nt) {
            Slot &f = ring[t & (kSlots - 1)];
            if (warp == 0) {
                // ---- parameters of frame t
                const int mine = next;
                if (t + 1 < nt) next = pp[(t + 1) * nb * 16];
                int p[16];
#pragma unroll
                for (int k = 0; k < 16; ++k)
                    p[k] = __shfl_sync(kFull, mine, k);
                const bool era = p[15] != 0;
                const int pidx = p[5] >> 2;
                const uint32_t pword = pidx >= 32 ? 0x69969669u
                                                  : 0x96696996u;
                const bool bad_pitch =
                    ((((pword >> (pidx & 31)) & 1) ^ p[4]) & 1) == 0;
                bool data_error = era;
                int lsf[10], lq[10], lp[20];
                decode_lsf(lq_prev, era, p[0], p[1], p[2], p[3], lsf_prev,
                           prev_mode, lq, lsf);
                __syncwarp();          // every lane has read lq_prev
                if (lane == 0) rotate_lq(lq_prev, lq);
                decode_lp(lsf, lsp_prev, lp);
#pragma unroll
                for (int sf = 0; sf < 2; ++sf) {
                    // the postfilter's filters and tilt factor: the
                    // impulse response of A(z/gn)/A(z/gd) over 22 samples,
                    // then its first-order correction
                    int gn[10], gd[10];
#pragma unroll
                    for (int i = 0; i < 10; ++i) {
                        gn[i] = i16(wmul(lp[10 * sf + i], kGammaPowsN[i])
                                    >> 15);
                        gd[i] = i16(wmul(lp[10 * sf + i], kGammaPowsD[i])
                                    >> 15);
                    }
                    int h[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
                    int rh0 = 0, rh1 = 0, prevh = 0;
#pragma unroll
                    for (int t2 = 0; t2 < 22; ++t2) {
                        int v = t2 == 0 ? 4096 : t2 <= 10 ? gn[t2 - 1] : 0;
#pragma unroll
                        for (int i = 9; i >= 0; --i)
                            v = wsub(v, wmul(gd[i], h[9 - i]) >> 12);
                        v = i16(v);
#pragma unroll
                        for (int i = 0; i < 9; ++i) h[i] = h[i + 1];
                        h[9] = v;
                        rh0 = wadd(rh0, wmul(v, v));
                        if (t2 > 0) rh1 = wadd(rh1, wmul(prevh, v));
                        prevh = v;
                    }
                    rh0 >>= 12;
                    rh1 = wmul(rh1 >> 12, kGammaT) >> 15;
                    const int gt = rh1 > 0
                        ? wsub(0, l_div(rh1, max(rh0, 1), 12)) : 0;
                    // the lags, the fixed codebook (an erased frame draws
                    // its parameters) and the gains
                    const int pd3x = pitch_3x(sf, p[5 + sf], bad_pitch,
                                              data_error, pitch_prev);
                    const int pd_int = pd3x / 3;        // pd3x >= 1
                    int fci = p[7 + sf], psi = p[9 + sf];
                    if (data_error) {
                        const int r1 = (31821 * rand_value + 13849) & 0xFFFF;
                        const int r2 = (31821 * r1 + 13849) & 0xFFFF;
                        rand_value = r2;
                        fci = r1 & 0x1FFF;
                        psi = r2 & 0x000F;
                    }
                    int *fc = f.fc + kSub * sf;
                    data_error |= fc_vector(fci, psi, pd_int, pitch_sharp,
                                            fc, lane);
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
                            e2 = wadd(e2, wmul(fc[n], fc[n]));
                        gain_code = code_gain(warp_sum(e2), pred, ga, gb);
                        gain_pitch = kCbGa[ga][0] + kCbGb[gb][0];
                    }
                    pitch_sharp = clampi(gain_pitch, kSharpMin, kSharpMax);
                    if (lane == 0) {
#pragma unroll
                        for (int i = 0; i < 10; ++i) {
                            f.lp[10 * sf + i] = lp[10 * sf + i];
                            f.lp_gn[10 * sf + i] = gn[i];
                            f.lp_gd[10 * sf + i] = gd[i];
                        }
                        f.gt[sf] = gt;
                        f.pd3x[sf] = pd3x;
                        f.pd_int[sf] = pd_int;
                        f.gp[sf] = gain_pitch;
                        f.gc[sf] = gain_code;
                    }
                    pitch_prev = data_error ? min(pitch_prev + 1, kPitchMax)
                                            : pd_int;
                }
            } else if (warp == 1) {
                // ---- excitation and LP synthesis of frame t
                for (int sf = 0; sf < 2; ++sf) {
                    const int off = sf * kSub;
                    ac_vector(exc, f.pd3x[sf], off, lane);
                    mem_update(exc, f.fc + off, f.gp[sf], f.gc[sf], off,
                               lane);
                    int lp[10];
#pragma unroll
                    for (int i = 0; i < 10; ++i) lp[i] = f.lp[10 * sf + i];
                    synthesise(lp, exc, off, syn_mem, f.sp + off, lane);
                }
                shift_exc(exc, lane);
            } else if (warp == 2) {
                // ---- the postfilter of frame t
                for (int sf = 0; sf < 2; ++sf) {
                    const int off = sf * kSub;
                    const int *sp = f.sp + off;
                    int lp_gn[10], lp_gd[10];
#pragma unroll
                    for (int i = 0; i < 10; ++i) {
                        lp_gn[i] = f.lp_gn[10 * sf + i];
                        lp_gd[i] = f.lp_gd[10 * sf + i];
                    }
                    int g2 = 0;
                    for (int n = lane; n < kSub; n += 32)
                        g2 = wadd(g2, wmul(sp[n] >> 4, sp[n] >> 4));
                    const int gain_before = warp_sum(g2);
                    // residual of A(z/GAMMA_N) into res[143..182]
                    for (int n = lane; n < kSub; n += 32) {
                        int v = wshl(sp[n], 12);
#pragma unroll
                        for (int i = 0; i < 10; ++i) {
                            const int k = n - i - 1;
                            v = wadd(v, wmul(lp_gn[i], k >= 0
                                             ? sp[k] : st[kPosMem + 10 + k]));
                        }
                        res[kPitchMax + n] = g729_round(
                            wshl(clampi(v, -(32768 << 12), 32767 << 12), 4));
                    }
                    __syncwarp();
                    if (lane < 10) st[kPosMem + lane] = sp[kSub - 10 + lane];
                    // long-term filter: lanes 0-6 the correlations at the 7
                    // lags around the pitch, 7-13 the lags' energies, 14 the
                    // energy now
                    const int base = min(f.pd_int[sf], kPitchMax - 3);
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
                    const int top = av_log2((uint32_t)max(
                        max(max(corr_0, corr_t0), corr_max), 1));
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
                    const int inv = gl < -32768 ? 0
                                    : l_div(32768, 32768 + gl, 15);
                    const int glgp = 32768 - inv;
                    for (int n = lane; n < kSub; n += 32)
                        s_f1[n] = i16(wadd(wmul(res[kPitchMax + n], inv),
                                           wmul(res[kPitchMax - int_t0 + n],
                                                glgp)) >> 15);
                    {   // the residual moves down a subframe (read, then
                        // write)
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
                    // tilt compensation with the parameter warp's factor
                    const int gt = f.gt[sf];
                    for (int n = lane; n < kSub; n += 32) {
                        const int pv = n ? s_f1[n - 1] : ht_prev;
                        s_f2[n] = i16(s_f1[n] + (wmul(gt, pv) >> 12));
                    }
                    ht_prev = s_f1[kSub - 1];
                    __syncwarp();
                    if (lane == 0) synthesis<true>(lp_gd, s_f2, res_mem, s_sp);
                    __syncwarp();
                    g2 = 0;
                    for (int n = lane; n < kSub; n += 32)
                        g2 = wadd(g2, wmul(s_sp[n] >> 4, s_sp[n] >> 4));
                    const int gain_after = warp_sum(g2);
                    if (lane == 0) {      // adaptive gain control
                        int *out = f.pcm + off;
                        if (gain_after != 0) {
                            const int gain = gain_before != 0
                                ? l_inv_sqrt(max(l_div(gain_after,
                                                       max(gain_before, 1),
                                                       12), 1)) >> 11
                                : 0;
                            int gp = gain_coeff;
#pragma unroll
                            for (int n = 0; n < kSub; ++n) {
                                gp = wadd(wmul(29491, gp), wmul(3276, gain))
                                     >> 15;
                                out[n] = i16(wmul(s_sp[n], gp) >> 12);
                            }
                            gain_coeff = gp;
                        } else {
                            for (int n = 0; n < kSub; ++n) out[n] = s_sp[n];
                        }
                    }
                    __syncwarp();
                }
            } else {
                // ---- the 100 Hz high-pass of frame t, and its store
                if (lane == 0) {
#pragma unroll
                    for (int n = 0; n < 2 * kSub; ++n) {
                        const int x = f.pcm[n];
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
        }
        __syncthreads();
    }

    // the state after frame T: each stage's own
    if (lane == 0) {
        if (warp == 0) {
            st[kPitchPrev] = pitch_prev;
            st[kGainPitch] = gain_pitch;
            st[kGainCode] = gain_code;
            st[kPitchSharp] = pitch_sharp;
            st[kRand] = rand_value;
            st[kPrevMode] = prev_mode;
#pragma unroll
            for (int i = 0; i < 10; ++i) {
                st[kLspPrev + i] = lsp_prev[i];
                st[kLsfPrev + i] = lsf_prev[i];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) st[kPredEnerg + i] = pred[i];
        } else if (warp == 1) {
#pragma unroll
            for (int i = 0; i < 10; ++i) st[kSynMem + i] = syn_mem[i];
        } else if (warp == 2) {
#pragma unroll
            for (int i = 0; i < 10; ++i) st[kResMem + i] = res_mem[i];
            st[kHtPrev] = ht_prev;
            st[kGainCoeff] = gain_coeff;
        } else {
            st[kHpfF] = hf1;
            st[kHpfF + 1] = hf2;
            st[kHpfZ] = hz1;
            st[kHpfZ + 1] = hz2;
        }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < kStateWords; k += 32 * kWarps)
        gst[k] = st[k];
}

}  // namespace

// The state's words a stream (kernels/g729.py checks its layout by it).
extern "C" long long amv_g729_state_words() { return kStateWords; }

// parms int32 [t, b, 16] (codecs/g729a.py:PARM_FIELDS), state int32
// [b, 546] read before frame 0 and written after frame t, pcm int16
// [t, b, 80].  The build at 128 registers a thread runs each stream's
// chain fastest while the card holds every stream at once; past that
// (b over its resident CTAs, 4 an SM: 528 on an H100) the build at 64
// holds twice the streams, and one wave at 8 CTAs an SM beats two at 4
// (1,024 x 6,000 frames: 116 against 154 ms on an H100; one stream 489
// against 358 ms: tools/time_g729.py).
extern "C" int amv_g729_decode(const void *parms, long long t, long long b,
                               void *state, void *pcm, void *stream) {
    if (t > 0 && b > 0) {
        int dev = 0, sms = 0, per_sm = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, g729_decode_kernel<4>, 32 * kWarps, 0);
        const auto kernel = b <= (long long)sms * per_sm
                                ? g729_decode_kernel<4> : g729_decode_kernel<8>;
        kernel<<<(unsigned)b, 32 * kWarps, 0, (cudaStream_t)stream>>>(
            (const int32_t *)parms, t, b, (int32_t *)state, (int16_t *)pcm);
    }
    return (int)cudaGetLastError();
}
