"""Time variants of kernel K (csrc/g729_encode.cu, the batch G.729A
encoder) against the shipped source on one GPU, in one process.  Each is
a text edit of a copy of the source, built by nvcc into its own library
(`time_g729.k_libraries`, with and, given `--phases`, without
-DK_PHASES), launched through ctypes on `--shape` (streams x frames of
seeded speech; default 1,024 x 600) and held bit for bit against the
shipped build (parameters and state):

* shipped: the source as it is;
* grid in blocks of 10: the pitch candidates' y in 4 blocks of 10
  outputs, the vector loaded anew each block (100 loads, not 40);
* looped grid: y in blocks of 8 with k in steps of 8 and a window of 15
  samples of the impulse response reloaded each step (a loop of a few
  hundred instructions; ~350 shared loads a candidate, not ~80);
* two grid paths: a second copy of the grid's loop, without the wrap's
  select, for lags of 40 and up;
* ACELP triples: a thread a triple of tracks 0-2, 3 matrix loads a
  combination (not a pair of tracks 0-1 with its rows in registers);
* no head overlap: the next frame's head (input, window,
  autocorrelation, Levinson) at the frame's start, not under the tail;
* signs on read: no signed matrix; each entry's sign flipped as the
  ACELP search reads it (no pass, one barrier fewer);
* 64 threads at any count: the 64-thread build also where the card
  holds every stream at 128 threads (at most 4 x SMs streams);
* ACELP group skip: each track-2 position's 16 combinations first as
  fast quotients (`__fdividef`, within 2 ulps), the exact divisions only
  where one reaches 0.99999 of the warp's best so far (a warp-uniform
  threshold, refreshed by shuffles each position): a combination
  strictly below a score already found cannot be the argmax.

All run in turns (in order, then in reverse), each the median of
`--reps` launches by CUDA events, with each one's resident CTAs an SM
(`cudaOccupancyMaxActiveBlocksPerMultiprocessor`, both builds) and, with
`--phases`, its time by phase.

    PYTHONPATH=. python3 amv_tpu_torch/tools/k_variants.py [--phases]

Prints one JSON line: the card's name and power limit, and for each
variant its times, resident CTAs and (with --phases) cycles by phase.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os

SOURCE = "g729_encode.cu"

# a C entry appended to every copy: K's resident CTAs an SM at 64 or 128
# threads, as the shipped entry sets the card up for them
RESIDENT = """
extern "C" int amv_k_resident(int threads) {
    int n = 0;
    cudaFuncSetAttribute(g729_encode_kernel<64>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    if (threads == 64)
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, g729_encode_kernel<64>, 64, 0);
    else
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, g729_encode_kernel<128>, 128, 0);
    return n;
}
"""

CANDIDATE = """__device__ __forceinline__ float candidate_score(const float (&hr)[kSub],
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
"""

BLOCKS_OF_10 = """__device__ __forceinline__ float candidate_score(const float (&hr)[kSub],
                                                 const float *u,
                                                 const float *tgt, int c) {
    constexpr int kBlock = 10;
    const int t = kPitchMin + c / 3, fr = c % 3 - 1;
    const int ti = fr > 0 ? t + 1 : t;
    const volatile float *w = u + (fr > 0 ? 2 : -fr) * kUps + kUps - ti;
    float e = 0.0f, cc = 0.0f;
#pragma unroll
    for (int n0 = 0; n0 < kSub; n0 += kBlock) {
        float y[kBlock];
#pragma unroll
        for (int k = 0; k < n0 + kBlock; ++k) {
            const float a = w[k < ti ? k : k - ti];
#pragma unroll
            for (int j = 0; j < kBlock; ++j) {
                if (k > n0 + j) continue;
                const float p = a * hr[n0 + j - k];
                y[j] = k == 0 ? p : y[j] + p;
            }
        }
#pragma unroll
        for (int j = 0; j < kBlock; ++j) {
            e = e + y[j] * y[j];
            cc = cc + y[j] * tgt[n0 + j];
        }
    }
    return pitch_score(e, cc);
}
"""

LOOPED = """struct Cand {
    const float *w, *w2;
    int ti;
};

__device__ __forceinline__ Cand candidate(const float *u, int c) {
    const int t = kPitchMin + c / 3, fr = c % 3 - 1;
    const int ti = fr > 0 ? t + 1 : t;
    const float *w = u + (fr > 0 ? 2 : -fr) * kUps + kUps - ti;
    return {w, w - ti, ti};
}

template <bool kShort>
__device__ __forceinline__ float vec(Cand v, int k) {
    return !kShort || k < v.ti ? v.w[k] : v.w2[k];
}

template <bool kShort>
__device__ __forceinline__ void y_block(const float *h, Cand v, int n0,
                                        float (&y)[8]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = 0.0f;
    for (int k0 = 0; k0 < n0; k0 += 8) {
        float hw[15];
#pragma unroll
        for (int i = 0; i < 15; ++i) hw[i] = h[n0 - k0 - 7 + i];
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
            const float a = vec<kShort>(v, k0 + kk);
#pragma unroll
            for (int j = 0; j < 8; ++j) y[j] = y[j] + a * hw[j + 7 - kk];
        }
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
        const float a = vec<kShort>(v, n0 + kk);
#pragma unroll
        for (int j = kk; j < 8; ++j) y[j] = y[j] + a * h[j - kk];
    }
}

template <bool kShort>
__device__ __forceinline__ float looped_score(const float *h, Cand v,
                                              const float *tgt) {
    float e = 0.0f, cc = 0.0f;
    for (int n0 = 0; n0 < kSub; n0 += 8) {
        float y[8];
        y_block<kShort>(h, v, n0, y);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            e = e + y[j] * y[j];
            cc = cc + y[j] * tgt[n0 + j];
        }
    }
    return pitch_score(e, cc);
}

"""
CALL = "            const float v = candidate_score(hr, S.s.u, S.tgt, c);"
LOOPED_CALL = """            const Cand cv = candidate(S.s.u, c);
            const float v = (sf ? S.base < 40 : s < 64)
                ? looped_score<true>(S.h[sf], cv, S.tgt)
                : looped_score<false>(S.h[sf], cv, S.tgt);"""
TWO_PATHS_CALL = """            const float v = (sf ? S.base < 40 : s < 64)
                ? candidate_score<true>(hr, S.s.u, S.tgt, c)
                : candidate_score<false>(hr, S.s.u, S.tgt, c);"""
SUBFRAME = "// Subframe sf, from its impulse response"

ACELP = """    // ---- the joint search over the 4 tracks: a thread a pair of tracks
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
"""

ACELP_TRIPLES = """    // ---- the joint search over the 4 tracks: a thread a triple of tracks
    // 0-2 (ascending), track 3's 16 positions inside
    {
        float d3[16], p33[16];
#pragma unroll
        for (int k3 = 0; k3 < 16; ++k3) {
            const int p3 = k3 < 8 ? 5 * k3 + 3 : 5 * (k3 - 8) + 4;
            d3[k3] = S.dabs[p3];
            p33[k3] = S.s.phs[p3][p3];
        }
        float best_v = 0.0f;
        int best_i = -1;
        for (int q = tid; q < 512; q += kThreads) {
            const int p0 = 5 * (q >> 6), p1 = 5 * ((q >> 3) & 7) + 1,
                      p2 = 5 * (q & 7) + 2;
            const float *r0 = S.s.phs[p0], *r1 = S.s.phs[p1],
                        *r2 = S.s.phs[p2];
            const float n3 = (S.dabs[p0] + S.dabs[p1]) + S.dabs[p2];
            const float dd3 = (r0[p0] + r1[p1]) + r2[p2];
            const float c2 = r0[p1] + r0[p2], c12 = r1[p2];
#pragma unroll
            for (int k3 = 0; k3 < 16; ++k3) {
                const int p3 = k3 < 8 ? 5 * k3 + 3 : 5 * (k3 - 8) + 4;
                const float num = n3 + d3[k3];
                const float den_d = dd3 + p33[k3];
                const float den_c = (((c2 + r0[p3]) + c12) + r1[p3]) + r2[p3];
                const float den = den_d + 2.0f * den_c;
                const float score = (num * num) / fmaxf(den, 1e-9f);
                if (best_i < 0 || score > best_v) {
                    best_v = score;
                    best_i = q << 4 | k3;
                }
            }
        }
        k = block_best<kThreads>(best_v, best_i, S);
    }
"""

FIRST_HEAD = "    if (warp == 1) lp_head(S, lane, 0, frames + b * 80);\n"
FRAME_TOP = """        const float *x = S.xs[slot];
        __syncthreads();
        K_STAMP(S, kPhAnalysis);"""
HEAD_AT_TOP = """        const float *x = S.xs[slot];
        __syncthreads();
        if (warp == 1) lp_head(S, lane, slot, frames + (t * nb + b) * 80);
        __syncthreads();
        K_STAMP(S, kPhAnalysis);"""
NEXT_HEAD = """        if (warp == 1 && t + 1 < nt)     // the next frame's head
            lp_head(S, lane, (int)((t + 1) % 3),
                    frames + ((t + 1) * nb + b) * 80);
"""

# signs on read
SIGN_PASS = """    __syncthreads();
    K_STAMP(S, ph + kPhChain);
    for (int e = tid; e < kSub * kSub; e += kThreads) {  // the signs
        const int a = e / kSub, b = e % kSub;
        S.s.phs[a][b] = __int_as_float(__float_as_int(S.s.phs[a][b]) ^
                                       ((S.sneg[a] ^ S.sneg[b]) << 31));
    }
    __syncthreads();
    K_STAMP(S, ph + kPhSigned);"""
SIGN_PASS_OUT = """    __syncthreads();
    K_STAMP(S, ph + kPhChain);"""
ACELP_ON_READ = """    // ---- the joint search over the 4 tracks on the signed matrix
    // phi[k][l] sgn[k] sgn[l]: a product by +-1 is exact, a flip of the
    // sign bit, applied as each entry is read.  A thread takes a pair of
    // positions on tracks 0-1 (kThreads / 64 threads a pair, each a share
    // of track 2), its two rows at track 3's positions in registers;
    // track 2, then track 3's 16 positions, ascending inside
    {
        constexpr int kSplit = kThreads / 64, kK2 = 8 / kSplit;
        float d3[16], p33[16], q0[16], q1[16];
        unsigned f3[16];                 // track 3's sign bits
        const int pair = tid / kSplit, p0 = 5 * (pair >> 3),
                  p1 = 5 * (pair & 7) + 1;
        const float *r0 = S.s.phs[p0], *r1 = S.s.phs[p1];
        const unsigned f0 = S.sneg[p0] << 31, f1 = S.sneg[p1] << 31;
#pragma unroll
        for (int k3 = 0; k3 < 16; ++k3) {
            const int p3 = k3 < 8 ? 5 * k3 + 3 : 5 * (k3 - 8) + 4;
            f3[k3] = S.sneg[p3] << 31;
            d3[k3] = S.dabs[p3];
            p33[k3] = S.s.phs[p3][p3];
            q0[k3] = flip(r0[p3], f0 ^ f3[k3]);
            q1[k3] = flip(r1[p3], f1 ^ f3[k3]);
        }
        const float n1 = S.dabs[p0] + S.dabs[p1];
        const float dd1 = r0[p0] + r1[p1];
        const float c01 = flip(r0[p1], f0 ^ f1);
        float best_v = 0.0f;
        int best_i = -1;
        for (int k2 = tid % kSplit * kK2; k2 < (tid % kSplit + 1) * kK2;
             ++k2) {
            const int p2 = 5 * k2 + 2;
            const float *r2 = S.s.phs[p2];
            const unsigned f2 = S.sneg[p2] << 31;
            const float n3 = n1 + S.dabs[p2];
            const float dd3 = dd1 + r2[p2];
            const float c2 = c01 + flip(r0[p2], f0 ^ f2),
                        c12 = flip(r1[p2], f1 ^ f2);
#pragma unroll
            for (int k3 = 0; k3 < 16; ++k3) {
                const int p3 = k3 < 8 ? 5 * k3 + 3 : 5 * (k3 - 8) + 4;
                const float num = n3 + d3[k3];
                const float den_d = dd3 + p33[k3];
                const float den_c = (((c2 + q0[k3]) + c12) + q1[k3])
                                    + flip(r2[p3], f2 ^ f3[k3]);
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
"""
BEFORE = """// (v, i) before (w, j): the larger value, the lower index on a tie"""
BEFORE_FLIP = """// v with its sign bit xor f (f: 0 or 1 << 31): v times +-1, exactly
__device__ __forceinline__ float flip(float v, unsigned f) {
    return __int_as_float((int)((unsigned)__float_as_int(v) ^ f));
}

// (v, i) before (w, j): the larger value, the lower index on a tie"""

PICK = "        if (b <= (long long)sms * per_sm)"

# ACELP group skip: the track-2 loop's body, then its replacement
GROUP_LOOP = """        float best_v = 0.0f;
        int best_i = -1;
        for (int k2 = tid % kSplit * kK2; k2 < (tid % kSplit + 1) * kK2;
             ++k2) {
            const int p2 = 5 * k2 + 2;
            const float *r2 = S.s.phs[p2];
            const float n3 = n1 + S.dabs[p2];
            const float dd3 = dd1 + r2[p2];
            const float c2 = c01 + r0[p2], c12 = r1[p2];
#pragma unroll
            for (int k3 = 0; k3 < 16; ++k3) {"""
GROUP_SKIP = """        float best_v = 0.0f, thr = -1.0f;
        int best_i = -1;
        for (int k2 = tid % kSplit * kK2; k2 < (tid % kSplit + 1) * kK2;
             ++k2) {
            const int p2 = 5 * k2 + 2;
            const float *r2 = S.s.phs[p2];
            const float n3 = n1 + S.dabs[p2];
            const float dd3 = dd1 + r2[p2];
            const float c2 = c01 + r0[p2], c12 = r1[p2];
            bool need = false;
#pragma unroll
            for (int k3 = 0; k3 < 16; ++k3) {
                const int p3 = k3 < 8 ? 5 * k3 + 3 : 5 * (k3 - 8) + 4;
                const float num = n3 + d3[k3];
                const float den_d = dd3 + p33[k3];
                const float den_c = (((c2 + q0[k3]) + c12) + q1[k3]) + r2[p3];
                const float den = den_d + 2.0f * den_c;
                const float q = __fdividef(num * num,
                                           fminf(fmaxf(den, 1e-9f), 1e30f));
                need |= !(q < thr);
            }
            if (need)
#pragma unroll
            for (int k3 = 0; k3 < 16; ++k3) {"""
GROUP_END = """                    best_i = pair << 7 | k2 << 4 | k3;
                }
            }
        }
        k = block_best<kThreads>(best_v, best_i, S);
    }
"""
GROUP_END_SKIP = """                    best_i = pair << 7 | k2 << 4 | k3;
                }
            }
            float wb = best_i < 0 ? -1.0f : best_v;
#pragma unroll
            for (int o = 16; o; o >>= 1)
                wb = fmaxf(wb, __shfl_xor_sync(kFull, wb, o));
            thr = wb >= 1e-20f ? wb * 0.99999f : -1.0f;
        }
        k = block_best<kThreads>(best_v, best_i, S);
    }
"""

VARIANTS = {
    "shipped": [],
    "grid in blocks of 10": [(CANDIDATE, BLOCKS_OF_10)],
    "looped grid": [(SUBFRAME, LOOPED + SUBFRAME), (CALL, LOOPED_CALL)],
    "two grid paths": [
        (CANDIDATE, "template <bool kShort>\n" + CANDIDATE.replace(
            "w[k < ti ? k : k - ti]", "w[!kShort || k < ti ? k : k - ti]")),
        (CALL, TWO_PATHS_CALL)],
    "ACELP triples": [(ACELP, ACELP_TRIPLES)],
    "no head overlap": [(FIRST_HEAD, ""), (FRAME_TOP, HEAD_AT_TOP),
                        (NEXT_HEAD, "")],
    "signs on read": [(SIGN_PASS, SIGN_PASS_OUT), (ACELP, ACELP_ON_READ),
                      (BEFORE, BEFORE_FLIP)],
    "64 threads at any count": [(PICK, "        if (false)")],
    "ACELP group skip": [(GROUP_LOOP, GROUP_SKIP),
                         (GROUP_END, GROUP_END_SKIP)],
}


def sources(text: str, variants=None) -> dict:
    """{name: the edited source}: each edit's old text must occur exactly
    once in the shipped source."""
    out = {}
    for name, edits in (variants or VARIANTS).items():
        t = text
        for old, new in edits:
            if t.count(old) != 1:
                raise ValueError(f"{name}: an edit does not apply once")
            t = t.replace(old, new)
        out[name] = t + RESIDENT
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", default="1024x600")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--only", default=None,
                    help="the variants to build, comma-separated")
    args = ap.parse_args(argv)
    import tempfile

    import torch

    from amv_tpu_torch.codecs import g729a as G
    from amv_tpu_torch.kernels import _build
    from amv_tpu_torch.tools import time_g729 as tg
    from amv_tpu_torch.tools import time_transcode_kernel as tk
    from amv_tpu_torch.tools import time_trellis as tt
    from amv_tpu_torch.verify import fixtures
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    csrc = tk._csrc(_build)
    with open(os.path.join(csrc, SOURCE)) as f:
        text = f.read()
    names = args.only.split(",") if args.only else list(VARIANTS)
    srcs = sources(text, {n: VARIANTS[n] for n in names})
    out = {"card": tk.smi("name,power.limit"), "variants": {}}
    with tempfile.TemporaryDirectory() as tmp:
        specs = {}
        for i, n in enumerate(names):
            path = os.path.join(tmp, f"k{i}.cu")
            with open(path, "w") as f:
                f.write(srcs[n])
            specs[f"v{i}"] = (path, False)
            if args.phases:
                specs[f"v{i} phases"] = (path, True)
        libs = tg.k_libraries(_build, specs, csrc=csrc)
    dev = torch.device("cuda")
    b, t = tg.k_shape(args.shape)
    pcm = torch.from_numpy(fixtures.speech_streams(b, t * 80, 16)).to(dev)
    fr = pcm.float().reshape(b, t, 80).permute(1, 0, 2).contiguous()
    st0 = G.init_state(b, device=dev)
    h0 = torch.zeros((b, 160), dtype=torch.float32, device=dev)
    got, ms = {}, {n: [] for n in names}
    for i in list(range(len(names))) + list(range(len(names)))[::-1]:
        m, got[i] = tt.event_ms(lambda: tg.encode_with(libs[f"v{i}"], st0,
                                                       h0, fr),
                                args.reps, dev)
        ms[names[i]].append(m)
    for i, n in enumerate(names):
        for k in got[0][0]:
            assert torch.equal(got[i][0][k], got[0][0][k]), (n, k)
        assert torch.equal(got[i][2], got[0][2]), n
        lib = libs[f"v{i}"]
        lib.amv_k_resident.restype = ctypes.c_int
        r = {"ms": ms[n], "resident": [lib.amv_k_resident(th)
                                       for th in (64, 128)]}
        if args.phases:
            ph = tg.k_phases(libs[f"v{i} phases"], st0, h0, fr)
            r["cycles"] = round(ph["total"])
            r["phases"] = {k: round(v) for k, v in ph["cycles"].items()}
        out["variants"][n] = r
    out["shape"] = args.shape
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
