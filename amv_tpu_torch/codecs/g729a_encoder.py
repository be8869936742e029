"""G.729 Annex A encoder on the host (analysis-by-synthesis): the port's
copy of `amv_tpu/codecs/g729a_encoder.py`, the encoder behind the CLI's
`-f act` and `.wav -> .act` routes.

Host numpy, float64, over the port's copies `verify/ref_g729.py` (the
shadow decoder) and `codecs/g729_tables.py`; its bytes equal the JAX
package's for every preset.  The batched encoder on the card is
`codecs/g729a_encoder_batch.py` (kernel K).

Design: hybrid float analysis / exact-integer synthesis.

* LP analysis, LSP conversion and the open-loop pitch run in float
  (windowed autocorrelation + Levinson-Durbin, Chebyshev LSP root search);
* quantizer decisions (LSF two-stage VQ with switched MA prediction,
  closed-loop pitch, ACELP track pulses, GA/GB gain pair) are searched
  against the *decoder's exact fixed-point reconstruction*: the encoder
  keeps a shadow `verify.ref_g729.G729Decoder` state and evaluates every
  candidate through the same integer routines the decoder will run, so
  encoder and decoder memories track bit-exactly;
* the closed-loop pitch searches the full 1/3-sample fractional grid
  (float replica of the decoder's interpolation, self-extending for
  short lags);
* the fixed-codebook search is an exhaustive joint search over all
  8x8x8x16 track-pulse combinations (sign-preselected, pitch-sharpened
  impulse response) maximizing the standard (d.c)^2 / c'Phi c criterion.

Not bit-compatible with the ITU encoder; validated by decode(encode(x))
reconstruction quality.
"""

from __future__ import annotations

import numpy as np

from ..verify import ref_g729 as D
from . import g729_tables as T

SUBFRAME = 40
FRAME = 80
PITCH_MIN, PITCH_MAX = 20, 143

_MAGIC = 0x6996966996696996

# asymmetric LP analysis window (spec 3.2.1): 200 samples of Hamming-like
# rise + 40 samples of cosine fall, over a 240-sample window ending 40
# samples into the next frame (we use a 40-sample lookahead).
_WLP = np.concatenate([
    0.54 - 0.46 * np.cos(2 * np.pi * np.arange(200) / 399.0),
    np.cos(2 * np.pi * np.arange(40) / 159.0),
])
_LAG_WINDOW = np.exp(-0.5 * (2 * np.pi * 60.0 * np.arange(11) / 8000.0) ** 2)


def _levinson(r):
    a = np.zeros(11)
    a[0] = 1.0
    err = r[0]
    for i in range(1, 11):
        acc = r[i] + np.dot(a[1:i], r[i - 1:0:-1])
        k = -acc / err if err > 0 else 0.0
        a[1:i + 1] += k * a[i - 1::-1][:i]
        err *= (1 - k * k)
        if err <= 0:
            err = 1e-6
    return a  # a[0]=1, predictor A(z) = 1 + a1 z^-1 + ...


def _lp_to_lsf(a):
    """LP -> line spectral frequencies (radians, ascending)."""
    # P(z) = A(z) + z^-11 A(z^-1), Q(z) = A(z) - z^-11 A(z^-1)
    p = np.concatenate([a, [0.0]]) + np.concatenate([[0.0], a[::-1]])
    q = np.concatenate([a, [0.0]]) - np.concatenate([[0.0], a[::-1]])
    # deflate trivial roots
    p = np.polynomial.polynomial.polydiv(p[::-1], [1.0, 1.0])[0][::-1]
    q = np.polynomial.polynomial.polydiv(q[::-1], [-1.0, 1.0])[0][::-1]

    def roots_on_circle(c):
        # c is symmetric, degree 10; evaluate via cos-domain Chebyshev scan
        n = (len(c) - 1) // 2
        sym = c[:n][::-1]
        mid = c[n]

        def val(w):
            x = np.cos(w * np.arange(1, n + 1))
            return mid + 2.0 * np.dot(sym, x.T if x.ndim > 1 else x)

        grid = np.linspace(0.0, np.pi, 512)
        vals = np.array([val(w) for w in grid])
        roots = []
        for i in range(len(grid) - 1):
            if vals[i] == 0:
                roots.append(grid[i])
            elif vals[i] * vals[i + 1] < 0:
                lo, hi = grid[i], grid[i + 1]
                flo = vals[i]
                for _ in range(30):
                    mid_w = 0.5 * (lo + hi)
                    fm = val(mid_w)
                    if flo * fm <= 0:
                        hi = mid_w
                    else:
                        lo, flo = mid_w, fm
                roots.append(0.5 * (lo + hi))
        return roots

    rp = roots_on_circle(p)
    rq = roots_on_circle(q)
    lsf = np.sort(np.concatenate([rp, rq]))[:10]
    if len(lsf) < 10:  # degenerate frame: fall back to uniform spacing
        lsf = np.pi * (np.arange(1, 11) / 11.0)
    return lsf


def _quantize_lsf(enc, lsf_rad):
    """Two-stage switched-MA VQ against the decoder's exact reconstruction.

    Returns (L0, L1, L2, L3) and mutates nothing.
    """
    target_q13 = np.round(np.clip(lsf_rad * 8192.0, 40, 25681)).astype(np.int64)  # Q13 radians
    st = enc.shadow
    best = None
    for L0 in (0, 1):
        msum = T.MA_PREDICTOR_SUM[L0].astype(np.int64)
        pred = sum(np.asarray(st.lq_prev[k], dtype=np.int64) *
                   T.MA_PREDICTOR[L0][k] for k in range(4))
        # lq target so that (lq*msum + pred) >> 15 == target
        lq_target = ((target_q13 << 15) - pred) / msum
        # stage 1: full search over 128
        d1 = np.abs(T.CB_L1.astype(np.float64) - lq_target).sum(axis=1)
        for L1 in np.argsort(d1)[:enc.lsf_width]:
            resid = lq_target - T.CB_L1[L1]
            L2 = int(np.argmin(
                ((T.CB_L2_L3[:, :5] - resid[:5]) ** 2).sum(axis=1)))
            L3 = int(np.argmin(
                ((T.CB_L2_L3[:, 5:] - resid[5:]) ** 2).sum(axis=1)))
            # exact reconstruction through the decoder path (on a copy)
            lq = [0] * 10
            for i in range(5):
                lq[i] = int(T.CB_L1[L1][i]) + int(T.CB_L2_L3[L2][i])
                lq[i + 5] = int(T.CB_L1[L1][i + 5]) + int(T.CB_L2_L3[L3][i + 5])
            for J in (10, 5):
                for i in range(1, 10):
                    diff = (lq[i - 1] - lq[i] + J) >> 1
                    if diff > 0:
                        lq[i - 1] -= diff
                        lq[i] += diff
            rec = [(lq[i] * int(msum[i]) + int(pred[i])) >> 15 for i in range(10)]
            err = float(sum((rec[i] - int(target_q13[i])) ** 2 for i in range(10)))
            if best is None or err < best[0]:
                best = (err, int(L0), int(L1), L2, L3)
    return best[1], best[2], best[3], best[4]


def _parity(P1):
    return ((_MAGIC >> (P1 >> 2)) & 1) ^ 1


class G729Encoder:
    """Stateful single-stream encoder: encode_frame(80 samples) -> 10 bytes.

    Quality knobs (defaults = the measured r5 optimum on the HP-chain
    metric, scripts/measure_g729_quality.py):
    * topk: closed-loop pitch candidates given the full FC+gain
      refinement (the r2 "top-2 measured worse" note was an artifact of
      the raw-input metric);
    * requant: after the gain VQ, re-search the fixed codebook against
      the QUANTIZED pitch-gain residual and redo the gain pair, keeping
      the better subframe error;
    * lsf_width: LSF stage-1 candidates surviving to exact rescoring.
    """

    def __init__(self, topk: int = 1, requant: bool = False,
                 lsf_width: int = 8, ol_span: int = 5, olp: str = "raw",
                 frame_select: bool = False):
        self.shadow = D.G729Decoder()   # decoder-mirror state
        self.hist = np.zeros(160)       # past input for LP window
        self._res_hist = np.zeros(PITCH_MAX)
        self.topk = topk
        self.requant = requant
        self.lsf_width = lsf_width
        self.ol_span = ol_span
        self.olp = olp
        self.frame_select = frame_select
        if frame_select:
            self.mirror = D.G729Decoder()   # full decode (postfilter+HP)
            self._refhp = D.G729Decoder()   # HP state of the reference

    # -- helpers operating on the shadow decoder state ----------------------

    @staticmethod
    def _impulse_response(lp_q12):
        """h[0..39] of 1/A(z) (float)."""
        a = np.array(lp_q12, dtype=np.float64) / 4096.0
        h = np.zeros(SUBFRAME)
        h[0] = 1.0
        for n in range(1, SUBFRAME):
            h[n] = -np.dot(a[:min(10, n)], h[n - 1::-1][:10])
        return h

    def _zero_input_response(self, lp_q12, st=None):
        """ZIR of 1/A(z) from the shadow synthesis history."""
        st = st if st is not None else self.shadow
        a = np.array(lp_q12, dtype=np.float64) / 4096.0
        buf = np.concatenate([np.array(st.syn_filter_data,
                                       dtype=np.float64), np.zeros(SUBFRAME)])
        for n in range(SUBFRAME):
            buf[10 + n] = -np.dot(a, buf[10 + n - 1::-1][:10])
        return buf[10:]

    @staticmethod
    def _zsr(h, x):
        """Zero-state response of 1/A to excitation x (truncated conv)."""
        return np.convolve(x, h)[:SUBFRAME]

    def _ac_candidate(self, off, t, frac, st=None):
        """Float replica of the decoder's AC-vector interpolation
        (ref_g729.decode_ac_vector): 1/3-resolution delay t - frac/3 over
        the current excitation history, self-extending for t < 40.
        Used only to *score* closed-loop candidates; the chosen candidate
        is materialized exactly via the shadow decoder."""
        st = st if st is not None else self.shadow
        base = st.exc_off + off
        span = PITCH_MAX + D.INTERPOL_LEN
        o = span
        buf = np.concatenate([
            np.array(st.exc_base[base - span:base], dtype=np.float64),
            np.zeros(SUBFRAME)])
        f = -frac
        ti = t
        if f < 0:
            f += 3
            ti += 1
        taps_lo = np.array([float(D._INTERP_FLAT[3 * i + f])
                            for i in range(10)])
        taps_hi = np.array([float(D._INTERP_FLAT[3 * i + 3 - f])
                            for i in range(10)])
        for n in range(SUBFRAME):
            p = o + n - ti
            v = np.dot(buf[p - 9:p + 1][::-1], taps_lo) + \
                np.dot(buf[p + 1:p + 11], taps_hi)
            buf[o + n] = v / 16384.0
        return buf[o:]

    def encode_frame(self, samples: np.ndarray,
                     lookahead: np.ndarray | None = None) -> bytes:
        samples = np.asarray(samples, dtype=np.float64)
        assert samples.shape == (FRAME,)
        raw = samples                    # un-scaled input (frame_select ref)
        # pre-processing (spec 3.1): scale by 1/2 — the decoder's output
        # high-pass stage upscales by 2 (spec 4.2.5 / g729_high_pass_filter)
        samples = samples * 0.5

        # --- LP analysis over windowed history+frame+lookahead -------------
        # spec 3.2.1: the asymmetric window's 40-sample cosine fall covers
        # 40 samples of the NEXT frame; without the lookahead the fall
        # lands on the current frame's tail and the LP fit lags the
        # signal by ~half a subframe (r5 A/B: +0.6 dB HP-chain segSNR,
        # scripts/measure_g729_quality.py)
        if lookahead is None:
            # per-frame API callers without a buffered next frame keep
            # the r4 window (ends on real signal) — zero-filling the
            # cosine fall would regress them below the old baseline
            buf = np.concatenate([self.hist, samples])[-240:]
        else:
            la = np.asarray(lookahead, dtype=np.float64)[:40] * 0.5
            if len(la) < 40:
                la = np.concatenate([la, np.zeros(40 - len(la))])
            buf = np.concatenate([self.hist, samples, la])[-240:]
        w = buf * _WLP
        r = np.array([np.dot(w[:240 - k], w[k:]) for k in range(11)])
        r[0] = max(r[0] * 1.0001 + 10.0, 1e-3)
        r *= _LAG_WINDOW
        a = _levinson(r)
        lsf = _lp_to_lsf(a)

        L0, L1, L2, L3 = _quantize_lsf(self, lsf)

        st = self.shadow
        # exact decoded LSF/LSP/LP via the shadow decoder
        lsf_q = st.lsf_decode(L0, L1, L2, L3)
        lsp = st.lsf2lsp(lsf_q)
        lp = st.lp_decode(lsp)

        # --- open-loop pitch on the LP residual ------------------------------
        a_q = np.array(lp[10:20], dtype=np.float64) / 4096.0
        ext = np.concatenate([self.hist[-10:], samples])
        resid = ext[10:] + np.array(
            [np.dot(a_q, ext[10 + n - 1::-1][:10]) for n in range(FRAME)])
        hist_res = np.concatenate([self._res_hist, resid])
        # raw correlation argmax; a spec-3.4-style normalized variant
        # was measured slightly WORSE downstream (6.68 vs 6.83 dB
        # segSNR on the fixtures speech) because the closed-loop search
        # re-examines +-5 around t_op anyway
        corr = np.array([
            np.dot(resid, hist_res[len(hist_res) - FRAME - t:
                                   len(hist_res) - t])
            for t in range(PITCH_MIN, PITCH_MAX + 1)])
        if self.olp == "spec":
            # spec 3.4 shape: normalized correlation maxima in three
            # delay ranges, lower ranges favored to dodge pitch
            # multiples (weights ~0.85 per octave drop)
            en = np.array([
                float(np.dot(hist_res[len(hist_res) - FRAME - t:
                                      len(hist_res) - t],
                             hist_res[len(hist_res) - FRAME - t:
                                      len(hist_res) - t]))
                for t in range(PITCH_MIN, PITCH_MAX + 1)])
            nc = corr / np.sqrt(np.maximum(en, 1e-9))
            ranges = [(20, 39), (40, 79), (80, 143)]
            best_t, best_v = None, None
            for lo, hi in reversed(ranges):          # high range first
                seg = nc[lo - PITCH_MIN:hi - PITCH_MIN + 1]
                t_r = int(np.argmax(seg)) + lo
                v_r = float(seg[t_r - lo])
                if best_t is None or v_r > 0.85 * best_v:
                    best_t, best_v = t_r, max(v_r, best_v or v_r)
            t_op = best_t
        else:
            t_op = int(np.argmax(corr)) + PITCH_MIN
        self._res_hist = hist_res[-PITCH_MAX:]

        parm = {"ma_predictor": L0, "quantizer_1st": L1,
                "quantizer_2nd_lo": L2, "quantizer_2nd_hi": L3,
                "parity": 0, "ac_index": [0, 0], "fc_indexes": [0, 0],
                "pulses_signs": [0, 0], "ga_cb_index": [0, 0],
                "gb_cb_index": [0, 0]}

        if not self.frame_select:
            prev_int = None
            for i in range(2):
                lp_i = lp[i * 10:(i + 1) * 10]
                speech_sub = samples[i * SUBFRAME:(i + 1) * SUBFRAME]
                cands = self._search_subframe(st, i, lp_i, speech_sub,
                                              t_op, prev_int)
                t_int = self._commit_subframe(st, i, lp_i, parm, cands[0])
                if i == 0:
                    prev_int = t_int
            st.exc_base[:PITCH_MAX + D.INTERPOL_LEN] = \
                st.exc_base[2 * SUBFRAME:
                            2 * SUBFRAME + PITCH_MAX + D.INTERPOL_LEN]
            self.hist = np.concatenate([self.hist, samples])[-160:]
            return pack_parameters(parm)

        # frame-select mode (r5): branch on the top `topk` pitch
        # candidates per subframe, then pick the packed frame whose FULL
        # decode — including the adaptive postfilter and output
        # high-pass, the stages the subframe target error cannot see
        # (the long-term postfilter comb-filters at the TRANSMITTED
        # pitch delay, g729a_native.c:1124) — lands closest to the
        # HP-chain reference of this frame's input.  The mirror decoder
        # advances on the chosen frame, so selection is exact for the
        # deployed decode chain.
        import copy as _copy
        ref = self._ref_frame(raw)
        branches = [(st, parm, None)]
        for i in range(2):
            lp_i = lp[i * 10:(i + 1) * 10]
            speech_sub = samples[i * SUBFRAME:(i + 1) * SUBFRAME]
            nxt = []
            for stb, parmb, prevb in branches:
                cands = self._search_subframe(stb, i, lp_i, speech_sub,
                                              t_op, prevb)
                for ch in cands[:self.topk]:
                    st2 = _copy.deepcopy(stb)
                    parm2 = {k: (list(v) if isinstance(v, list) else v)
                             for k, v in parmb.items()}
                    t_int = self._commit_subframe(st2, i, lp_i, parm2, ch)
                    nxt.append((st2, parm2,
                                t_int if i == 0 else prevb))
            branches = nxt
        best = None
        for stb, parmb, _ in branches:
            by = pack_parameters(parmb)
            dm = _copy.deepcopy(self.mirror)
            outf = np.array(dm.decode_frame(by), dtype=np.float64)
            err = float(np.sum((outf - ref) ** 2))
            if best is None or err < best[0]:
                best = (err, by, stb, dm)
        _, by, stb, dm = best
        self.shadow = stb
        self.mirror = dm
        stb.exc_base[:PITCH_MAX + D.INTERPOL_LEN] = \
            stb.exc_base[2 * SUBFRAME:
                         2 * SUBFRAME + PITCH_MAX + D.INTERPOL_LEN]
        self.hist = np.concatenate([self.hist, samples])[-160:]
        return by

    def _ref_frame(self, raw):
        """This frame's HP-chain reference: raw input >> 1 through the
        decoder's 100 Hz output high-pass (persistent filter state)."""
        ch = [int(v) >> 1 for v in raw]
        self._refhp.high_pass_filter(ch)
        return np.array(ch, dtype=np.float64)

    def _search_subframe(self, st, i, lp_i, speech_sub, t_op, prev_int):
        """Closed-loop pitch + FC + gain search on shadow state `st`
        (restored afterwards).  Returns candidate tuples
        (err, fc_idx, signs, ga, gb, t_int, t_frac) sorted by err,
        one per evaluated pitch candidate (up to self.topk)."""
        h = self._impulse_response(lp_i)
        target = speech_sub - self._zero_input_response(lp_i, st)

        # --- closed-loop pitch at 1/3 resolution ---------------------------
        # pd3x = 3t + frac + 1 (decoder: int = pd3x//3,
        # frac = pd3x%3 - 1); fractions exist for t <= 84 in subframe 1
        # and everywhere in subframe 2's 5-bit relative window.
        if i == 0:
            sp = self.ol_span
            ints = sorted(set(
                list(range(max(PITCH_MIN, t_op - sp),
                           min(PITCH_MAX, t_op + sp) + 1)) +
                [t for t in (t_op // 2, t_op * 2)
                 if PITCH_MIN <= t <= PITCH_MAX]))
            cands = [(t, f) for t in ints
                     for f in ((-1, 0, 1) if t <= 84 else (0,))
                     if not (t == PITCH_MIN and f == -1)]
        else:
            base = min(max(prev_int - 5, PITCH_MIN), PITCH_MAX - 9)
            cands = [(base + k, f) for k in range(10)
                     for f in (-1, 0, 1)
                     if PITCH_MIN <= base + k <= PITCH_MAX]
        scored = []
        for tc, fc_ in cands:
            y = self._zsr(h, self._ac_candidate(i * SUBFRAME, tc, fc_, st))
            e = float(np.dot(y, y))
            c = max(float(np.dot(y, target)), 0.0)
            score = c * c / e if e > 0 else 0.0
            scored.append((score, tc, fc_))
        scored.sort(key=lambda s: -s[0])
        pitch_cands = [(tc, fc_) for _, tc, fc_ in scored[:self.topk]]

        P0 = np.arange(0, SUBFRAME, 5)
        P1v = P0 + 1
        P2v = P0 + 2
        P3v = np.concatenate([P0 + 3, P0 + 4])     # track 3 + jitter bit
        pred_snapshot = list(st.pred_energ_q)
        seg_lo = st.exc_off + i * SUBFRAME
        seg_hi = seg_lo + SUBFRAME
        exc_snapshot = list(st.exc_base[seg_lo:seg_hi])

        def eval_pitch(t_int, t_frac):
            """Full FC + gain search for one pitch candidate.
            Restores exc/pred state afterwards."""
            # exact AC vector via shadow decoder (mutates exc seg)
            st.decode_ac_vector(t_int, t_frac, i * SUBFRAME)
            acv = np.array(st.exc_base[seg_lo:seg_hi], dtype=np.float64)
            y_ac = self._zsr(h, acv)
            e_ac = float(np.dot(y_ac, y_ac))
            gp_f = float(np.dot(y_ac, target)) / e_ac if e_ac > 0 else 0.0
            gp_f = min(max(gp_f, 0.0), 1.2)  # gain codebook headroom

            h2 = h.copy()
            gp_sh = st.pitch_sharp / 16384.0
            if t_int < SUBFRAME:
                for n in range(t_int, SUBFRAME):
                    h2[n] += gp_sh * h2[n - t_int]
            hpad = np.concatenate([h2, np.zeros(SUBFRAME)])
            phi = np.array([[np.dot(hpad[:SUBFRAME - max(a, b)],
                                    hpad[abs(a - b):SUBFRAME - min(a, b)])
                             for b in range(SUBFRAME)]
                            for a in range(SUBFRAME)])

            def search_fc(r):
                d = np.array([np.dot(r[n:], h2[:SUBFRAME - n])
                              for n in range(SUBFRAME)])
                sgn = np.where(d >= 0, 1.0, -1.0)
                dabs = np.abs(d)
                phi_s = phi * sgn[:, None] * sgn[None, :]
                num = (dabs[P0][:, None, None, None]
                       + dabs[P1v][None, :, None, None]
                       + dabs[P2v][None, None, :, None]
                       + dabs[P3v][None, None, None, :])
                den = (phi_s[P0, P0][:, None, None, None]
                       + phi_s[P1v, P1v][None, :, None, None]
                       + phi_s[P2v, P2v][None, None, :, None]
                       + phi_s[P3v, P3v][None, None, None, :]
                       + 2.0 * (phi_s[P0[:, None], P1v[None, :]][:, :, None, None]
                                + phi_s[P0[:, None], P2v[None, :]][:, None, :, None]
                                + phi_s[P0[:, None], P3v[None, :]][:, None, None, :]
                                + phi_s[P1v[:, None], P2v[None, :]][None, :, :, None]
                                + phi_s[P1v[:, None], P3v[None, :]][None, :, None, :]
                                + phi_s[P2v[:, None], P3v[None, :]][None, None, :, :]))
                score = num * num / np.maximum(den, 1e-9)
                k0, k1, k2, k3 = np.unravel_index(int(np.argmax(score)),
                                                  score.shape)
                chosen = [(int(P0[k0]), 0), (int(P1v[k1]), 1),
                          (int(P2v[k2]), 2), (int(P3v[k3]), 3)]
                fci = 0
                sg = 0
                for pos, tr in chosen:
                    s_bit = 1 if sgn[pos] > 0 else 0
                    if tr < 3:
                        fci |= (pos // 5) << (3 * tr)
                    else:
                        jbit = 1 if pos % 5 == 4 else 0
                        fci |= ((pos // 5) << 10) | (jbit << 9)
                    sg |= s_bit << tr
                return fci, sg

            def fc_and_gains(gp_target):
                fc_idx, signs = search_fc(target - gp_target * y_ac)
                fc, _ = st.decode_fc_vector(fc_idx, signs)
                st.fix_fc_vector(t_int, fc)
                fcv = np.array(fc, dtype=np.float64)
                y_fc = self._zsr(h, fcv)
                best_g = None
                for ga in range(8):
                    for gb in range(16):
                        st.pred_energ_q = list(pred_snapshot)
                        gp = int(T.CB_GA[ga][0]) + int(T.CB_GB[gb][0])
                        gc = st.get_gain_code(ga, gb, fc)
                        rec = (y_ac * (gp / 16384.0) +
                               y_fc * (gc / 16384.0))
                        err = float(np.sum((target - rec) ** 2))
                        if best_g is None or err < best_g[0]:
                            best_g = (err, ga, gb)
                err, ga, gb = best_g
                return err, fc_idx, signs, ga, gb

            best = fc_and_gains(gp_f)
            if self.requant:
                # re-search against the QUANTIZED pitch-gain residual
                gp_q = (int(T.CB_GA[best[3]][0]) +
                        int(T.CB_GB[best[4]][0])) / 16384.0
                if abs(gp_q - gp_f) > 1e-9:
                    cand = fc_and_gains(gp_q)
                    if cand[0] < best[0]:
                        best = cand
            st.pred_energ_q = list(pred_snapshot)
            st.exc_base[seg_lo:seg_hi] = exc_snapshot  # undo AC write
            return best

        results = []
        for tc, fc_ in pitch_cands:
            r = eval_pitch(tc, fc_)
            results.append(r + (tc, fc_))
        results.sort(key=lambda r: r[0])
        return results

    def _commit_subframe(self, st, i, lp_i, parm, choice):
        """Materialize one candidate exactly on `st`, writing the wire
        parameters; returns the integer pitch delay."""
        _, fc_idx, signs, ga, gb, t_int, t_frac = choice
        if i == 0:
            # P1 < 197: pd3x = P1 + 59 -> P1 = 3t + frac - 58;
            # P1 >= 197: pd3x = 3*P1 - 335 (integer-only delays > 84)
            if t_int <= 84:
                P1 = 3 * t_int + t_frac - 58
            else:
                P1 = t_int + 112
            parm["ac_index"][0] = P1
            parm["parity"] = _parity(P1)
        else:
            # pd3x = P2 + 3*base - 1 -> P2 = 3*(t-base) + frac + 2
            base = min(max(st.pitch_delay_int_prev - 5, PITCH_MIN),
                       PITCH_MAX - 9)
            parm["ac_index"][1] = 3 * (t_int - base) + t_frac + 2

        st.decode_ac_vector(t_int, t_frac, i * SUBFRAME)
        fc, _ = st.decode_fc_vector(fc_idx, signs)
        st.fix_fc_vector(t_int, fc)
        parm["fc_indexes"][i] = fc_idx
        parm["pulses_signs"][i] = signs
        parm["ga_cb_index"][i] = ga
        parm["gb_cb_index"][i] = gb

        # --- exact state update (what the decoder will do) -----------------
        st.gain_pitch = int(T.CB_GA[ga][0]) + int(T.CB_GB[gb][0])
        st.gain_code = st.get_gain_code(ga, gb, fc)
        st.pitch_sharp = min(max(st.gain_pitch, D.SHARP_MIN), D.SHARP_MAX)
        st.mem_update(fc, st.gain_pitch, st.gain_code, i * SUBFRAME)
        exc_sub = st.exc_base[st.exc_off + i * SUBFRAME:
                              st.exc_off + (i + 1) * SUBFRAME]
        out, ovf = st.lp_synthesis_filter(lp_i, exc_sub,
                                          st.syn_filter_data, 1)
        if ovf:
            st.exc_base = [x >> 2 for x in st.exc_base]
            exc_sub = st.exc_base[st.exc_off + i * SUBFRAME:
                                  st.exc_off + (i + 1) * SUBFRAME]
            st.lp_synthesis_filter(lp_i, exc_sub, st.syn_filter_data, 0)
        st.pitch_delay_int_prev = t_int
        return t_int


def pack_parameters(parm) -> bytes:
    bits = []

    def put(v, n):
        bits.extend((int(v) >> (n - 1 - k)) & 1 for k in range(n))

    put(parm["ma_predictor"], 1)
    put(parm["quantizer_1st"], 7)
    put(parm["quantizer_2nd_lo"], 5)
    put(parm["quantizer_2nd_hi"], 5)
    put(parm["ac_index"][0], 8)
    put(parm["parity"], 1)
    put(parm["fc_indexes"][0], 13)
    put(parm["pulses_signs"][0], 4)
    put(parm["ga_cb_index"][0], 3)
    put(parm["gb_cb_index"][0], 4)
    put(parm["ac_index"][1], 5)
    put(parm["fc_indexes"][1], 13)
    put(parm["pulses_signs"][1], 4)
    put(parm["ga_cb_index"][1], 3)
    put(parm["gb_cb_index"][1], 4)
    out = bytearray(10)
    for i, b in enumerate(bits):
        out[i >> 3] |= b << (7 - (i & 7))
    return bytes(out)


_PACK_FIELDS = [(0, 1), (1, 7), (2, 5), (3, 5), (5, 8), (4, 1), (7, 13),
                (9, 4), (11, 3), (13, 4), (6, 5), (8, 13), (10, 4),
                (12, 3), (14, 4)]  # (parm column, bit width) in wire order


def pack_parameters_batch(pn: np.ndarray) -> np.ndarray:
    """Vectorized pack_parameters: pn int [..., >=15] (column order of
    g729a_encoder_batch.encode_frame_batch) -> uint8 [..., 10]."""
    bits = []
    for col, n in _PACK_FIELDS:
        v = pn[..., col].astype(np.int64)
        for k in range(n):
            bits.append(((v >> (n - 1 - k)) & 1).astype(np.uint8))
    return np.packbits(np.stack(bits, axis=-1), axis=-1)


QUALITY_PRESETS = {
    # measured on the HP-chain metric, scripts/measure_g729_quality.py
    # (2026-08-20, 3-fixture mean / worst):
    #   fast  12.76 / 11.80 dB   (~0.04 s/frame)
    #   high  13.94 / 12.72 dB   (~0.23 s/frame)
    #   best  14.17 / 12.77 dB   (~0.35 s/frame)
    "fast": {},
    "high": {"topk": 4, "requant": True, "frame_select": True},
    "best": {"topk": 5, "requant": True, "frame_select": True},
}


def encode_stream(pcm: np.ndarray, quality: str = "high",
                  **kw) -> list[bytes]:
    """int16 PCM (8 kHz mono) -> list of packed 10-byte G.729A frames.

    Feeds each frame the spec's 40-sample lookahead (zeros at stream
    end) — the encoder buffers input, it does not delay output.
    quality presets select the search effort (see QUALITY_PRESETS);
    explicit kwargs override the preset."""
    pcm = np.asarray(pcm, dtype=np.float64)
    n_frames = len(pcm) // FRAME
    enc = G729Encoder(**{**QUALITY_PRESETS[quality], **kw})
    return [enc.encode_frame(pcm[f * FRAME:(f + 1) * FRAME],
                             pcm[(f + 1) * FRAME:(f + 1) * FRAME + 40])
            for f in range(n_frames)]
