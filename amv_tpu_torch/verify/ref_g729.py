"""Scalar reference G.729 Annex A decoder (fixed-point, bit-exact target).

A from-scratch Python reimplementation of the reference's native
fixed-point ACELP decoder (G.729/g729a_native.c:804-1927; structure per
SURVEY.md §2.3/§3.4): 80-bit parameter unpack, two-stage LSF VQ with
switched MA prediction, LSF->LSP->LP conversion, per-subframe adaptive
codebook vector with 1/3-fractional interpolation, 4-pulse fixed codebook,
gain VQ with MA energy prediction, excitation memory update, LP synthesis
with overflow rescale-and-retry, the Annex-A postfilter (long-term, tilt
compensation, AGC) and the 100 Hz output high-pass, plus the full frame
erasure concealment.

All arithmetic reproduces the C int32/int16 fixed-point semantics exactly
(including the interpolation-filter flat-indexing quirk where
filter[i][3-frac] reads into row i+1 when frac == 0).
"""

from __future__ import annotations

import numpy as np

from ..codecs import g729_tables as T

SUBFRAME = 40
PITCH_MIN, PITCH_MAX = 20, 143
INTERPOL_LEN = 11
SHARP_MIN, SHARP_MAX = 3277, 13017
GAMMA_N, GAMMA_D, GAMMA_T, GAMMA_P = 18022, 22938, 26214, 16384
LSFQ_MIN, LSFQ_MAX, LSFQ_DIFF_MIN = 40, 25681, 321

_INTERP_FLAT = T.INTERP_FILTER.reshape(-1)  # flat for the [i][3] quirk

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


def _i16(x):
    return ((int(x) + 0x8000) & 0xFFFF) - 0x8000


def _w32(x):
    """C int32 accumulation wrap (add/sub chains wrap associatively)."""
    return ((int(x) + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def _clip(x, lo, hi):
    return lo if x < lo else (hi if x > hi else x)


def av_log2(v: int) -> int:
    assert v > 0
    return v.bit_length() - 1


def mul_24_15(a: int, b: int) -> int:
    return (a * b) >> 15


def g729_round(v: int) -> int:
    if v > I32_MAX - 0x8000:
        return 32767
    return (v + 0x8000) >> 16


def l_pow2(power: int) -> int:
    """2^(14+power/2^15) (g729a_native.c l_pow2)."""
    frac_x0 = (power & 0x7C00) >> 10
    frac_dx = (power & 0x03FF) << 5
    result = int(T.TAB_POW2[frac_x0]) << 15
    result += frac_dx * (int(T.TAB_POW2[frac_x0 + 1]) - int(T.TAB_POW2[frac_x0]))
    return (result + 16384) >> 15


def l_log2(value: int) -> int:
    """log2(value) in Q15."""
    assert value > 0
    power_int = av_log2(value)
    result = (value << (31 - power_int)) & 0xFFFFFFFF
    frac_x0 = (result & 0x7C000000) >> 26
    frac_dx = (result & 0x03FFF800) >> 11
    r = int(T.TAB_LOG2[frac_x0]) << 15
    r += frac_dx * (int(T.TAB_LOG2[frac_x0 + 1]) - int(T.TAB_LOG2[frac_x0]))
    return (power_int << 15) + (r >> 15)


def l_inv_sqrt(arg: int) -> int:
    """1/sqrt(arg) in Q29."""
    assert arg > 0
    power_int = (av_log2(arg) >> 1) + 1
    result = (arg << (32 - (power_int << 1))) & 0xFFFFFFFF
    frac_x0 = (result >> 26) - 16
    frac_dx = (result >> 11) & 0x7FE0
    r = int(T.TAB_INV_SQRT[frac_x0]) << 15
    r += frac_dx * (int(T.TAB_INV_SQRT[frac_x0 + 1]) - int(T.TAB_INV_SQRT[frac_x0]))
    return r >> power_int


def l_div(num: int, denom: int, base: int) -> int:
    if not num:
        return 0
    sig = (num < 0) != (denom < 0)
    num, denom = abs(num), abs(denom)
    diff = 26 - av_log2(num)
    # x86 build behavior: shift counts are masked to 5 bits; diff<0 only
    # occurs for pathological gain magnitudes (see g729a_native.c l_div
    # assert, compiled out under NDEBUG)
    num = _w32(num << (min(base, diff) & 31))
    denom >>= (max(base, diff) - diff) & 31
    assert denom
    q = num // denom
    return -q if sig else q


def g729_random(value: int) -> int:
    return (31821 * value + 13849) & 0xFFFF


def parity_check(P1: int, P0: int) -> int:
    return ((0x6996966996696996 >> (P1 >> 2)) ^ P0) & 1


class BitUnpack:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def get(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3] if self.pos >> 3 < len(self.data) else 0
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v


def bytes2parm(buf: bytes):
    """80-bit frame unpack (g729a_native.c:1833-1869). Returns (parm, erased)."""
    if not any(buf[:10]):
        return None, True
    gb = BitUnpack(buf)
    p = {}
    p["ma_predictor"] = gb.get(1)
    p["quantizer_1st"] = gb.get(7)
    p["quantizer_2nd_lo"] = gb.get(5)
    p["quantizer_2nd_hi"] = gb.get(5)
    p["ac_index"] = [gb.get(8), 0]
    p["parity"] = gb.get(1)
    p["fc_indexes"] = [gb.get(13), 0]
    p["pulses_signs"] = [gb.get(4), 0]
    p["ga_cb_index"] = [gb.get(3), 0]
    p["gb_cb_index"] = [gb.get(4), 0]
    p["ac_index"][1] = gb.get(5)
    p["fc_indexes"][1] = gb.get(13)
    p["pulses_signs"][1] = gb.get(4)
    p["ga_cb_index"][1] = gb.get(3)
    p["gb_cb_index"][1] = gb.get(4)
    return p, False


class G729Decoder:
    """Stateful single-stream decoder. decode_frame(10 bytes) -> 80 samples."""

    def __init__(self):
        # +INTERPOL_LEN tail: when a frame erasure arrives before any good
        # frame, pitch_delay_int_prev==0 makes the interpolation read past
        # the excitation buffer; the reference then reads adjacent struct
        # memory (undefined behavior, g729a_native.c:828-829).  We read
        # zeros instead — the only intentional divergence.
        self.exc_base = [0] * (2 * 44 + PITCH_MAX + 2 * INTERPOL_LEN)
        self.exc_off = PITCH_MAX + INTERPOL_LEN
        self.pitch_delay_int_prev = 0
        self.lq_prev = [[int(T.LQ_INIT[i]) for i in range(10)] for _ in range(4)]
        self.lsp_prev = [int(x) for x in T.LSP_INIT]
        self.lsf_prev = [0] * 10
        self.pred_energ_q = [-14336] * 4
        self.gain_pitch = 0
        self.gain_code = 0
        self.pitch_sharp = SHARP_MIN
        self.residual = [0] * (44 + PITCH_MAX)
        self.syn_filter_data = [0] * 10
        self.res_filter_data = [0] * 10
        self.pos_filter_data = [0] * 10
        self.ht_prev_data = 0
        self.gain_coeff = 4096
        self.rand_value = 21845
        self.prev_mode = 0
        self.hpf_f = [0, 0, 0]
        self.hpf_z = [0, 0, 0]
        self.data_error = 0
        self.bad_pitch = 0

    # --- LSF / LSP / LP ----------------------------------------------------

    def _lq_rotate(self, lq):
        for i in range(10):
            for k in range(3, 0, -1):
                self.lq_prev[k][i] = self.lq_prev[k - 1][i]
            self.lq_prev[0][i] = lq[i]

    def lsf_restore_from_previous(self):
        lsfq = list(self.lsf_prev)
        lq = [0] * 10
        for i in range(10):
            v = lsfq[i] << 15
            for k in range(4):
                v -= self.lq_prev[k][i] * int(T.MA_PREDICTOR[self.prev_mode][k][i])
            lq[i] = ((v >> 15) * int(T.MA_PREDICTOR_SUM_INV[self.prev_mode][i])) >> 12
        self._lq_rotate(lq)
        return lsfq

    def lsf_decode(self, L0, L1, L2, L3):
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
        lsfq = [0] * 10
        for i in range(10):
            s = lq[i] * int(T.MA_PREDICTOR_SUM[L0][i])
            for k in range(4):
                s += self.lq_prev[k][i] * int(T.MA_PREDICTOR[L0][k][i])
            lsfq[i] = _i16(s >> 15)
            self.lsf_prev[i] = lsfq[i]
        self._lq_rotate(lq)
        self.prev_mode = L0
        for j in range(9, 0, -1):
            for i in range(j):
                if lsfq[i] > lsfq[i + 1]:
                    lsfq[i], lsfq[i + 1] = lsfq[i + 1], lsfq[i]
        lsfq[0] = max(lsfq[0], LSFQ_MIN)
        for i in range(9):
            lsfq[i + 1] = max(lsfq[i + 1], lsfq[i] + LSFQ_DIFF_MIN)
        lsfq[9] = min(lsfq[9], LSFQ_MAX)
        # lsf_prev keeps the PRE-sort values (assigned inside the sum loop)
        return lsfq

    @staticmethod
    def lsf2lsp(lsf):
        lsp = [0] * 10
        for i in range(10):
            freq = _i16((lsf[i] * 20861) >> 15)
            offset = freq & 0xFF
            ind = freq >> 8
            lsp[i] = _i16(int(T.BASE_COS[ind]) +
                          ((int(T.SLOPE_COS[ind]) * offset) >> 12))
        return lsp

    @staticmethod
    def _lsp_poly(lsp_sub):
        # C indexes lsp[2*i-2] off the passed (stride-2) pointer, i.e. the
        # (i-1)-th even/odd LSP
        f = [0] * 6
        f[0] = 1 << 24
        f[1] = -lsp_sub[0] << 10
        for i in range(2, 6):
            f[i] = f[i - 2]
            for j in range(i, 1, -1):
                f[j] -= (mul_24_15(f[j - 1] >> 1, lsp_sub[i - 1]) << 2) - f[j - 2]
            f[1] -= lsp_sub[i - 1] << 10
        return f

    @classmethod
    def lsp2lp(cls, lsp):
        f1 = cls._lsp_poly(lsp[0::2])
        f2 = cls._lsp_poly(lsp[1::2])
        lp = [0] * 10
        for i in range(5):
            ff1 = f1[i + 1] + f1[i] + (1 << 12)
            ff2 = f2[i + 1] - f2[i]
            lp[i] = _i16((ff1 + ff2) >> 13)
            lp[9 - i] = _i16((ff1 - ff2) >> 13)
        return lp

    def lp_decode(self, lsp_2nd):
        lsp_1st = [(lsp_2nd[i] >> 1) + (self.lsp_prev[i] >> 1) for i in range(10)]
        lp = self.lsp2lp(lsp_1st) + self.lsp2lp(lsp_2nd)
        self.lsp_prev = list(lsp_2nd)
        return lp

    # --- codebooks ----------------------------------------------------------

    def decode_ac_vector(self, pitch_delay_int, pitch_delay_frac, off):
        """In-place over exc_base starting at exc_off+off (4.1.3 / 3.7.1)."""
        frac = -pitch_delay_frac
        if frac < 0:
            frac += 3
            pitch_delay_int += 1
        base = self.exc_off + off
        exc = self.exc_base
        for n in range(SUBFRAME):
            v = 0
            for i in range(10):
                tmp = exc[base + n - pitch_delay_int - i] * int(_INTERP_FLAT[3 * i + frac])
                v = _clip(v + tmp, I32_MIN >> 1, I32_MAX >> 1)
                tmp = exc[base + n - pitch_delay_int + i + 1] * int(_INTERP_FLAT[3 * i + 3 - frac])
                v = _clip(v + tmp, I32_MIN >> 1, I32_MAX >> 1)
            exc[base + n] = g729_round(v << 1)

    @staticmethod
    def decode_fc_vector(fc_index, pulses_signs):
        fc = [0] * SUBFRAME
        err = 0
        for i in range(3):
            index = (fc_index & 7) * 5 + i
            if index >= SUBFRAME:
                return fc, 1
            fc[index] = 8191 if (pulses_signs & 1) else -8192
            fc_index >>= 3
            pulses_signs >>= 1
        index = ((fc_index >> 1) & 7) * 5 + 3 + (fc_index & 1)
        if index >= SUBFRAME:
            return fc, 1
        fc[index] = 8191 if (pulses_signs & 1) else -8192
        return fc, err

    def fix_fc_vector(self, pitch_delay, fc):
        gp = self.pitch_sharp
        for i in range(pitch_delay, SUBFRAME):
            fc[i] = _i16(fc[i] + ((fc[i - pitch_delay] * gp) >> 14))

    def update_gain_erasure(self):
        p = self.pred_energ_q
        avg = p[3]
        for i in range(3, 0, -1):
            avg += p[i - 1]
            p[i] = p[i - 1]
        p[0] = max((avg >> 2) - 4096, -14336)

    def get_gain_code(self, ga, gb, fc):
        energy = _w32(sum(x * x for x in fc))
        energy = mul_24_15(l_log2(energy), -24660)
        energy += mul_24_15(l_log2(SUBFRAME), 24660)
        energy += 0xD8888
        energy -= 2  # reference's bit-exactness compensation
        energy <<= 10
        for i in range(4):
            energy += self.pred_energ_q[i] * int(T.MA_PREDICTION_COEFF[i])
        energy = _w32(energy)
        energy = (5439 * (energy >> 15)) >> 8
        exp = energy >> 15
        energy = l_pow2(energy & 0x7FFF) & 0x7FFF
        for i in range(3, 0, -1):
            self.pred_energ_q[i] = self.pred_energ_q[i - 1]
        cb1_sum = int(T.CB_GA[ga][1]) + int(T.CB_GB[gb][1])
        self.pred_energ_q[0] = _i16(
            (24660 * ((l_log2(cb1_sum) >> 2) - (13 << 13))) >> 15)
        energy *= cb1_sum >> 1
        if 25 - exp > 0:
            energy >>= 25 - exp
        else:
            energy = (energy << (exp - 25)) & 0xFFFFFFFFFFFF
        return _i16(energy)

    def mem_update(self, fc, gp, gc, off):
        base = self.exc_off + off
        for i in range(SUBFRAME):
            s = self.exc_base[base + i] * gp + fc[i] * gc
            s = _clip(s, -32768 << 14, 32767 << 14)
            self.exc_base[base + i] = g729_round(s << 2)

    # --- filters -------------------------------------------------------------

    @staticmethod
    def lp_synthesis_filter(lp, inp, filter_data, exit_on_overflow):
        """Returns (out, overflow); updates filter_data only on success."""
        tmp = list(filter_data) + [0] * SUBFRAME
        for n in range(SUBFRAME):
            s = inp[n] << 12
            for i in range(10):
                s -= lp[i] * tmp[10 + n - i - 1]
            s = _w32(s) >> 12
            if s > 32767 or s < -32768:
                if exit_on_overflow:
                    return None, 1
                s = _clip(s, -32768, 32767)
            tmp[10 + n] = s
        filter_data[:] = tmp[SUBFRAME:SUBFRAME + 10]
        return tmp[10:10 + SUBFRAME], 0

    def residual_calc(self, lp_gn, speech):
        tmp = list(self.pos_filter_data) + list(speech)
        for n in range(SUBFRAME):
            s = tmp[10 + n] << 12
            for i in range(10):
                s += lp_gn[i] * tmp[10 + n - i - 1]
            s = _clip(_w32(s), -32768 << 12, 32767 << 12)
            self.residual[n + PITCH_MAX] = g729_round(s << 4)
        self.pos_filter_data[:] = speech[SUBFRAME - 10:SUBFRAME]

    def long_term_filter(self, intT1):
        res = self.residual
        minT0 = min(intT1, PITCH_MAX - 3) - 3
        maxT0 = min(intT1, PITCH_MAX - 3) + 3
        intT0, corr_max = minT0, None
        for k in range(minT0, maxT0 + 1):
            c = _w32(sum((res[PITCH_MAX - k + n] >> 1) *
                         (res[PITCH_MAX - k + n + k] >> 1)
                         for n in range(SUBFRAME)))
            if corr_max is None or c > corr_max:
                corr_max, intT0 = c, k
        corr_t0 = _w32(sum((res[PITCH_MAX - intT0 + n] >> 1) ** 2
                           for n in range(SUBFRAME)))
        corr_0 = _w32(sum((res[PITCH_MAX + n] >> 1) ** 2
                          for n in range(SUBFRAME)))
        tmp = av_log2(max(corr_0, corr_t0, corr_max, 1))
        if tmp > 14:
            corr_t0 >>= tmp - 14
            corr_0 >>= tmp - 14
            corr_max >>= tmp - 14
        if _w32(corr_max * corr_max) < _w32(corr_0 * corr_t0) >> 1:
            gl = 0
        elif not corr_t0 or corr_max > corr_t0:
            gl = 32768
        else:
            gl = l_div(corr_max, corr_t0, 15)
        gl = (gl * GAMMA_P) >> 15
        inv_glgp = 0 if gl < -32768 else l_div(32768, 32768 + gl, 15)
        glgp_inv_glgp = 32768 - inv_glgp
        out = [0] * SUBFRAME
        for n in range(SUBFRAME):
            out[n] = _i16((res[n + PITCH_MAX] * inv_glgp +
                           res[n + PITCH_MAX - intT0] * glgp_inv_glgp) >> 15)
        return out

    @staticmethod
    def weighted_filter(az, gamma):
        out = [0] * 10
        gp = gamma
        for n in range(10):
            out[n] = _i16((az[n] * gp) >> 15)
            gp = (gp * gamma) >> 15
        return out

    def tilt_compensation(self, lp_gn, lp_gd, res_pst):
        hf = [0] * 33
        hf[10] = 4096
        for i in range(10):
            hf[i + 11] = lp_gn[i]
        for n in range(22):
            s = hf[n + 10]
            for i in range(10):
                s -= (lp_gd[i] * hf[n + 10 - i - 1]) >> 12
            hf[n + 10] = _i16(_w32(s))
        rh0 = _w32(sum(hf[10 + i] * hf[10 + i] for i in range(22))) >> 12
        rh1 = _w32(sum(hf[10 + i] * hf[10 + i + 1] for i in range(21))) >> 12
        rh1 = (rh1 * GAMMA_T) >> 15
        gt = -l_div(rh1, rh0, 12) if rh1 > 0 else 0
        tmp = res_pst[SUBFRAME - 1]
        for i in range(SUBFRAME - 1, 0, -1):
            res_pst[i] = _i16(res_pst[i] + ((gt * res_pst[i - 1]) >> 12))
        res_pst[0] = _i16(res_pst[0] + ((gt * self.ht_prev_data) >> 12))
        self.ht_prev_data = tmp

    def adaptive_gain_control(self, gain_before, gain_after, speech):
        if not gain_after:
            return
        if gain_before:
            gain = l_div(gain_after, gain_before, 12)
            gain = l_inv_sqrt(gain) >> 11
        else:
            gain = 0
        gp = self.gain_coeff
        for n in range(SUBFRAME):
            gp = (29491 * gp + 3276 * gain) >> 15
            speech[n] = _i16((speech[n] * gp) >> 12)
        self.gain_coeff = gp

    def postfilter(self, lp, pitch_delay_int, speech):
        lp_gn = self.weighted_filter(lp, GAMMA_N)
        lp_gd = self.weighted_filter(lp, GAMMA_D)
        gain_before = _w32(sum((x >> 4) * (x >> 4) for x in speech))
        self.residual_calc(lp_gn, speech)
        residual_filt = self.long_term_filter(pitch_delay_int)
        self.residual[:PITCH_MAX] = self.residual[SUBFRAME:SUBFRAME + PITCH_MAX]
        self.tilt_compensation(lp_gn, lp_gd, residual_filt)
        out, _ = self.lp_synthesis_filter(lp_gd, residual_filt,
                                          self.res_filter_data, 0)
        speech[:] = out
        gain_after = _w32(sum((x >> 4) * (x >> 4) for x in speech))
        self.adaptive_gain_control(gain_before, gain_after, speech)

    def high_pass_filter(self, speech):
        f, z = self.hpf_f, self.hpf_z
        for i in range(len(speech)):
            z[2] = z[1]
            z[1] = z[0]
            z[0] = speech[i]
            f0 = _w32(mul_24_15(f[1], 15836) + mul_24_15(f[2], -7667)
                      + 7699 * (z[0] - 2 * z[1] + z[2]))
            f0 = f0 << 2
            # C int32 wrap on the Q13->Q15 shift
            f0 = ((f0 + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
            speech[i] = _clip(f0 >> 14, -32768, 32767)
            f[2] = f[1]
            f[1] = f0

    # --- frame decode ---------------------------------------------------------

    def decode_frame(self, buf: bytes) -> np.ndarray:
        parm, erased = bytes2parm(buf)
        return self.decode_parameters(parm, erased)

    def decode_parameters(self, parm, frame_erasure) -> np.ndarray:
        self.data_error = 1 if frame_erasure else 0
        if parm is None:
            parm = {"ma_predictor": 0, "quantizer_1st": 0,
                    "quantizer_2nd_lo": 0, "quantizer_2nd_hi": 0,
                    "parity": 0, "ac_index": [0, 0], "fc_indexes": [0, 0],
                    "pulses_signs": [0, 0], "ga_cb_index": [0, 0],
                    "gb_cb_index": [0, 0]}
        self.bad_pitch = 0 if parity_check(parm["ac_index"][0], parm["parity"]) else 1

        if self.data_error:
            lsf = self.lsf_restore_from_previous()
        else:
            lsf = self.lsf_decode(parm["ma_predictor"], parm["quantizer_1st"],
                                  parm["quantizer_2nd_lo"], parm["quantizer_2nd_hi"])
        lsp = self.lsf2lsp(lsf)
        lp = self.lp_decode(lsp)

        out = [0] * (2 * SUBFRAME)
        for i in range(2):
            if i == 0:
                if self.bad_pitch or self.data_error:
                    pitch_delay_3x = 3 * self.pitch_delay_int_prev + 1
                elif parm["ac_index"][0] >= 197:
                    pitch_delay_3x = 3 * parm["ac_index"][0] - 335
                else:
                    pitch_delay_3x = parm["ac_index"][0] + 59
            else:
                if self.data_error:
                    pitch_delay_3x = 3 * self.pitch_delay_int_prev + 1
                else:
                    pitch_delay_3x = (parm["ac_index"][1] + 3 * _clip(
                        self.pitch_delay_int_prev - 5, PITCH_MIN, PITCH_MAX - 9) - 1)
            pitch_delay_int = pitch_delay_3x // 3

            self.decode_ac_vector(pitch_delay_int, (pitch_delay_3x % 3) - 1,
                                  i * SUBFRAME)

            if self.data_error:
                self.rand_value = g729_random(self.rand_value)
                parm["fc_indexes"][i] = self.rand_value & 0x1FFF
                self.rand_value = g729_random(self.rand_value)
                parm["pulses_signs"][i] = self.rand_value & 0x000F

            fc, err = self.decode_fc_vector(parm["fc_indexes"][i],
                                            parm["pulses_signs"][i])
            if err:
                self.data_error = 1
            self.fix_fc_vector(pitch_delay_int, fc)

            if self.data_error:
                self.gain_pitch = min((29491 * self.gain_pitch) >> 15, 29491)
                self.gain_code = (8028 * self.gain_code) >> 13
                self.update_gain_erasure()
            else:
                self.gain_pitch = int(T.CB_GA[parm["ga_cb_index"][i]][0]) + \
                    int(T.CB_GB[parm["gb_cb_index"][i]][0])
                self.gain_code = self.get_gain_code(
                    parm["ga_cb_index"][i], parm["gb_cb_index"][i], fc)

            self.pitch_sharp = _clip(self.gain_pitch, SHARP_MIN, SHARP_MAX)
            self.mem_update(fc, self.gain_pitch, self.gain_code, i * SUBFRAME)

            exc_sub = self.exc_base[self.exc_off + i * SUBFRAME:
                                    self.exc_off + (i + 1) * SUBFRAME]
            speech, overflow = self.lp_synthesis_filter(
                lp[i * 10:(i + 1) * 10], exc_sub, self.syn_filter_data, 1)
            if overflow:
                self.exc_base = [x >> 2 for x in self.exc_base]
                exc_sub = self.exc_base[self.exc_off + i * SUBFRAME:
                                        self.exc_off + (i + 1) * SUBFRAME]
                speech, _ = self.lp_synthesis_filter(
                    lp[i * 10:(i + 1) * 10], exc_sub, self.syn_filter_data, 0)

            self.postfilter(lp[i * 10:(i + 1) * 10], pitch_delay_int, speech)

            if self.data_error:
                self.pitch_delay_int_prev = min(self.pitch_delay_int_prev + 1,
                                                PITCH_MAX)
            else:
                self.pitch_delay_int_prev = pitch_delay_int
            out[i * SUBFRAME:(i + 1) * SUBFRAME] = speech

        self.exc_base[:PITCH_MAX + INTERPOL_LEN] = \
            self.exc_base[2 * SUBFRAME:2 * SUBFRAME + PITCH_MAX + INTERPOL_LEN]

        self.high_pass_filter(out)
        return np.array(out, dtype=np.int16)


def decode_stream(frames: list[bytes]) -> np.ndarray:
    dec = G729Decoder()
    return np.concatenate([dec.decode_frame(f) for f in frames]) if frames \
        else np.zeros(0, np.int16)
