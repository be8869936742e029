"""G.729 Annex A decoding of B independent streams: the port of
`amv_tpu/codecs/g729a.py`.

The decoder's recurrences run from frame to frame (LSF, gain and
excitation memories), so the parallelism is across streams: B streams
decode in lockstep, one frame step at a time.  The functions keep the
JAX package's contracts:

* `init_state(batch, device=)`: the decoder state, a dict of int32 tensors
  with a leading batch axis (the fields of `amv_tpu/codecs/g729a.py:
  init_state`);
* `unpack_frames`: packed frames uint8 [T, B, 10] -> parameters int32
  [T, B, 16] (`PARM_FIELDS`; the last is the erasure flag, set for a frame
  whose 10 bytes are all zero);
* `decode_frame_batch(st, parm)` -> (st, pcm int16 [B, 80]): one 10 ms
  frame, two subframes of 40 samples;
* `decode_frames_scan(st, parms)` -> (st, pcm int16 [T, B, 80]);
* `decode_streams(frames uint8 [T, B, 10])` -> int16 [B, T*80].

`decode_frame_batch` is the plain version: torch ops over the B streams,
a Python loop over each recurrence's steps.  `decode_frames_scan` and
`decode_streams` run it for CPU tensors and launch kernel G
(`kernels/g729.py`, csrc/g729_decode.cu: all T frames in one launch) for
CUDA tensors.  The arithmetic is the C decoder's (G.729/g729a_native.c)
as the scalar oracle `verify/ref_g729.py` writes it: int32 sums and
products wrap, and every int16 cast and clip is kept.  torch's int32
arithmetic wraps, as XLA's does; the few unsigned steps run in int64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels._build import device_key
from ..verify import ref_g729 as R
from . import g729_tables as T

SUBFRAME = R.SUBFRAME
PITCH_MIN, PITCH_MAX = R.PITCH_MIN, R.PITCH_MAX
INTERPOL_LEN = R.INTERPOL_LEN
SHARP_MIN, SHARP_MAX = R.SHARP_MIN, R.SHARP_MAX
GAMMA_N, GAMMA_D, GAMMA_T, GAMMA_P = R.GAMMA_N, R.GAMMA_D, R.GAMMA_T, R.GAMMA_P

EXC_LEN = 2 * 44 + PITCH_MAX + 2 * INTERPOL_LEN  # incl. zero OOB tail
EXC_OFF = PITCH_MAX + INTERPOL_LEN
RES_LEN = 44 + PITCH_MAX

# magic parity table (3.7.2), the low and high words of 0x6996966996696996
PARITY_LO = 0x96696996
PARITY_HI = 0x69969669


def _powers(gamma):
    out, g = [], gamma
    for _ in range(10):
        out.append(g)
        g = (g * gamma) >> 15
    return np.array(out, np.int32)


GAMMA_POWS_N = _powers(GAMMA_N)
GAMMA_POWS_D = _powers(GAMMA_D)

PARM_FIELDS = ["ma_predictor", "quantizer_1st", "quantizer_2nd_lo",
               "quantizer_2nd_hi", "parity", "ac_index0", "ac_index1",
               "fc_index0", "fc_index1", "pulses_signs0", "pulses_signs1",
               "ga0", "ga1", "gb0", "gb1", "erasure"]
# (first bit, width) of each field in the 80-bit frame
# (g729a_native.c:1852-1868): L0@0:1 L1@1:7 L2@8:5 L3@13:5 P1@18:8 P0@26:1
# C1@27:13 S1@40:4 GA1@44:3 GB1@47:4 P2@51:5 C2@56:13 S2@69:4 GA2@73:3
# GB2@76:4
PARM_BITS = [(0, 1), (1, 7), (8, 5), (13, 5), (26, 1), (18, 8), (51, 5),
             (27, 13), (56, 13), (40, 4), (69, 4), (44, 3), (73, 3),
             (47, 4), (76, 4)]

# the state's fields and their shapes after the batch axis, in the order
# kernel G keeps them (kernels/g729.py flattens the dict in this order)
STATE_FIELDS = [("exc", (EXC_LEN,)), ("pitch_prev", ()), ("lq_prev", (4, 10)),
                ("lsp_prev", (10,)), ("lsf_prev", (10,)),
                ("pred_energ_q", (4,)), ("gain_pitch", ()),
                ("gain_code", ()), ("pitch_sharp", ()),
                ("residual", (RES_LEN,)), ("syn_filter_data", (10,)),
                ("res_filter_data", (10,)), ("pos_filter_data", (10,)),
                ("ht_prev_data", ()), ("gain_coeff", ()),
                ("rand_value", ()), ("prev_mode", ()), ("hpf_f", (2,)),
                ("hpf_z", (2,))]

_TABLES = {}


def _tab(name: str, dev) -> torch.Tensor:
    """A table of g729_tables (or of this module) as an int32 tensor on
    dev, made once per device."""
    key = (name, device_key(dev))
    if key not in _TABLES:
        src = getattr(T, name) if hasattr(T, name) else globals()[name]
        _TABLES[key] = torch.as_tensor(np.asarray(src, np.int32),
                                       device=dev)
    return _TABLES[key]


def _i16(x):
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _mul_sh15(a, b):
    """(int64(a) * b) >> 15 cut to int32, in int32 ops (|b| <= 32767)."""
    return (a >> 16) * b * 2 + (((a & 0xFFFF) * b) >> 15)


def _av_log2(v):
    """floor(log2(v)) of v read as uint32 (v > 0), int32."""
    v = v.long() & 0xFFFFFFFF
    r = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        m = v >= (1 << s)
        r = r + torch.where(m, s, 0)
        v = torch.where(m, v >> s, v)
    return r.int()


def _interp(tab, x0, dx):
    return (tab[x0] << 15) + dx * (tab[x0 + 1] - tab[x0])


def l_log2(value):
    p = _av_log2(value)
    res = ((value.long() & 0xFFFFFFFF) << (31 - p).long()) & 0xFFFFFFFF
    x0 = ((res & 0x7C000000) >> 26).int()
    dx = ((res & 0x03FFF800) >> 11).int()
    return (p << 15) + (_interp(_tab("TAB_LOG2", value.device), x0, dx) >> 15)


def l_pow2(power):
    x0 = (power & 0x7C00) >> 10
    dx = (power & 0x03FF) << 5
    return (_interp(_tab("TAB_POW2", power.device), x0, dx) + 16384) >> 15


def l_inv_sqrt(arg):
    p = (_av_log2(arg) >> 1) + 1
    res = ((arg.long() & 0xFFFFFFFF) << (32 - (p << 1)).long()) & 0xFFFFFFFF
    x0 = (res >> 26).int() - 16
    dx = ((res >> 11) & 0x7FE0).int()
    r = _interp(_tab("TAB_INV_SQRT", arg.device), x0, dx)
    return ((r.long() & 0xFFFFFFFF) >> p.long()).int()


def l_div(num, denom, base: int):
    """l_div with the x86 shift-count masking where the numerator's
    magnitude passes 2^26; floor division, as the oracle's."""
    sig = (num < 0) ^ (denom < 0)
    num_a, den_a = num.abs(), denom.abs()
    diff = 26 - _av_log2(torch.clamp(num_a, min=1))
    num_s = num_a << (torch.clamp(diff, max=base) & 31)
    den_s = den_a >> ((torch.clamp(diff, min=base) - diff) & 31)
    q = torch.div(num_s, torch.clamp(den_s, min=1), rounding_mode="floor")
    return torch.where(num == 0, 0, torch.where(sig, -q, q))


def g729_round(v):
    return torch.where(v > 0x7FFFFFFF - 0x8000, 32767, (v + 0x8000) >> 16)


def parity_check(p1, p0):
    idx = p1 >> 2
    word = torch.where(idx >= 32, PARITY_HI, PARITY_LO).long()
    return (((word >> (idx & 31).long()) & 1).int() ^ p0) & 1


# ---------------------------------------------------------------- state

def init_state(batch: int, *, device) -> dict:
    """The state of `batch` decoders before their first frame, on
    `device` (no default: a forgotten device must not mean the CPU)."""
    z = lambda *s: torch.zeros((batch,) + s, dtype=torch.int32,
                               device=device)
    full = lambda v, *s: torch.full((batch,) + s, v, dtype=torch.int32,
                                    device=device)
    return dict(
        exc=z(EXC_LEN), pitch_prev=z(),
        lq_prev=_tab("LQ_INIT", device).expand(batch, 4, 10).clone(),
        lsp_prev=_tab("LSP_INIT", device).expand(batch, 10).clone(),
        lsf_prev=z(10), pred_energ_q=full(-14336, 4), gain_pitch=z(),
        gain_code=z(), pitch_sharp=full(SHARP_MIN), residual=z(RES_LEN),
        syn_filter_data=z(10), res_filter_data=z(10),
        pos_filter_data=z(10), ht_prev_data=z(), gain_coeff=full(4096),
        rand_value=full(21845), prev_mode=z(), hpf_f=z(2), hpf_z=z(2))


# ------------------------------------------------------- LSF / LSP / LP

def _lq_rotate(st, lq):
    st["lq_prev"] = torch.cat([lq[:, None], st["lq_prev"][:, :3]], dim=1)


def lsf_restore_from_previous(st):
    dev = st["exc"].device
    lsfq = st["lsf_prev"]
    mp = _tab("MA_PREDICTOR", dev)[st["prev_mode"].long()]
    mpinv = _tab("MA_PREDICTOR_SUM_INV", dev)[st["prev_mode"].long()]
    v = (lsfq << 15) - (st["lq_prev"] * mp).sum(1, dtype=torch.int32)
    _lq_rotate(st, ((v >> 15) * mpinv) >> 12)
    return lsfq


def lsf_decode(st, l0, l1, l2, l3):
    dev = l0.device
    cb1, cb23 = _tab("CB_L1", dev), _tab("CB_L2_L3", dev)
    c1 = cb1[l1.long()]
    lq = torch.cat([c1[:, :5] + cb23[l2.long()][:, :5],
                    c1[:, 5:] + cb23[l3.long()][:, 5:]], dim=1)
    cols = list(lq.unbind(1))
    for j in (10, 5):
        for i in range(1, 10):
            diff = (cols[i - 1] - cols[i] + j) >> 1
            pos = diff > 0
            cols[i - 1] = torch.where(pos, cols[i - 1] - diff, cols[i - 1])
            cols[i] = torch.where(pos, cols[i] + diff, cols[i])
    lq = torch.stack(cols, 1)
    mp = _tab("MA_PREDICTOR", dev)[l0.long()]
    msum = _tab("MA_PREDICTOR_SUM", dev)[l0.long()]
    lsfq = _i16((lq * msum + (st["lq_prev"] * mp).sum(1, dtype=torch.int32))
                >> 15)
    st["lsf_prev"] = lsfq
    _lq_rotate(st, lq)
    st["prev_mode"] = l0
    # the C bubble sort as its compare-exchange network, then the spacing
    cols = list(lsfq.unbind(1))
    for j in range(9, 0, -1):
        for i in range(j):
            a, b = cols[i], cols[i + 1]
            cols[i], cols[i + 1] = torch.minimum(a, b), torch.maximum(a, b)
    cols[0] = torch.clamp(cols[0], min=R.LSFQ_MIN)
    for i in range(9):
        cols[i + 1] = torch.maximum(cols[i + 1], cols[i] + R.LSFQ_DIFF_MIN)
    cols[9] = torch.clamp(cols[9], max=R.LSFQ_MAX)
    return torch.stack(cols, 1)


def lsf2lsp(lsf):
    freq = _i16((lsf * 20861) >> 15)
    ind = (freq >> 8).long()
    return _i16(_tab("BASE_COS", lsf.device)[ind] +
                ((_tab("SLOPE_COS", lsf.device)[ind] * (freq & 0xFF)) >> 12))


def _lsp_poly(lsp):
    """5 LSPs [B] -> the 6 Q24 coefficients of their polynomial."""
    f = [None] * 6
    f[0] = torch.full_like(lsp[0], 1 << 24)
    f[1] = -lsp[0] << 10
    for i in range(2, 6):
        f[i] = f[i - 2]
        for j in range(i, 1, -1):
            f[j] = f[j] - (_mul_sh15(f[j - 1] >> 1, lsp[i - 1]) << 2) \
                + f[j - 2]
        f[1] = f[1] - (lsp[i - 1] << 10)
    return f


def lsp2lp(lsp):
    """lsp [B, 10] -> LP [B, 10] (Q12)."""
    cols = lsp.unbind(1)
    f1, f2 = _lsp_poly(cols[0::2]), _lsp_poly(cols[1::2])
    lp = [None] * 10
    for i in range(5):
        ff1 = f1[i + 1] + f1[i] + (1 << 12)
        ff2 = f2[i + 1] - f2[i]
        lp[i] = _i16((ff1 + ff2) >> 13)
        lp[9 - i] = _i16((ff1 - ff2) >> 13)
    return torch.stack(lp, 1)


def lp_decode(st, lsp):
    lp1 = lsp2lp((lsp >> 1) + (st["lsp_prev"] >> 1))
    lp2 = lsp2lp(lsp)
    st["lsp_prev"] = lsp
    return lp1, lp2


# ------------------------------------------------ codebooks / excitation

def decode_ac_vector(exc, pd_int, pd_frac, off: int):
    """The adaptive-codebook vector (1/3 interpolation) written over
    exc[:, EXC_OFF + off:][:40], sample by sample: a short lag reads the
    samples just written.  The filter is read flat, so filter[i][3 - frac]
    reads row i + 1 when frac is 0 (the C decoder's indexing)."""
    frac = -pd_frac
    neg = frac < 0
    frac = torch.where(neg, frac + 3, frac)
    pd = torch.where(neg, pd_int + 1, pd_int)
    flat = _tab("INTERP_FILTER", exc.device).reshape(-1)
    i = torch.arange(10, device=exc.device)
    coef = torch.cat([flat[3 * i[None] + frac[:, None]],
                      flat[3 * i[None] + 3 - frac[:, None]]], 1)   # [B, 20]
    rel = torch.cat([-pd[:, None] - i[None], -pd[:, None] + i[None] + 1], 1)
    base = EXC_OFF + off
    exc = exc.clone()
    lo, hi = -(1 << 30), (1 << 30) - 1
    for n in range(SUBFRAME):
        terms = exc.gather(1, (base + n + rel).long()) * coef
        v = torch.zeros_like(pd)
        for k in range(10):           # the C order: t1[0], t2[0], t1[1], ...
            v = torch.clamp(v + terms[:, k], lo, hi)
            v = torch.clamp(v + terms[:, 10 + k], lo, hi)
        exc[:, base + n] = g729_round(v << 1)
    return exc


def decode_fc_vector(fc_index, pulses_signs):
    """4 pulses of +-1 (Q13) -> fc [B, 40] and the index error flag."""
    b = fc_index.shape[0]
    fc = torch.zeros((b, SUBFRAME), dtype=torch.int32,
                     device=fc_index.device)
    err = torch.zeros_like(fc_index)
    rows = torch.arange(b, device=fc_index.device)
    fi, ps = fc_index, pulses_signs

    def put(fc, index, ps):
        at = torch.clamp(index, max=SUBFRAME - 1).long()
        val = torch.where((ps & 1) != 0, 8191, -8192).int()
        fc[rows, at] = torch.where(index < SUBFRAME, val, fc[rows, at])
        return (index >= SUBFRAME).int()

    for i in range(3):
        err = err | put(fc, (fi & 7) * 5 + i, ps)
        fi, ps = fi >> 3, ps >> 1
    err = err | put(fc, ((fi >> 1) & 7) * 5 + 3 + (fi & 1), ps)
    return fc, err


def fix_fc_vector(fc, pitch_delay, gain_pitch):
    """fc[i] += (fc[i - pd] gp) >> 14 for i >= pd, in order of i."""
    fc = fc.clone()
    for i in range(SUBFRAME):
        src = fc.gather(1, torch.clamp(i - pitch_delay, min=0).long()[:, None])
        new = _i16(fc[:, i] + ((src[:, 0] * gain_pitch) >> 14))
        fc[:, i] = torch.where(i >= pitch_delay, new, fc[:, i])
    return fc


def get_gain_code(st, ga, gb, fc):
    dev = fc.device
    energy = (fc * fc).sum(1, dtype=torch.int32)
    energy = _mul_sh15(l_log2(torch.clamp(energy, min=1)), -24660)
    energy = energy + ((R.l_log2(SUBFRAME) * 24660) >> 15) + 0xD8888 - 2
    energy = energy << 10
    energy = energy + (st["pred_energ_q"] *
                       _tab("MA_PREDICTION_COEFF", dev)).sum(
                           1, dtype=torch.int32)
    energy = (5439 * (energy >> 15)) >> 8
    expn = energy >> 15
    energy = l_pow2(energy & 0x7FFF) & 0x7FFF
    cb1_sum = (_tab("CB_GA", dev)[ga.long(), 1] +
               _tab("CB_GB", dev)[gb.long(), 1])
    pe0 = _i16((24660 * ((l_log2(cb1_sum) >> 2) - (13 << 13))) >> 15)
    st["pred_energ_q"] = torch.cat([pe0[:, None], st["pred_energ_q"][:, :3]],
                                   1)
    energy = energy * (cb1_sum >> 1)
    pos = 25 - expn > 0
    energy = torch.where(pos, energy >> torch.where(pos, 25 - expn, 0),
                         energy << torch.where(pos, 0, expn - 25))
    return _i16(energy)


def mem_update(exc, fc, gp, gc, off: int):
    a = EXC_OFF + off
    s = exc[:, a:a + SUBFRAME] * gp[:, None] + fc * gc[:, None]
    s = torch.clamp(s, -32768 << 14, 32767 << 14)
    exc = exc.clone()
    exc[:, a:a + SUBFRAME] = g729_round(s << 2)
    return exc


# -------------------------------------------------------------- filters

def lp_synthesis_filter(lp, inp, filter_data, clip_output: bool):
    """1/A(z) over inp [B, 40] from the last 10 outputs (oldest first) ->
    (out [B, 40], the new last 10, overflow [B] bool); the first pass
    keeps overflowing samples, the second (clip_output) clips them."""
    hist = list(filter_data.unbind(1))
    cols = lp.unbind(1)
    outs, ovf = [], torch.zeros(lp.shape[0], dtype=torch.bool,
                                device=lp.device)
    for x in inp.unbind(1):
        s = x << 12
        for i in range(10):
            s = s - cols[i] * hist[9 - i]
        s = s >> 12
        ovf = ovf | (s > 32767) | (s < -32768)
        if clip_output:
            s = torch.clamp(s, -32768, 32767)
        hist = hist[1:] + [s]
        outs.append(s)
    return torch.stack(outs, 1), torch.stack(hist, 1), ovf


def residual_fir(lp_gn, speech, pos_filter_data):
    """A(z/GAMMA_N) FIR (4.2.1 Eq. 79) over the subframe."""
    ext = torch.cat([pos_filter_data, speech], 1)
    s = speech << 12
    for i in range(10):
        s = s + lp_gn[:, i:i + 1] * ext[:, 9 - i:9 - i + SUBFRAME]
    s = torch.clamp(s, -32768 << 12, 32767 << 12)
    return g729_round(s << 4)


def long_term_filter(res, int_t1):
    dev = res.device
    b = res.shape[0]
    base = torch.clamp(int_t1, max=PITCH_MAX - 3)
    n = torch.arange(SUBFRAME, device=dev)
    k = base[:, None, None] + torch.arange(-3, 4, device=dev)[None, :, None]
    lagged = res.gather(1, (PITCH_MAX - k + n).reshape(b, -1).long()
                        ).reshape(b, 7, SUBFRAME)
    cur = res[:, PITCH_MAX:PITCH_MAX + SUBFRAME]
    corr = ((lagged >> 1) * (cur[:, None] >> 1)).sum(2, dtype=torch.int32)
    best = corr.argmax(1)           # the first maximum
    corr_max = corr.gather(1, best[:, None])[:, 0]
    int_t0 = base + best.int() - 3
    lag_t0 = res.gather(1, (PITCH_MAX - int_t0[:, None] + n).long())
    corr_t0 = ((lag_t0 >> 1) * (lag_t0 >> 1)).sum(1, dtype=torch.int32)
    corr_0 = ((cur >> 1) * (cur >> 1)).sum(1, dtype=torch.int32)
    top = torch.maximum(torch.maximum(corr_0, corr_t0), corr_max)
    tmp = _av_log2(torch.clamp(top, min=1))
    sh = torch.where(tmp > 14, tmp - 14, 0)
    corr_t0, corr_0, corr_max = corr_t0 >> sh, corr_0 >> sh, corr_max >> sh
    gl = torch.where(
        corr_max * corr_max < (corr_0 * corr_t0) >> 1, 0,
        torch.where((corr_t0 == 0) | (corr_max > corr_t0), 32768,
                    l_div(corr_max, torch.clamp(corr_t0, min=1), 15)))
    gl = (gl * GAMMA_P) >> 15
    inv = torch.where(gl < -32768, 0,
                      l_div(torch.full_like(gl, 32768), 32768 + gl, 15))
    out = _i16((cur * inv[:, None] + lag_t0 * (32768 - inv)[:, None]) >> 15)
    return out, int_t0


def tilt_compensation(st, lp_gn, lp_gd, res_pst):
    b = res_pst.shape[0]
    dev = res_pst.device
    # the impulse response of A(z/gn)/A(z/gd), 22 samples
    x = torch.cat([torch.full((b, 1), 4096, dtype=torch.int32, device=dev),
                   lp_gn, torch.zeros((b, 11), dtype=torch.int32,
                                      device=dev)], 1)
    hist = [torch.zeros(b, dtype=torch.int32, device=dev)] * 10
    gd = lp_gd.unbind(1)
    hf = []
    for t in range(22):
        s = x[:, t]
        for i in range(10):
            s = s - ((gd[i] * hist[9 - i]) >> 12)
        s = _i16(s)
        hist = hist[1:] + [s]
        hf.append(s)
    hf = torch.stack(hf, 1)
    rh0 = (hf * hf).sum(1, dtype=torch.int32) >> 12
    rh1 = (hf[:, :-1] * hf[:, 1:]).sum(1, dtype=torch.int32) >> 12
    rh1 = (rh1 * GAMMA_T) >> 15
    gt = torch.where(rh1 > 0, -l_div(rh1, torch.clamp(rh0, min=1), 12), 0)
    prev = torch.cat([st["ht_prev_data"][:, None], res_pst[:, :-1]], 1)
    st["ht_prev_data"] = res_pst[:, -1]
    return _i16(res_pst + ((gt[:, None] * prev) >> 12))


def adaptive_gain_control(st, gain_before, gain_after, speech):
    has_after = gain_after != 0
    gain = torch.where(
        gain_before != 0,
        l_inv_sqrt(torch.clamp(l_div(gain_after,
                                     torch.clamp(gain_before, min=1), 12),
                               min=1)) >> 11, 0)
    gp = st["gain_coeff"]
    outs = []
    for x in speech.unbind(1):
        gp = (29491 * gp + 3276 * gain) >> 15
        outs.append(_i16((x * gp) >> 12))
    st["gain_coeff"] = torch.where(has_after, gp, st["gain_coeff"])
    return torch.where(has_after[:, None], torch.stack(outs, 1), speech)


def postfilter(st, lp, pd_int, speech):
    dev = lp.device
    lp_gn = _i16((lp * _tab("GAMMA_POWS_N", dev)) >> 15)
    lp_gd = _i16((lp * _tab("GAMMA_POWS_D", dev)) >> 15)
    gain_before = ((speech >> 4) * (speech >> 4)).sum(1, dtype=torch.int32)
    res_new = residual_fir(lp_gn, speech, st["pos_filter_data"])
    st["pos_filter_data"] = speech[:, SUBFRAME - 10:]
    residual = st["residual"].clone()
    residual[:, PITCH_MAX:PITCH_MAX + SUBFRAME] = res_new
    filt, _ = long_term_filter(residual, pd_int)
    shifted = residual.clone()
    shifted[:, :PITCH_MAX] = residual[:, SUBFRAME:SUBFRAME + PITCH_MAX]
    st["residual"] = shifted
    filt = tilt_compensation(st, lp_gn, lp_gd, filt)
    out, st["res_filter_data"], _ = lp_synthesis_filter(
        lp_gd, filt, st["res_filter_data"], clip_output=True)
    gain_after = ((out >> 4) * (out >> 4)).sum(1, dtype=torch.int32)
    return adaptive_gain_control(st, gain_before, gain_after, out)


def high_pass_filter(st, speech):
    """The 100 Hz output high-pass over the frame's 80 samples."""
    f1, f2 = st["hpf_f"].unbind(1)
    z1, z2 = st["hpf_z"].unbind(1)
    outs = []
    for x in speech.unbind(1):
        f0 = (_mul_sh15(f1, 15836) + _mul_sh15(f2, -7667)
              + 7699 * (x - 2 * z1 + z2)) << 2
        outs.append(torch.clamp(f0 >> 14, -32768, 32767))
        f1, f2, z1, z2 = f0, f1, x, z1
    st["hpf_f"] = torch.stack([f1, f2], 1)
    st["hpf_z"] = torch.stack([z1, z2], 1)
    return torch.stack(outs, 1)


# --------------------------------------------------------- frame decode

def unpack_frames(frames) -> torch.Tensor:
    """Packed frames uint8 [T, B, 10] (a tensor on any device, or an
    array) -> parameters int32 [T, B, 16] on the same device."""
    if not isinstance(frames, torch.Tensor):
        frames = torch.from_numpy(np.array(frames, np.uint8))
    b = frames.to(torch.int32)
    b = torch.cat([b, torch.zeros_like(b[..., :2])], -1)
    out = []
    for lo, n in PARM_BITS:        # each field lies within 3 bytes
        k = lo >> 3
        word = (b[..., k] << 16) | (b[..., k + 1] << 8) | b[..., k + 2]
        out.append((word >> (24 - (lo & 7) - n)) & ((1 << n) - 1))
    out.append((frames == 0).all(-1).to(torch.int32))
    return torch.stack(out, -1)


def decode_frame_batch(st: dict, parm: torch.Tensor):
    """One frame of B streams: st, parm int32 [B, 16] -> (st, pcm int16
    [B, 80]).  The plain version of kernel G; st is not modified."""
    st = dict(st)
    dev = parm.device
    era = parm[:, 15] != 0
    ac0, ac1 = parm[:, 5], parm[:, 6]
    bad_pitch = parity_check(ac0, parm[:, 4]) == 0
    data_error = era

    # the two LSF paths each update lq_prev (and the good one lsf_prev and
    # prev_mode): run both on copies and keep each stream's own
    st_e, st_g = dict(st), dict(st)
    lsf_err = lsf_restore_from_previous(st_e)
    lsf_good = lsf_decode(st_g, *parm[:, :4].unbind(1))

    def sel(a, b):
        return torch.where(era.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    lsf = sel(lsf_err, lsf_good)
    for k in ("lq_prev", "lsf_prev", "prev_mode"):
        st[k] = sel(st_e[k], st_g[k])
    lp1, lp2 = lp_decode(st, lsf2lsp(lsf))
    cb_ga, cb_gb = _tab("CB_GA", dev), _tab("CB_GB", dev)

    outs = []
    for i, lp in enumerate((lp1, lp2)):
        if i == 0:
            pd3x = torch.where(ac0 >= 197, 3 * ac0 - 335, ac0 + 59)
            pd3x = torch.where(bad_pitch | data_error,
                               3 * st["pitch_prev"] + 1, pd3x)
        else:
            pd3x = ac1 + 3 * torch.clamp(st["pitch_prev"] - 5, PITCH_MIN,
                                         PITCH_MAX - 9) - 1
            pd3x = torch.where(data_error, 3 * st["pitch_prev"] + 1, pd3x)
        pd_int = torch.div(pd3x, 3, rounding_mode="floor")
        st["exc"] = decode_ac_vector(st["exc"], pd_int, pd3x % 3 - 1,
                                     i * SUBFRAME)

        # an erased frame draws its fixed-codebook parameters at random
        r1 = (31821 * st["rand_value"] + 13849) & 0xFFFF
        r2 = (31821 * r1 + 13849) & 0xFFFF
        st["rand_value"] = torch.where(data_error, r2, st["rand_value"])
        fci = torch.where(data_error, r1 & 0x1FFF, parm[:, 7 + i])
        psi = torch.where(data_error, r2 & 0x000F, parm[:, 9 + i])
        fc, err = decode_fc_vector(fci, psi)
        data_error = data_error | (err != 0)
        fc = fix_fc_vector(fc, pd_int, st["pitch_sharp"])

        gp_err = torch.clamp((29491 * st["gain_pitch"]) >> 15, max=29491)
        gc_err = (8028 * st["gain_code"]) >> 13
        p = st["pred_energ_q"]
        pred_err = torch.cat([torch.clamp((p.sum(1, dtype=torch.int32) >> 2)
                                          - 4096, min=-14336)[:, None],
                              p[:, :3]], 1)
        st_gain = dict(st)
        ga, gb = parm[:, 11 + i], parm[:, 13 + i]
        gc_good = get_gain_code(st_gain, ga, gb, fc)
        gp_good = cb_ga[ga.long(), 0] + cb_gb[gb.long(), 0]
        st["gain_pitch"] = torch.where(data_error, gp_err, gp_good)
        st["gain_code"] = torch.where(data_error, gc_err, gc_good)
        st["pred_energ_q"] = torch.where(data_error[:, None], pred_err,
                                         st_gain["pred_energ_q"])
        st["pitch_sharp"] = torch.clamp(st["gain_pitch"], SHARP_MIN,
                                        SHARP_MAX)
        st["exc"] = mem_update(st["exc"], fc, st["gain_pitch"],
                               st["gain_code"], i * SUBFRAME)

        a = EXC_OFF + i * SUBFRAME
        out1, fd1, ovf = lp_synthesis_filter(
            lp, st["exc"][:, a:a + SUBFRAME], st["syn_filter_data"], False)
        speech = torch.clamp(out1, -32768, 32767)
        if bool(ovf.any()):
            # an overflowing stream scales its whole excitation buffer
            # down by 4 and synthesises the subframe again, clipping
            exc = torch.where(ovf[:, None], st["exc"] >> 2, st["exc"])
            out2, fd2, _ = lp_synthesis_filter(
                lp, exc[:, a:a + SUBFRAME], st["syn_filter_data"], True)
            st["exc"] = exc
            speech = torch.where(ovf[:, None], out2, speech)
            fd1 = torch.where(ovf[:, None], fd2, fd1)
        st["syn_filter_data"] = fd1

        outs.append(postfilter(st, lp, pd_int, speech))
        st["pitch_prev"] = torch.where(
            data_error, torch.clamp(st["pitch_prev"] + 1, max=PITCH_MAX),
            pd_int)

    exc = st["exc"].clone()
    exc[:, :EXC_OFF] = st["exc"][:, 2 * SUBFRAME:2 * SUBFRAME + EXC_OFF]
    st["exc"] = exc
    pcm = high_pass_filter(st, torch.cat(outs, 1))
    return st, pcm.to(torch.int16)


def decode_frames_scan(st: dict, parms: torch.Tensor):
    """T frames of B streams: st, parms int32 [T, B, 16] -> (the state
    after frame T, pcm int16 [T, B, 80]).  CPU tensors run the plain
    frame step T times; CUDA tensors launch kernel G once for all T."""
    tensors = [parms, *st.values()]
    if all(t.device.type == "cpu" for t in tensors):
        pcm = torch.empty((parms.shape[0], parms.shape[1], 2 * SUBFRAME),
                          dtype=torch.int16)
        for t in range(parms.shape[0]):
            st, pcm[t] = decode_frame_batch(st, parms[t])
        return st, pcm
    from ..kernels import g729
    return g729.decode_frames(st, parms)


def decode_streams(frames) -> torch.Tensor:
    """Packed frames uint8 [T, B, 10] (a tensor, or an array for the CPU)
    -> PCM int16 [B, T*80] on the frames' device: B independent streams,
    each from the initial state."""
    if not isinstance(frames, torch.Tensor):
        frames = torch.from_numpy(np.array(frames, np.uint8))
    t, b = frames.shape[:2]
    if t == 0:
        return torch.zeros((b, 0), dtype=torch.int16, device=frames.device)
    _, pcm = decode_frames_scan(init_state(b, device=frames.device),
                                unpack_frames(frames))
    return pcm.permute(1, 0, 2).reshape(b, t * 2 * SUBFRAME)
