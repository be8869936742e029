"""Batched G.729A encoder: B independent streams in lockstep, the port of
`amv_tpu/codecs/g729a_encoder_tpu.py`.

The same algorithm as the host encoder (`codecs/g729a_encoder.py`):
float analysis, and quantizer decisions searched against the decoder's
exact integer reconstruction.  The shadow state *is* the batched decoder
state of `codecs/g729a.py` (`init_state`), advanced by that module's own
steps (`lsf_decode`, `lsf2lsp`, `lp_decode`, `decode_ac_vector`,
`decode_fc_vector`, `fix_fc_vector`, `get_gain_code`, `mem_update`,
`lp_synthesis_filter`), so it tracks a decoder of the emitted frames
exactly, frame by frame.

* `encode_frame_batch(st, hist, samples)` -> (st, hist, parm int32
  [B, 16]): one 80-sample frame, the plain version of kernel K;
* `encode_frames_scan(st, hist, frames)` -> (st, hist, parms [T, B, 16]):
  CPU tensors run the plain step T times, CUDA tensors launch kernel K
  (`kernels/g729.py:encode_frames`, csrc/g729_encode.cu) once for all T;
* `encode_streams(pcm [B, n*80])` -> packed frames uint8 [n, B, 10] on
  the PCM's device.

Numeric contract.  The float searches are float32 operations in a fixed
order that kernel K performs too: every sum runs sequentially from 0.0
in the order written here, products and sums are separate roundings (no
fused multiply-add: K is built with -fmad=false), divisions are IEEE
(tensor by tensor, or by a power of two), and cosines come from `_cos5`,
a polynomial both sides evaluate.  So K equals this version bit for bit.
Against the JAX package, whose XLA reductions sum in other orders and
whose cosines are jnp.cos, the integer parts (the exact LSF rescoring,
the gain codes, the parity, the state update) are equal given equal
inputs and the float searches agree within a tolerance
(tests/test_torch_g729_encoder.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels._build import device_key
from ..verify import ref_g729 as R
from . import g729_tables as T
from . import g729a as G
from .g729a_encoder import _LAG_WINDOW, _WLP

SUBFRAME, FRAME = 40, 80
PITCH_MIN, PITCH_MAX = 20, 143
HIST_SPAN = PITCH_MAX + R.INTERPOL_LEN    # the pitch grid's history: 154
UPS_LEN = PITCH_MAX + 1                   # upsampled positions q in -144..-1
N_GRID = 512                              # the Chebyshev root grid
BISECT = 12                               # bisection steps a root

# the shadow state's fields the encoder advances (the postfilter's and
# the high-pass's stay at init_state's values)
TRACKED = ("exc", "pitch_prev", "lq_prev", "lsp_prev", "lsf_prev",
           "pred_energ_q", "gain_pitch", "gain_code", "pitch_sharp",
           "syn_filter_data", "rand_value", "prev_mode")

F32 = np.float32
WLP = _WLP.astype(F32)
LAG_WINDOW = _LAG_WINDOW.astype(F32)
PI = F32(np.pi)
PI_511 = F32(np.pi / (N_GRID - 1))        # the grid's step
HALF_PI = F32(np.pi / 2)
# sin(u) = u (1 + u2 (S3 + u2 (S5 + u2 (S7 + u2 (S9 + u2 S11))))), |u| <=
# pi/2: the Taylor terms to u^11 (error < 6e-8)
SIN_COEF = tuple(F32((-1) ** k / np.prod(np.arange(2, 2 * k + 2)))
                 for k in (5, 4, 3, 2, 1))     # S11, S9, S7, S5, S3
UNIFORM_LSF = (np.arange(1, 11).astype(F32) / F32(11)) * PI

# the interpolation taps of the 3 fractional phases: columns 0-9 read
# history q - i, 10-19 history q + i + 1 (decode_ac_vector's filter)
_FLAT = np.asarray(T.INTERP_FILTER).reshape(-1)
INTERP_COEF = np.array([[_FLAT[3 * i + f] for i in range(10)] +
                        [_FLAT[3 * i + 3 - f] for i in range(10)]
                        for f in range(3)], F32)
# each upsampled position's 20 history indices (0..153), clamped: taps
# past the history's end read its last sample (the JAX package's search
# approximation for lags under 10; the chosen lag is decoded exactly)
UWIN = np.clip(np.concatenate(
    [np.arange(-UPS_LEN, 0)[:, None] - np.arange(10)[None, :],
     np.arange(-UPS_LEN, 0)[:, None] + np.arange(10)[None, :] + 1], 1)
    + HIST_SPAN, 0, HIST_SPAN - 1).astype(np.int32)        # [144, 20]


def _cand_grid():
    """Every (integer lag, fraction) pair: lags 20..143, fractions -1, 0,
    1 (372 candidates), each one's 40 indices into the upsampled history
    [3 * 144] (a lag under 40 repeats its period), and whether subframe 1
    may code it (fractions only up to lag 84, and not (20, -1))."""
    t = np.repeat(np.arange(PITCH_MIN, PITCH_MAX + 1), 3)
    f = np.tile(np.array([-1, 0, 1]), PITCH_MAX - PITCH_MIN + 1)
    n = np.arange(SUBFRAME)
    fp = np.where(f > 0, 2, -f)               # -f, wrapped into 0..2
    ti = np.where(f > 0, t + 1, t)
    q = n[None, :] - ti[:, None]
    q = np.where(q >= 0, q - ti[:, None], q)
    idx = fp[:, None] * UPS_LEN + q + UPS_LEN
    valid1 = ((f == 0) | (t <= 84)) & ~((t == PITCH_MIN) & (f == -1))
    return (t.astype(np.int32), f.astype(np.int32), idx.astype(np.int32),
            valid1)


CAND_T, CAND_F, CAND_IDX, CAND_VALID1 = _cand_grid()

# ACELP tracks: positions of tracks 0-2 (8 each) and track 3 (16)
TRACKS = (np.arange(0, SUBFRAME, 5), np.arange(1, SUBFRAME, 5),
          np.arange(2, SUBFRAME, 5),
          np.concatenate([np.arange(3, SUBFRAME, 5),
                          np.arange(4, SUBFRAME, 5)]))
# the 128 gain pairs c = 16 ga + gb: the pitch gain and the code gain's
# codebook sum
GP128 = np.array([int(T.CB_GA[c // 16][0]) + int(T.CB_GB[c % 16][0])
                  for c in range(128)], np.int32)
CB1SUM = np.array([int(T.CB_GA[c // 16][1]) + int(T.CB_GB[c % 16][1])
                   for c in range(128)], np.int32)

_CONST = {}


def _c(name: str, dev) -> torch.Tensor:
    """A module-level array as a tensor on dev, made once per device."""
    key = (name, device_key(dev))
    if key not in _CONST:
        _CONST[key] = torch.as_tensor(globals()[name], device=dev)
    return _CONST[key]


def _dot(a, b):
    """sum_n a[..., n] b[..., n], sequentially from 0.0."""
    acc = torch.zeros(a.shape[:-1], dtype=torch.float32, device=a.device)
    for n in range(a.shape[-1]):
        acc = acc + a[..., n] * b[..., n]
    return acc


def _conv(h, x):
    """y[..., n] = sum_{k <= n} h[n - k] x[..., k], k ascending from 0.0:
    the zero-state response of the filter with impulse response h [B, 40]
    to x [B, ..., 40]."""
    hb = h.reshape(h.shape[:1] + (1,) * (x.dim() - 2) + h.shape[1:])
    y = torch.zeros_like(x)
    for k in range(SUBFRAME):
        y[..., k:] = y[..., k:] + x[..., k:k + 1] * hb[..., :SUBFRAME - k]
    return y


def _cos5(w):
    """cos(k w) for k = 1..5 (w in [0, pi], float32) -> [..., 5]: cos w as
    -sin(w - pi/2) by the polynomial of SIN_COEF, then the Chebyshev
    recurrence T_k+1 = 2 c T_k - T_k-1.  Kernel K evaluates the same
    operations."""
    u = w - HALF_PI
    u2 = u * u
    s = torch.full_like(u, float(SIN_COEF[0]))
    for c in SIN_COEF[1:]:
        s = s * u2 + float(c)
    c1 = -((s * u2 + 1.0) * u)
    out = [c1, 2.0 * c1 * c1 - 1.0]
    for _ in range(3):
        out.append(2.0 * c1 * out[-1] - out[-2])
    return torch.stack(out, -1)


def _cheb_value(c5, mid, cosk):
    """mid + 2 sum_k c5[k] cos((k+1) w), the sum from c5[0] on."""
    s = c5[..., 0] * cosk[..., 0]
    for k in range(1, 5):
        s = s + c5[..., k] * cosk[..., k]
    return mid + 2.0 * s


# ---------------------------------------------------------------- analysis

def autocorrelation(buf):
    """buf [B, 240] float32 -> r [B, 11] of the windowed buffer, lag
    windowed, r[0] conditioned (+0.01%, +10)."""
    w = buf * _c("WLP", buf.device)
    wpad = torch.cat([w, torch.zeros_like(w[:, :10])], 1)
    r = torch.zeros((buf.shape[0], 11), dtype=torch.float32,
                    device=buf.device)
    for n in range(240):
        r = r + w[:, n:n + 1] * wpad[:, n:n + 11]
    r0 = torch.clamp(r[:, 0] * float(F32(1.0001)) + 10.0, min=1e-3)
    r = torch.cat([r0[:, None], r[:, 1:]], 1)
    return r * _c("LAG_WINDOW", buf.device)


def levinson(r):
    """r [B, 11] -> a [B, 11] (a[:, 0] = 1): JAX's `_levinson_batch`."""
    a = [torch.ones_like(r[:, 0])] + [torch.zeros_like(r[:, 0])] * 10
    err = r[:, 0]
    for i in range(1, 11):
        acc = r[:, i]
        for j in range(1, i):
            acc = acc + a[j] * r[:, i - j]
        pos = err > 0
        k = torch.where(pos, -acc / torch.where(pos, err, 1.0), 0.0)
        a = [a[0]] + [a[j] + k * a[i - j] if j <= i else a[j]
                      for j in range(1, 11)]
        err = torch.clamp(err * (1.0 - k * k), min=float(F32(1e-6)))
    return torch.stack(a, 1)


def chebyshev_roots(c5, mid):
    """The first 5 roots in (0, pi) of mid + 2 sum_k c5[:, k-1] cos(k w)
    (c5 [B, 5], mid [B]) -> (roots [B, 5], found [B]): the sign changes
    over a grid of 512 points, then 12 bisection steps each."""
    dev = c5.device
    grid = torch.arange(N_GRID, dtype=torch.float32, device=dev) * \
        float(PI_511)
    cosg = _cos5(grid)                                     # [512, 5]
    vals = _cheb_value(c5[:, None, :], mid[:, None], cosg[None])
    change = vals[:, :-1] * vals[:, 1:] < 0                # [B, 511]
    csum = torch.cumsum(change.to(torch.int32), 1)
    idx = torch.stack([(change & (csum == k)).to(torch.uint8).argmax(1)
                       for k in range(1, 6)], 1)           # [B, 5]
    found = csum[:, -1] >= 5
    lo, hi = grid[idx], grid[idx + 1]
    flo = vals.gather(1, idx)
    for _ in range(BISECT):
        mw = 0.5 * (lo + hi)
        fm = _cheb_value(c5[:, None, :], mid[:, None], _cos5(mw))
        take_hi = flo * fm <= 0
        hi = torch.where(take_hi, mw, hi)
        lo = torch.where(take_hi, lo, mw)
        flo = torch.where(take_hi, flo, fm)
    return 0.5 * (lo + hi), found


def lp_to_lsf(a):
    """a [B, 11] -> LSF [B, 10] ascending radians (uniform spacing where
    either polynomial shows fewer than 5 roots)."""
    z = torch.zeros_like(a[:, :1])
    rev = a.flip(1)
    p = torch.cat([a, z], 1) + torch.cat([z, rev], 1)
    q = torch.cat([a, z], 1) - torch.cat([z, rev], 1)
    pd, qd = [p[:, 0]], [q[:, 0]]
    for i in range(1, 11):
        pd.append(p[:, i] - pd[-1])
        qd.append(q[:, i] + qd[-1])
    rp, okp = chebyshev_roots(torch.stack(pd[4::-1], 1), pd[5])
    rq, okq = chebyshev_roots(torch.stack(qd[4::-1], 1), qd[5])
    lsf = torch.sort(torch.cat([rp, rq], 1), 1).values
    return torch.where((okp & okq)[:, None], lsf,
                       _c("UNIFORM_LSF", a.device)[None])


def quantize_lsf(st, lsf):
    """LSF [B, 10] radians -> (L0, L1, L2, L3) int32 [B]: for each MA
    predictor, the 8 nearest first-stage codewords (L1 distance to the
    float target, ties to the lower index), each one's nearest second
    stage halves (squared distance), then the exact integer
    reconstruction's error; the least error wins (first on ties, L0 = 0
    before 1)."""
    dev = lsf.device
    target = torch.round(torch.clamp(lsf * 8192.0, 40.0, 25681.0)).int()
    cb1 = G._tab("CB_L1", dev)
    cb23 = G._tab("CB_L2_L3", dev)
    b = lsf.shape[0]
    rows = torch.arange(b, device=dev)
    best = best_err = None
    for l0 in (0, 1):
        msum = G._tab("MA_PREDICTOR_SUM", dev)[l0]
        mp = G._tab("MA_PREDICTOR", dev)[l0]
        pred = (st["lq_prev"] * mp[None]).sum(1, dtype=torch.int32)
        lq_t = (target.float() * 32768.0 - pred.float()) / msum.float()
        d1 = torch.zeros((b, 128), dtype=torch.float32, device=dev)
        for i in range(10):
            d1 = d1 + (cb1[None, :, i].float() - lq_t[:, i:i + 1]).abs()
        # the 8 least, ascending, ties to the lower index
        l1c = torch.sort(d1, dim=1, stable=True).indices[:, :8]
        c1 = cb1[l1c]                                      # [B, 8, 10]
        resid = lq_t[:, None, :] - c1.float()
        d2 = torch.zeros((b, 8, 32), dtype=torch.float32, device=dev)
        d3 = torch.zeros_like(d2)
        for i in range(5):
            e = cb23[None, None, :, i].float() - resid[:, :, i:i + 1]
            d2 = d2 + e * e
            e = cb23[None, None, :, 5 + i].float() - resid[:, :, 5 + i:6 + i]
            d3 = d3 + e * e
        l2c, l3c = d2.argmin(2), d3.argmin(2)
        lq = torch.cat([c1[..., :5] + cb23[l2c][..., :5],
                        c1[..., 5:] + cb23[l3c][..., 5:]], 2)
        cols = list(lq.unbind(2))
        for j in (10, 5):
            for i in range(1, 10):
                diff = (cols[i - 1] - cols[i] + j) >> 1
                pos = diff > 0
                cols[i - 1] = torch.where(pos, cols[i - 1] - diff,
                                          cols[i - 1])
                cols[i] = torch.where(pos, cols[i] + diff, cols[i])
        rec = (torch.stack(cols, 2) * msum + pred[:, None, :]) >> 15
        err = ((rec - target[:, None, :]) ** 2).sum(2, dtype=torch.int32)
        ebest, kbest = err.min(1)
        cand = (torch.full_like(target[:, 0], l0), l1c[rows, kbest].int(),
                l2c[rows, kbest].int(), l3c[rows, kbest].int())
        if best is None:
            best, best_err = cand, ebest
        else:
            tk = ebest < best_err
            best = tuple(torch.where(tk, c, o) for c, o in zip(cand, best))
    return best


def impulse_response(lp):
    """lp [B, 10] Q12 -> h [B, 40] float32, the impulse response of
    1/A(z)."""
    a = lp.float() / 4096.0
    h = [torch.ones_like(a[:, 0])]
    for n in range(1, SUBFRAME):
        acc = torch.zeros_like(a[:, 0])
        for i in range(min(10, n)):
            acc = acc + a[:, i] * h[n - 1 - i]
        h.append(-acc)
    return torch.stack(h, 1)


def zero_input_response(lp, syn_filter_data):
    """[B, 40] float32: 1/A(z) run on from its memory (oldest first)."""
    a = lp.float() / 4096.0
    hist = list(syn_filter_data.float().unbind(1))
    out = []
    for _ in range(SUBFRAME):
        acc = torch.zeros_like(a[:, 0])
        for i in range(10):
            acc = acc + a[:, i] * hist[9 - i]
        s = -acc
        out.append(s)
        hist = hist[1:] + [s]
    return torch.stack(out, 1)


def upsampled_history(exc, off: int):
    """The adaptive codebook's interpolation at its 3 phases over the
    last 144 positions before the subframe: exc [B, EXC_LEN] int32 ->
    [B, 3 * 144] float32."""
    base = G.EXC_OFF + off
    hist = exc[:, base - HIST_SPAN:base].float()
    taps = hist[:, torch.as_tensor(UWIN, device=exc.device).long()]
    coef = _c("INTERP_COEF", exc.device)                # [3, 20]
    u = torch.zeros((exc.shape[0], 3, UPS_LEN), dtype=torch.float32,
                    device=exc.device)
    for k in range(20):
        u = u + taps[:, None, :, k] * coef[None, :, k:k + 1]
    return (u / 16384.0).reshape(exc.shape[0], 3 * UPS_LEN)


def pitch_search(h, target, exc, off: int, valid):
    """The closed-loop pitch over the whole (lag, fraction) grid: each
    candidate's vector through h, scored (y.t)^2 / y.y (y.t at least 0;
    invalid or zero-energy candidates -1) -> the first best index [B]."""
    u = upsampled_history(exc, off)
    acv = u[:, torch.as_tensor(CAND_IDX, device=exc.device).long()]
    y = _conv(h, acv)                                    # [B, 372, 40]
    e = _dot(y, y)
    c = torch.clamp(_dot(y, target[:, None, :]), min=0.0)
    ok = valid & (e > 0)
    score = torch.where(ok, c * c / torch.clamp(e, min=1e-9), -1.0)
    return score.argmax(1)


def fc_search(r, h2):
    """The joint ACELP search over all 8 x 8 x 8 x 16 track positions
    (signs preset from d = H2' r) maximising (sum |d|)^2 / c'Phi c ->
    (fc_index, signs) int32 [B]."""
    dev = r.device
    b = r.shape[0]
    d = torch.stack([_dot(h2[:, :SUBFRAME - k], r[:, k:])
                     for k in range(SUBFRAME)], 1)
    phi = torch.zeros((b, SUBFRAME, SUBFRAME), dtype=torch.float32,
                      device=dev)
    kk = torch.arange(SUBFRAME, device=dev)
    lo = torch.maximum(kk[:, None], kk[None, :])
    for m in range(SUBFRAME):
        live = lo <= m
        hk = h2[:, (m - kk).clamp(min=0)]                  # h2[m - k]
        phi = phi + torch.where(live[None], hk[:, :, None] * hk[:, None, :],
                                0.0)
    sgn = torch.where(d >= 0, 1.0, -1.0)
    dabs = d.abs()
    phs = phi * sgn[:, :, None] * sgn[:, None, :]
    t0, t1, t2, t3 = (torch.as_tensor(t, device=dev) for t in TRACKS)

    def dg(t):
        return phs[:, t, t]

    def cr(ta, tb):
        return phs[:, ta[:, None], tb[None, :]]

    num = (((dabs[:, t0][:, :, None, None, None]
             + dabs[:, t1][:, None, :, None, None])
            + dabs[:, t2][:, None, None, :, None])
           + dabs[:, t3][:, None, None, None, :])
    den_d = (((dg(t0)[:, :, None, None, None] + dg(t1)[:, None, :, None, None])
              + dg(t2)[:, None, None, :, None])
             + dg(t3)[:, None, None, None, :])
    den_c = (((((cr(t0, t1)[:, :, :, None, None]
                 + cr(t0, t2)[:, :, None, :, None])
                + cr(t0, t3)[:, :, None, None, :])
               + cr(t1, t2)[:, None, :, :, None])
              + cr(t1, t3)[:, None, :, None, :])
             + cr(t2, t3)[:, None, None, :, :])
    den = den_d + 2.0 * den_c
    score = (num * num) / torch.clamp(den, min=1e-9)
    kf = score.reshape(b, -1).argmax(1).int()
    k3, k2, k1, k0 = kf % 16, (kf // 16) % 8, (kf // 128) % 8, kf // 1024
    fc_idx = k0 | (k1 << 3) | (k2 << 6) | ((k3 % 8) << 10) | ((k3 // 8) << 9)
    pos = (t0[k0.long()], t1[k1.long()], t2[k2.long()], t3[k3.long()])
    rows = torch.arange(b, device=dev)
    signs = torch.zeros_like(fc_idx)
    for t, p in enumerate(pos):
        signs = signs | ((sgn[rows, p] > 0).int() << t)
    return fc_idx, signs


def gain_codes(st, fc):
    """The decoder's code gain (`g729a.get_gain_code`) of each of the 128
    (ga, gb) pairs, exact: fc [B, 40] int32 -> int32 [B, 128]."""
    dev = fc.device
    energy = (fc * fc).sum(1, dtype=torch.int32)
    e = G._mul_sh15(G.l_log2(torch.clamp(energy, min=1)), -24660)
    e = e + ((R.l_log2(SUBFRAME) * 24660) >> 15) + 0xD8888 - 2
    e = e << 10
    e = e + (st["pred_energ_q"] * G._tab("MA_PREDICTION_COEFF", dev)).sum(
        1, dtype=torch.int32)
    e = (5439 * (e >> 15)) >> 8
    expn = (e >> 15)[:, None]
    emant = (G.l_pow2(e & 0x7FFF) & 0x7FFF)[:, None]
    prod = emant * (_c("CB1SUM", dev)[None] >> 1)
    pos = 25 - expn > 0
    return G._i16(torch.where(pos, prod >> torch.where(pos, 25 - expn, 0),
                              prod << torch.where(pos, 0, expn - 25)))


def gain_search(st, fc, y_ac, y_fc, target):
    """The (ga, gb) pair whose gains, the pitch gain's codebook value and
    the exact code gain, leave the least squared error (first on ties)
    -> ga, gb int32 [B]."""
    gp = _c("GP128", fc.device).float() / 16384.0
    gcf = gain_codes(st, fc).float() / 16384.0
    t_ya, t_yf = _dot(target, y_ac)[:, None], _dot(target, y_fc)[:, None]
    ya2, yf2 = _dot(y_ac, y_ac)[:, None], _dot(y_fc, y_fc)[:, None]
    yayf = _dot(y_ac, y_fc)[:, None]
    err = ((((-2.0 * gp) * t_ya - (2.0 * gcf) * t_yf) + (gp * gp) * ya2)
           + ((2.0 * gp) * gcf) * yayf) + (gcf * gcf) * yf2
    c = err.argmin(1).int()
    return c // 16, c % 16


def parity(p1):
    """The parity bit P0 that makes the decoder's check of P1 pass."""
    word = torch.where(p1 >> 2 >= 32, G.PARITY_HI, G.PARITY_LO).long()
    return ((((word >> ((p1 >> 2) & 31).long()) & 1).int()) ^ 1) & 1


# ------------------------------------------------------------ frame step

def encode_frame_batch(st: dict, hist: torch.Tensor, samples: torch.Tensor):
    """One 80-sample frame of B streams: st (the shadow decoder state of
    `g729a.init_state`), hist [B, 160] float32 (the past input, scaled),
    samples [B, 80] (int-valued) -> (st, hist, parm int32 [B, 16]) in
    `g729a.PARM_FIELDS` order (the erasure column 0).  The plain version
    of kernel K; st is not modified."""
    st = dict(st)
    dev = samples.device
    b = samples.shape[0]
    x = samples.float() * 0.5           # the decoder's output doubles it
    buf = torch.cat([hist, x], 1)[:, -240:]
    lsf = lp_to_lsf(levinson(autocorrelation(buf)))
    l0, l1, l2, l3 = quantize_lsf(st, lsf)
    lp1, lp2 = G.lp_decode(st, G.lsf2lsp(G.lsf_decode(st, l0, l1, l2, l3)))
    cand_t = _c("CAND_T", dev)
    cand_f = _c("CAND_F", dev)
    cols = {}
    prev_int = None
    for i, lp in enumerate((lp1, lp2)):
        off = i * SUBFRAME
        h = impulse_response(lp)
        target = x[:, off:off + SUBFRAME] - \
            zero_input_response(lp, st["syn_filter_data"])
        if i == 0:
            valid = _c("CAND_VALID1", dev)[None].expand(b, -1)
        else:
            base = torch.clamp(prev_int - 5, PITCH_MIN, PITCH_MAX - 9)
            valid = (cand_t[None] >= base[:, None]) & \
                (cand_t[None] <= base[:, None] + 9)
        k = pitch_search(h, target, st["exc"], off, valid)
        t_int, t_frac = cand_t[k], cand_f[k]
        if i == 0:
            p1 = torch.where(t_int <= 84, 3 * t_int + t_frac - 58,
                             t_int + 112)
            cols["ac0"], cols["parity"] = p1, parity(p1)
            prev_int = t_int
        else:
            cols["ac1"] = 3 * (t_int - base) + t_frac + 2
        # the chosen vector, exact, through the shadow decoder
        st["exc"] = G.decode_ac_vector(st["exc"], t_int, t_frac, off)
        a = G.EXC_OFF + off
        y_ac = _conv(h, st["exc"][:, a:a + SUBFRAME].float())
        gp_f = torch.clamp(_dot(y_ac, target) /
                           torch.clamp(_dot(y_ac, y_ac), min=1e-9), 0.0, 1.2)
        # the impulse response sharpened at the lag: h2[n] = h[n] +
        # gp_sh h[n - t] (n - t < 20 <= t is never itself sharpened)
        gp_sh = st["pitch_sharp"].float() / 16384.0
        n = torch.arange(SUBFRAME, device=dev)
        back = h.gather(1, (n[None] - t_int[:, None]).clamp(min=0).long())
        h2 = h + gp_sh[:, None] * torch.where(n[None] >= t_int[:, None],
                                              back, 0.0)
        fc_idx, signs = fc_search(target - gp_f[:, None] * y_ac, h2)
        cols[f"fc{i}"], cols[f"ps{i}"] = fc_idx, signs
        fc, _ = G.decode_fc_vector(fc_idx, signs)
        fc = G.fix_fc_vector(fc, t_int, st["pitch_sharp"])
        y_fc = _conv(h, fc.float())
        ga, gb = gain_search(st, fc, y_ac, y_fc, target)
        cols[f"ga{i}"], cols[f"gb{i}"] = ga, gb
        # the state update, as the decoder makes it
        gc = G.get_gain_code(st, ga, gb, fc)
        gp = G._tab("CB_GA", dev)[ga.long(), 0] + \
            G._tab("CB_GB", dev)[gb.long(), 0]
        st["gain_pitch"], st["gain_code"] = gp, gc
        st["pitch_sharp"] = torch.clamp(gp, G.SHARP_MIN, G.SHARP_MAX)
        st["exc"] = G.mem_update(st["exc"], fc, gp, gc, off)
        out1, fd1, ovf = G.lp_synthesis_filter(
            lp, st["exc"][:, a:a + SUBFRAME], st["syn_filter_data"], False)
        if bool(ovf.any()):
            exc = torch.where(ovf[:, None], st["exc"] >> 2, st["exc"])
            _, fd2, _ = G.lp_synthesis_filter(
                lp, exc[:, a:a + SUBFRAME], st["syn_filter_data"], True)
            st["exc"] = exc
            fd1 = torch.where(ovf[:, None], fd2, fd1)
        st["syn_filter_data"] = fd1
        st["pitch_prev"] = t_int
    exc = st["exc"].clone()
    exc[:, :G.EXC_OFF] = st["exc"][:, 2 * SUBFRAME:2 * SUBFRAME + G.EXC_OFF]
    st["exc"] = exc
    hist = torch.cat([hist, x], 1)[:, -160:]
    parm = torch.stack([l0, l1, l2, l3, cols["parity"], cols["ac0"],
                        cols["ac1"], cols["fc0"], cols["fc1"], cols["ps0"],
                        cols["ps1"], cols["ga0"], cols["ga1"], cols["gb0"],
                        cols["gb1"], torch.zeros_like(l0)], 1)
    return st, hist, parm.int()


def encode_frames_scan(st: dict, hist: torch.Tensor, frames: torch.Tensor):
    """T frames of B streams: frames [T, B, 80] -> (st, hist, parms int32
    [T, B, 16]).  CPU tensors run the plain frame step T times; CUDA
    tensors launch kernel K once for all T."""
    tensors = [hist, frames, *st.values()]
    if all(t.device.type == "cpu" for t in tensors):
        parms = torch.empty((frames.shape[0], frames.shape[1], 16),
                            dtype=torch.int32)
        for t in range(frames.shape[0]):
            st, hist, parms[t] = encode_frame_batch(st, hist, frames[t])
        return st, hist, parms
    from ..kernels import g729
    return g729.encode_frames(st, hist, frames)


# (parm column, bit width) in the frame's bit order
_PACK = [(0, 1), (1, 7), (2, 5), (3, 5), (5, 8), (4, 1), (7, 13), (9, 4),
         (11, 3), (13, 4), (6, 5), (8, 13), (10, 4), (12, 3), (14, 4)]


def pack_frames(parms: torch.Tensor) -> torch.Tensor:
    """Parameters int32 [..., 16] -> packed 80-bit frames uint8 [..., 10]
    on their device (`g729a_encoder.pack_parameters_batch`)."""
    bits = [(parms[..., col:col + 1] >> torch.arange(
        n - 1, -1, -1, device=parms.device)) & 1 for col, n in _PACK]
    bits = torch.cat(bits, -1).reshape(parms.shape[:-1] + (10, 8))
    w = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                     device=parms.device)
    return (bits * w).sum(-1).to(torch.uint8)


def encode_streams(pcm) -> torch.Tensor:
    """PCM int16 [B, n*80] (a tensor, or an array for the CPU) -> packed
    frames uint8 [n, B, 10] on the PCM's device: B independent streams,
    each from the initial state, all n frames in one encode_frames_scan."""
    if not isinstance(pcm, torch.Tensor):
        pcm = torch.from_numpy(np.asarray(pcm, np.int16))
    if pcm.dim() == 1:
        pcm = pcm[None]
    b, n = pcm.shape[0], pcm.shape[1] // FRAME
    frames = pcm[:, :n * FRAME].float().reshape(b, n, FRAME) \
        .permute(1, 0, 2).contiguous()
    st = G.init_state(b, device=pcm.device)
    hist = torch.zeros((b, 160), dtype=torch.float32, device=pcm.device)
    _, _, parms = encode_frames_scan(st, hist, frames)
    return pack_frames(parms)
