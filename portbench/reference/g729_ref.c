/*
 * Plain G.729 Annex A decoder (fixed point, one stream, one frame at a
 * time): the benchmark's reference for every G.729A decode cell.
 *
 * Frozen from the scalar Python decoder amv_tpu_torch/verify/ref_g729.py,
 * itself a reimplementation of the ITU reference decoder's native
 * fixed-point path (G.729/g729a_native.c:804-1927; libavcodec g729dec.c,
 * g729postfilter.c, lsp.c, celp_math.c): the 80-bit unpack, the two-stage
 * LSF VQ with switched MA prediction, LSF -> LSP -> LP, the 1/3-fractional
 * adaptive codebook, the 4-pulse fixed codebook, the gain VQ with MA
 * energy prediction, LP synthesis with its overflow redo, the Annex A
 * postfilter and the 100 Hz high-pass, and the erasure concealment.
 * Every intermediate is an int64 and every C int32 wrap of the reference
 * is written out (w32), so the arithmetic is Python's on the same values.
 *
 * Build: gcc -O2 -fPIC -shared -o libpb_g729.so g729_ref.c
 * Entry: pb_g729_decode(frames [n][10], n, pcm [n * 80]) -> 0, or the
 * number of frames decoded before a step the reference leaves undefined
 * (a log of zero, a division by zero) plus one, negated.
 */

#include <stdint.h>
#include <string.h>

#include "g729_tables.h"

#define SUBFRAME 40
#define PITCH_MIN 20
#define PITCH_MAX 143
#define INTERPOL_LEN 11
#define SHARP_MIN 3277
#define SHARP_MAX 13017
#define GAMMA_N 18022
#define GAMMA_D 22938
#define GAMMA_T 26214
#define GAMMA_P 16384
#define LSFQ_MIN 40
#define LSFQ_MAX 25681
#define LSFQ_DIFF_MIN 321
#define EXC_LEN (2 * 44 + PITCH_MAX + 2 * INTERPOL_LEN)
#define EXC_OFF (PITCH_MAX + INTERPOL_LEN)
#define RES_LEN (44 + PITCH_MAX)
#define I32_MIN (-2147483648LL)
#define I32_MAX 2147483647LL

typedef int64_t i64;

typedef struct {
    i64 exc[EXC_LEN];
    i64 pitch_delay_int_prev;
    i64 lq_prev[4][10];
    i64 lsp_prev[10];
    i64 lsf_prev[10];
    i64 pred_energ_q[4];
    i64 gain_pitch, gain_code, pitch_sharp;
    i64 residual[RES_LEN];
    i64 syn_filter_data[10], res_filter_data[10], pos_filter_data[10];
    i64 ht_prev_data, gain_coeff, rand_value, prev_mode;
    i64 hpf_f[3], hpf_z[3];
    int data_error, bad_pitch;
    int fault;           /* a step the reference leaves undefined was hit */
} Dec;

static i64 i16(i64 x) { return (i64)(int16_t)(uint16_t)((uint64_t)x & 0xFFFF); }
static i64 w32(i64 x) { return (i64)(int32_t)(uint32_t)((uint64_t)x & 0xFFFFFFFFu); }
static i64 clip(i64 x, i64 lo, i64 hi) { return x < lo ? lo : (x > hi ? hi : x); }
static i64 imin(i64 a, i64 b) { return a < b ? a : b; }
static i64 imax(i64 a, i64 b) { return a > b ? a : b; }
/* Python's floor division (the divisor is positive wherever it is used) */
static i64 floordiv(i64 a, i64 b) {
    i64 q = a / b;
    if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
    return q;
}

static int av_log2(Dec *d, i64 v) {
    if (v <= 0) { d->fault = 1; return 0; }
    int n = 0;
    while (v >>= 1) n++;
    return n;
}

static i64 mul_24_15(i64 a, i64 b) { return (a * b) >> 15; }

static i64 g729_round(i64 v) {
    if (v > I32_MAX - 0x8000) return 32767;
    return (v + 0x8000) >> 16;
}

static i64 l_pow2(i64 power) {
    i64 frac_x0 = (power & 0x7C00) >> 10;
    i64 frac_dx = (power & 0x03FF) << 5;
    i64 result = (i64)TAB_POW2[frac_x0] << 15;
    result += frac_dx * (TAB_POW2[frac_x0 + 1] - TAB_POW2[frac_x0]);
    return (result + 16384) >> 15;
}

static i64 l_log2(Dec *d, i64 value) {
    if (value <= 0) { d->fault = 1; return 0; }
    int power_int = av_log2(d, value);
    i64 result = (i64)(((uint64_t)value << (31 - power_int)) & 0xFFFFFFFFu);
    i64 frac_x0 = (result & 0x7C000000) >> 26;
    i64 frac_dx = (result & 0x03FFF800) >> 11;
    i64 r = (i64)TAB_LOG2[frac_x0] << 15;
    r += frac_dx * (TAB_LOG2[frac_x0 + 1] - TAB_LOG2[frac_x0]);
    return ((i64)power_int << 15) + (r >> 15);
}

static i64 l_inv_sqrt(Dec *d, i64 arg) {
    if (arg <= 0) { d->fault = 1; return 0; }
    int power_int = (av_log2(d, arg) >> 1) + 1;
    i64 result = (i64)(((uint64_t)arg << (32 - (power_int << 1))) & 0xFFFFFFFFu);
    i64 frac_x0 = (result >> 26) - 16;
    i64 frac_dx = (result >> 11) & 0x7FE0;
    i64 r = (i64)TAB_INV_SQRT[frac_x0] << 15;
    r += frac_dx * (TAB_INV_SQRT[frac_x0 + 1] - TAB_INV_SQRT[frac_x0]);
    return r >> power_int;
}

static i64 l_div(Dec *d, i64 num, i64 denom, i64 base) {
    if (!num) return 0;
    int sig = (num < 0) != (denom < 0);
    num = num < 0 ? -num : num;
    denom = denom < 0 ? -denom : denom;
    i64 diff = 26 - av_log2(d, num);
    /* x86 semantics: shift counts masked to 5 bits */
    num = w32((i64)((uint64_t)num << (imin(base, diff) & 31)));
    denom >>= (imax(base, diff) - diff) & 31;
    if (!denom) { d->fault = 1; return 0; }
    i64 q = floordiv(num, denom);
    return sig ? -q : q;
}

static i64 g729_random(i64 value) { return (31821 * value + 13849) & 0xFFFF; }

static int parity_check(i64 p1, i64 p0) {
    return (int)(((0x6996966996696996ULL >> (p1 >> 2)) ^ (uint64_t)p0) & 1);
}

typedef struct {
    i64 ma_predictor, quantizer_1st, quantizer_2nd_lo, quantizer_2nd_hi;
    i64 parity, ac_index[2], fc_indexes[2], pulses_signs[2];
    i64 ga_cb_index[2], gb_cb_index[2];
} Parm;

static i64 get_bits(const uint8_t *buf, int *pos, int n) {
    i64 v = 0;
    for (int k = 0; k < n; k++, (*pos)++)
        v = (v << 1) | ((buf[*pos >> 3] >> (7 - (*pos & 7))) & 1);
    return v;
}

/* the 80-bit unpack; returns 1 for an erasure (all ten bytes zero) */
static int bytes2parm(const uint8_t *buf, Parm *p) {
    memset(p, 0, sizeof(*p));
    int any = 0;
    for (int i = 0; i < 10; i++) any |= buf[i];
    if (!any) return 1;
    int pos = 0;
    p->ma_predictor = get_bits(buf, &pos, 1);
    p->quantizer_1st = get_bits(buf, &pos, 7);
    p->quantizer_2nd_lo = get_bits(buf, &pos, 5);
    p->quantizer_2nd_hi = get_bits(buf, &pos, 5);
    p->ac_index[0] = get_bits(buf, &pos, 8);
    p->parity = get_bits(buf, &pos, 1);
    p->fc_indexes[0] = get_bits(buf, &pos, 13);
    p->pulses_signs[0] = get_bits(buf, &pos, 4);
    p->ga_cb_index[0] = get_bits(buf, &pos, 3);
    p->gb_cb_index[0] = get_bits(buf, &pos, 4);
    p->ac_index[1] = get_bits(buf, &pos, 5);
    p->fc_indexes[1] = get_bits(buf, &pos, 13);
    p->pulses_signs[1] = get_bits(buf, &pos, 4);
    p->ga_cb_index[1] = get_bits(buf, &pos, 3);
    p->gb_cb_index[1] = get_bits(buf, &pos, 4);
    return 0;
}

static void dec_init(Dec *d) {
    memset(d, 0, sizeof(*d));
    for (int k = 0; k < 4; k++)
        for (int i = 0; i < 10; i++) d->lq_prev[k][i] = LQ_INIT[i];
    for (int i = 0; i < 10; i++) d->lsp_prev[i] = LSP_INIT[i];
    for (int i = 0; i < 4; i++) d->pred_energ_q[i] = -14336;
    d->pitch_sharp = SHARP_MIN;
    d->gain_coeff = 4096;
    d->rand_value = 21845;
}

/* ---- LSF / LSP / LP ---------------------------------------------------- */

static void lq_rotate(Dec *d, const i64 *lq) {
    for (int i = 0; i < 10; i++) {
        for (int k = 3; k > 0; k--) d->lq_prev[k][i] = d->lq_prev[k - 1][i];
        d->lq_prev[0][i] = lq[i];
    }
}

static void lsf_restore_from_previous(Dec *d, i64 *lsfq) {
    i64 lq[10];
    for (int i = 0; i < 10; i++) {
        lsfq[i] = d->lsf_prev[i];
        i64 v = lsfq[i] * 32768;
        for (int k = 0; k < 4; k++)
            v -= d->lq_prev[k][i] * MA_PREDICTOR[d->prev_mode][k][i];
        lq[i] = ((v >> 15) * MA_PREDICTOR_SUM_INV[d->prev_mode][i]) >> 12;
    }
    lq_rotate(d, lq);
}

static void lsf_decode(Dec *d, i64 l0, i64 l1, i64 l2, i64 l3, i64 *lsfq) {
    i64 lq[10];
    for (int i = 0; i < 5; i++) {
        lq[i] = CB_L1[l1][i] + CB_L2_L3[l2][i];
        lq[i + 5] = CB_L1[l1][i + 5] + CB_L2_L3[l3][i + 5];
    }
    static const int js[2] = {10, 5};
    for (int jj = 0; jj < 2; jj++)
        for (int i = 1; i < 10; i++) {
            i64 diff = (lq[i - 1] - lq[i] + js[jj]) >> 1;
            if (diff > 0) { lq[i - 1] -= diff; lq[i] += diff; }
        }
    for (int i = 0; i < 10; i++) {
        i64 s = lq[i] * MA_PREDICTOR_SUM[l0][i];
        for (int k = 0; k < 4; k++) s += d->lq_prev[k][i] * MA_PREDICTOR[l0][k][i];
        lsfq[i] = i16(s >> 15);
        d->lsf_prev[i] = lsfq[i];
    }
    lq_rotate(d, lq);
    d->prev_mode = l0;
    for (int j = 9; j > 0; j--)
        for (int i = 0; i < j; i++)
            if (lsfq[i] > lsfq[i + 1]) { i64 t = lsfq[i]; lsfq[i] = lsfq[i + 1]; lsfq[i + 1] = t; }
    lsfq[0] = imax(lsfq[0], LSFQ_MIN);
    for (int i = 0; i < 9; i++) lsfq[i + 1] = imax(lsfq[i + 1], lsfq[i] + LSFQ_DIFF_MIN);
    lsfq[9] = imin(lsfq[9], LSFQ_MAX);
}

static void lsf2lsp(const i64 *lsf, i64 *lsp) {
    for (int i = 0; i < 10; i++) {
        i64 freq = i16((lsf[i] * 20861) >> 15);
        i64 offset = freq & 0xFF, ind = freq >> 8;
        lsp[i] = i16(BASE_COS[ind] + ((SLOPE_COS[ind] * offset) >> 12));
    }
}

/* lsp_sub: the 5 even or odd LSPs */
static void lsp_poly(const i64 *lsp_sub, i64 *f) {
    f[0] = 1 << 24;
    f[1] = -lsp_sub[0] * 1024;
    for (int i = 2; i < 6; i++) {
        f[i] = f[i - 2];
        for (int j = i; j > 1; j--)
            f[j] -= (mul_24_15(f[j - 1] >> 1, lsp_sub[i - 1]) * 4) - f[j - 2];
        f[1] -= lsp_sub[i - 1] * 1024;
    }
}

static void lsp2lp(const i64 *lsp, i64 *lp) {
    i64 ev[5], od[5], f1[6], f2[6];
    for (int i = 0; i < 5; i++) { ev[i] = lsp[2 * i]; od[i] = lsp[2 * i + 1]; }
    lsp_poly(ev, f1);
    lsp_poly(od, f2);
    for (int i = 0; i < 5; i++) {
        i64 ff1 = f1[i + 1] + f1[i] + (1 << 12);
        i64 ff2 = f2[i + 1] - f2[i];
        lp[i] = i16((ff1 + ff2) >> 13);
        lp[9 - i] = i16((ff1 - ff2) >> 13);
    }
}

static void lp_decode(Dec *d, const i64 *lsp_2nd, i64 *lp) {
    i64 lsp_1st[10];
    for (int i = 0; i < 10; i++) lsp_1st[i] = (lsp_2nd[i] >> 1) + (d->lsp_prev[i] >> 1);
    lsp2lp(lsp_1st, lp);
    lsp2lp(lsp_2nd, lp + 10);
    memcpy(d->lsp_prev, lsp_2nd, sizeof(d->lsp_prev));
}

/* ---- codebooks ----------------------------------------------------------- */

static void decode_ac_vector(Dec *d, i64 pitch_delay_int, i64 pitch_delay_frac, int off) {
    const int32_t *flat = &INTERP_FILTER[0][0];
    i64 frac = -pitch_delay_frac;
    if (frac < 0) { frac += 3; pitch_delay_int += 1; }
    i64 base = EXC_OFF + off;
    i64 *exc = d->exc;
    for (int n = 0; n < SUBFRAME; n++) {
        i64 v = 0;
        for (int i = 0; i < 10; i++) {
            i64 t = exc[base + n - pitch_delay_int - i] * flat[3 * i + frac];
            v = clip(v + t, I32_MIN >> 1, I32_MAX >> 1);
            t = exc[base + n - pitch_delay_int + i + 1] * flat[3 * i + 3 - frac];
            v = clip(v + t, I32_MIN >> 1, I32_MAX >> 1);
        }
        exc[base + n] = g729_round(v * 2);
    }
}

static int decode_fc_vector(i64 fc_index, i64 pulses_signs, i64 *fc) {
    memset(fc, 0, SUBFRAME * sizeof(i64));
    for (int i = 0; i < 3; i++) {
        i64 index = (fc_index & 7) * 5 + i;
        if (index >= SUBFRAME) return 1;
        fc[index] = (pulses_signs & 1) ? 8191 : -8192;
        fc_index >>= 3;
        pulses_signs >>= 1;
    }
    i64 index = ((fc_index >> 1) & 7) * 5 + 3 + (fc_index & 1);
    if (index >= SUBFRAME) return 1;
    fc[index] = (pulses_signs & 1) ? 8191 : -8192;
    return 0;
}

static void fix_fc_vector(Dec *d, i64 pitch_delay, i64 *fc) {
    for (i64 i = pitch_delay; i < SUBFRAME; i++)
        fc[i] = i16(fc[i] + ((fc[i - pitch_delay] * d->pitch_sharp) >> 14));
}

static void update_gain_erasure(Dec *d) {
    i64 *p = d->pred_energ_q;
    i64 avg = p[3];
    for (int i = 3; i > 0; i--) { avg += p[i - 1]; p[i] = p[i - 1]; }
    p[0] = imax((avg >> 2) - 4096, -14336);
}

static i64 get_gain_code(Dec *d, i64 ga, i64 gb, const i64 *fc) {
    i64 energy = 0;
    for (int i = 0; i < SUBFRAME; i++) energy += fc[i] * fc[i];
    energy = w32(energy);
    energy = mul_24_15(l_log2(d, energy), -24660);
    energy += mul_24_15(l_log2(d, SUBFRAME), 24660);
    energy += 0xD8888;
    energy -= 2;
    energy *= 1024;
    for (int i = 0; i < 4; i++) energy += d->pred_energ_q[i] * MA_PREDICTION_COEFF[i];
    energy = w32(energy);
    energy = (5439 * (energy >> 15)) >> 8;
    i64 exp = energy >> 15;
    energy = l_pow2(energy & 0x7FFF) & 0x7FFF;
    for (int i = 3; i > 0; i--) d->pred_energ_q[i] = d->pred_energ_q[i - 1];
    i64 cb1_sum = (i64)CB_GA[ga][1] + CB_GB[gb][1];
    d->pred_energ_q[0] = i16((24660 * ((l_log2(d, cb1_sum) >> 2) - (13 << 13))) >> 15);
    energy *= cb1_sum >> 1;
    if (25 - exp > 0)
        energy >>= 25 - exp;
    else
        energy = (i64)(((uint64_t)energy << (exp - 25)) & 0xFFFFFFFFFFFFULL);
    return i16(energy);
}

static void mem_update(Dec *d, const i64 *fc, i64 gp, i64 gc, int off) {
    i64 base = EXC_OFF + off;
    for (int i = 0; i < SUBFRAME; i++) {
        i64 s = d->exc[base + i] * gp + fc[i] * gc;
        s = clip(s, -32768LL * 16384, 32767LL * 16384);
        d->exc[base + i] = g729_round(s * 4);
    }
}

/* ---- filters -------------------------------------------------------------- */

/* returns 1 on an overflow with exit_on_overflow (out and filter_data
   untouched); else fills out and updates filter_data */
static int lp_synthesis_filter(const i64 *lp, const i64 *in, i64 *filter_data,
                               int exit_on_overflow, i64 *out) {
    i64 tmp[10 + SUBFRAME];
    memcpy(tmp, filter_data, 10 * sizeof(i64));
    for (int n = 0; n < SUBFRAME; n++) {
        i64 s = in[n] * 4096;
        for (int i = 0; i < 10; i++) s -= lp[i] * tmp[10 + n - i - 1];
        s = w32(s) >> 12;
        if (s > 32767 || s < -32768) {
            if (exit_on_overflow) return 1;
            s = clip(s, -32768, 32767);
        }
        tmp[10 + n] = s;
    }
    memcpy(filter_data, tmp + SUBFRAME, 10 * sizeof(i64));
    memcpy(out, tmp + 10, SUBFRAME * sizeof(i64));
    return 0;
}

static void residual_calc(Dec *d, const i64 *lp_gn, const i64 *speech) {
    i64 tmp[10 + SUBFRAME];
    memcpy(tmp, d->pos_filter_data, 10 * sizeof(i64));
    memcpy(tmp + 10, speech, SUBFRAME * sizeof(i64));
    for (int n = 0; n < SUBFRAME; n++) {
        i64 s = tmp[10 + n] * 4096;
        for (int i = 0; i < 10; i++) s += lp_gn[i] * tmp[10 + n - i - 1];
        s = clip(w32(s), -32768LL * 4096, 32767LL * 4096);
        d->residual[n + PITCH_MAX] = g729_round(s * 16);
    }
    memcpy(d->pos_filter_data, speech + SUBFRAME - 10, 10 * sizeof(i64));
}

static void long_term_filter(Dec *d, i64 intT1, i64 *out) {
    const i64 *res = d->residual;
    i64 minT0 = imin(intT1, PITCH_MAX - 3) - 3;
    i64 maxT0 = imin(intT1, PITCH_MAX - 3) + 3;
    i64 intT0 = minT0, corr_max = 0;
    int have = 0;
    for (i64 k = minT0; k <= maxT0; k++) {
        i64 c = 0;
        for (int n = 0; n < SUBFRAME; n++)
            c += (res[PITCH_MAX - k + n] >> 1) * (res[PITCH_MAX + n] >> 1);
        c = w32(c);
        if (!have || c > corr_max) { corr_max = c; intT0 = k; have = 1; }
    }
    i64 corr_t0 = 0, corr_0 = 0;
    for (int n = 0; n < SUBFRAME; n++) {
        i64 a = res[PITCH_MAX - intT0 + n] >> 1, b = res[PITCH_MAX + n] >> 1;
        corr_t0 += a * a;
        corr_0 += b * b;
    }
    corr_t0 = w32(corr_t0);
    corr_0 = w32(corr_0);
    int t = av_log2(d, imax(imax(corr_0, corr_t0), imax(corr_max, 1)));
    if (t > 14) { corr_t0 >>= t - 14; corr_0 >>= t - 14; corr_max >>= t - 14; }
    i64 gl;
    if (w32(corr_max * corr_max) < (w32(corr_0 * corr_t0) >> 1))
        gl = 0;
    else if (!corr_t0 || corr_max > corr_t0)
        gl = 32768;
    else
        gl = l_div(d, corr_max, corr_t0, 15);
    gl = (gl * GAMMA_P) >> 15;
    i64 inv_glgp = gl < -32768 ? 0 : l_div(d, 32768, 32768 + gl, 15);
    i64 glgp_inv_glgp = 32768 - inv_glgp;
    for (int n = 0; n < SUBFRAME; n++)
        out[n] = i16((res[n + PITCH_MAX] * inv_glgp +
                      res[n + PITCH_MAX - intT0] * glgp_inv_glgp) >> 15);
}

static void weighted_filter(const i64 *az, i64 gamma, i64 *out) {
    i64 gp = gamma;
    for (int n = 0; n < 10; n++) {
        out[n] = i16((az[n] * gp) >> 15);
        gp = (gp * gamma) >> 15;
    }
}

static void tilt_compensation(Dec *d, const i64 *lp_gn, const i64 *lp_gd, i64 *res_pst) {
    i64 hf[33];
    memset(hf, 0, sizeof(hf));
    hf[10] = 4096;
    for (int i = 0; i < 10; i++) hf[i + 11] = lp_gn[i];
    for (int n = 0; n < 22; n++) {
        i64 s = hf[n + 10];
        for (int i = 0; i < 10; i++) s -= (lp_gd[i] * hf[n + 10 - i - 1]) >> 12;
        hf[n + 10] = i16(w32(s));
    }
    i64 rh0 = 0, rh1 = 0;
    for (int i = 0; i < 22; i++) rh0 += hf[10 + i] * hf[10 + i];
    for (int i = 0; i < 21; i++) rh1 += hf[10 + i] * hf[10 + i + 1];
    rh0 = w32(rh0) >> 12;
    rh1 = w32(rh1) >> 12;
    rh1 = (rh1 * GAMMA_T) >> 15;
    i64 gt = rh1 > 0 ? -l_div(d, rh1, rh0, 12) : 0;
    i64 last = res_pst[SUBFRAME - 1];
    for (int i = SUBFRAME - 1; i > 0; i--)
        res_pst[i] = i16(res_pst[i] + ((gt * res_pst[i - 1]) >> 12));
    res_pst[0] = i16(res_pst[0] + ((gt * d->ht_prev_data) >> 12));
    d->ht_prev_data = last;
}

static void adaptive_gain_control(Dec *d, i64 gain_before, i64 gain_after, i64 *speech) {
    if (!gain_after) return;
    i64 gain = 0;
    if (gain_before) {
        gain = l_div(d, gain_after, gain_before, 12);
        gain = l_inv_sqrt(d, gain) >> 11;
    }
    i64 gp = d->gain_coeff;
    for (int n = 0; n < SUBFRAME; n++) {
        gp = (29491 * gp + 3276 * gain) >> 15;
        speech[n] = i16((speech[n] * gp) >> 12);
    }
    d->gain_coeff = gp;
}

static i64 energy16(const i64 *x) {
    i64 s = 0;
    for (int i = 0; i < SUBFRAME; i++) s += (x[i] >> 4) * (x[i] >> 4);
    return w32(s);
}

static void postfilter(Dec *d, const i64 *lp, i64 pitch_delay_int, i64 *speech) {
    i64 lp_gn[10], lp_gd[10], filt[SUBFRAME];
    weighted_filter(lp, GAMMA_N, lp_gn);
    weighted_filter(lp, GAMMA_D, lp_gd);
    i64 gain_before = energy16(speech);
    residual_calc(d, lp_gn, speech);
    long_term_filter(d, pitch_delay_int, filt);
    memmove(d->residual, d->residual + SUBFRAME, PITCH_MAX * sizeof(i64));
    tilt_compensation(d, lp_gn, lp_gd, filt);
    lp_synthesis_filter(lp_gd, filt, d->res_filter_data, 0, speech);
    adaptive_gain_control(d, gain_before, energy16(speech), speech);
}

static void high_pass_filter(Dec *d, i64 *speech, int n) {
    i64 *f = d->hpf_f, *z = d->hpf_z;
    for (int i = 0; i < n; i++) {
        z[2] = z[1];
        z[1] = z[0];
        z[0] = speech[i];
        i64 f0 = w32(mul_24_15(f[1], 15836) + mul_24_15(f[2], -7667)
                     + 7699 * (z[0] - 2 * z[1] + z[2]));
        f0 = w32(f0 * 4);
        speech[i] = clip(f0 >> 14, -32768, 32767);
        f[2] = f[1];
        f[1] = f0;
    }
}

/* ---- frame --------------------------------------------------------------- */

static void decode_frame(Dec *d, const uint8_t *buf, int16_t *pcm) {
    Parm p;
    int erased = bytes2parm(buf, &p);
    d->data_error = erased;
    d->bad_pitch = parity_check(p.ac_index[0], p.parity) ? 0 : 1;

    i64 lsf[10], lsp[10], lp[20];
    if (d->data_error)
        lsf_restore_from_previous(d, lsf);
    else
        lsf_decode(d, p.ma_predictor, p.quantizer_1st, p.quantizer_2nd_lo,
                   p.quantizer_2nd_hi, lsf);
    lsf2lsp(lsf, lsp);
    lp_decode(d, lsp, lp);

    i64 out[2 * SUBFRAME];
    for (int i = 0; i < 2; i++) {
        i64 pd3;
        if (i == 0) {
            if (d->bad_pitch || d->data_error)
                pd3 = 3 * d->pitch_delay_int_prev + 1;
            else if (p.ac_index[0] >= 197)
                pd3 = 3 * p.ac_index[0] - 335;
            else
                pd3 = p.ac_index[0] + 59;
        } else {
            if (d->data_error)
                pd3 = 3 * d->pitch_delay_int_prev + 1;
            else
                pd3 = p.ac_index[1] + 3 * clip(d->pitch_delay_int_prev - 5,
                                               PITCH_MIN, PITCH_MAX - 9) - 1;
        }
        i64 pitch_delay_int = floordiv(pd3, 3);
        decode_ac_vector(d, pitch_delay_int, (pd3 - 3 * pitch_delay_int) - 1,
                         i * SUBFRAME);

        if (d->data_error) {
            d->rand_value = g729_random(d->rand_value);
            p.fc_indexes[i] = d->rand_value & 0x1FFF;
            d->rand_value = g729_random(d->rand_value);
            p.pulses_signs[i] = d->rand_value & 0x000F;
        }
        i64 fc[SUBFRAME];
        if (decode_fc_vector(p.fc_indexes[i], p.pulses_signs[i], fc))
            d->data_error = 1;
        fix_fc_vector(d, pitch_delay_int, fc);

        if (d->data_error) {
            d->gain_pitch = imin((29491 * d->gain_pitch) >> 15, 29491);
            d->gain_code = (8028 * d->gain_code) >> 13;
            update_gain_erasure(d);
        } else {
            d->gain_pitch = (i64)CB_GA[p.ga_cb_index[i]][0] + CB_GB[p.gb_cb_index[i]][0];
            d->gain_code = get_gain_code(d, p.ga_cb_index[i], p.gb_cb_index[i], fc);
        }
        d->pitch_sharp = clip(d->gain_pitch, SHARP_MIN, SHARP_MAX);
        mem_update(d, fc, d->gain_pitch, d->gain_code, i * SUBFRAME);

        i64 speech[SUBFRAME];
        const i64 *lpi = lp + i * 10;
        if (lp_synthesis_filter(lpi, d->exc + EXC_OFF + i * SUBFRAME,
                                d->syn_filter_data, 1, speech)) {
            for (int k = 0; k < EXC_LEN; k++) d->exc[k] >>= 2;
            lp_synthesis_filter(lpi, d->exc + EXC_OFF + i * SUBFRAME,
                                d->syn_filter_data, 0, speech);
        }
        postfilter(d, lpi, pitch_delay_int, speech);

        if (d->data_error)
            d->pitch_delay_int_prev = imin(d->pitch_delay_int_prev + 1, PITCH_MAX);
        else
            d->pitch_delay_int_prev = pitch_delay_int;
        memcpy(out + i * SUBFRAME, speech, sizeof(speech));
    }
    memmove(d->exc, d->exc + 2 * SUBFRAME, (PITCH_MAX + INTERPOL_LEN) * sizeof(i64));
    high_pass_filter(d, out, 2 * SUBFRAME);
    for (int k = 0; k < 2 * SUBFRAME; k++) pcm[k] = (int16_t)out[k];
}

__attribute__((visibility("default")))
int64_t pb_g729_decode(const uint8_t *frames, int64_t n, int16_t *pcm) {
    Dec d;
    dec_init(&d);
    for (int64_t t = 0; t < n; t++) {
        decode_frame(&d, frames + 10 * t, pcm + 80 * t);
        if (d.fault) return -(t + 1);
    }
    return 0;
}
