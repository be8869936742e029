"""Lossless JPEG (SOF3) codec, predictors 1-7, point transform, RGB: the
port of `amv_tpu/bitstream/jpeg_lossless.py`.

Replicates the reference's ljpeg paths exactly:

* SOF3 dispatch and the ``s->rgb`` rule (3 components, all 1x1 sampling
  => RGB row scan): mjpegdec.c:1254-1261, :254.
* ``ljpeg_decode_rgb_scan`` (mjpegdec.c:509-570): row-buffered
  prediction with ``modified_predictor = 1`` on the first row, sample
  mask ``(1<<bits)-1``, initial value ``1 << (bits + pt - 1)``, output
  channel order ``ptr[4x+0..2] = buffer[0..2]`` (plain), the RCT
  (``- 0x200`` biased) and Pegasus RCT reconstructions, uint8-truncated
  stores.
* ``ljpeg_decode_yuv_scan`` (mjpegdec.c:572-658): per-MCU component
  walk (h*v samples, x fastest), PREDICT() from already-decoded
  neighbors, ``pred = 128 << pt`` only for the very first sample,
  left/top edges fall back to the single available neighbor, stores
  truncated to uint8.
* ``PREDICT`` macro semantics: mjpeg.h:128-138 (predictor 0 behaves as
  7, the C ``default`` case).
* Restart markers skip 16 aligned bits and do NOT reset prediction
  state (mjpegdec.c:536-540,602-605,650-654), quirk and all.
* Pegasus ``LJIF`` APP0 colorspace selection: mjpegdec.c:962-973.
* DC-difference entropy coding via ``mjpeg_decode_dc`` semantics
  (mjpegdec.c:358-374: VLC then get_xbits, no T.81 ssss=16 special
  case).

`decode_lossless(data)` walks a frame in one host C call
(`native.lossless_frame`: the Huffman walk and the prediction fused,
sample for sample the Python walk's); `decode_lossless(data,
native=False)` is the Python walk, the JAX package's, as the plain
version.  Both check the header alike (`parse_frame`).  The JAX package has
no device code here: the walk is serial in the bits, and uploading the
differences (2 bytes a sample) in place of the pixels would not shorten
it.  ``encode_lossless`` is the round-trip gate (decode(encode(img)) ==
img exactly); its bytes are the JAX package's.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from .. import native as _native
from ..codecs import jpeg_tables as T
from ..verify import ref_jpeg as R
from .jpeg_parse import parse_jpeg


def _predict(topleft: int, top: int, left: int, predictor: int) -> int:
    """mjpeg.h:128-138 PREDICT (predictor 0 / >7 hit the C default)."""
    if predictor == 1:
        return left
    if predictor == 2:
        return top
    if predictor == 3:
        return topleft
    if predictor == 4:
        return left + top - topleft
    if predictor == 5:
        return left + ((top - topleft) >> 1)
    if predictor == 6:
        return top + ((left - topleft) >> 1)
    return (left + top) >> 1  # 7 and the default case


def _decode_dc(br: R.BitReader, lut) -> int:
    """mjpegdec.c mjpeg_decode_dc: VLC code = size, then get_xbits."""
    code = R._read_vlc(br, lut)
    return br.get_xbits(code) if code else 0


def _rst_skip(br: R.BitReader):
    """align_get_bits + skip RSTn (mjpegdec.c:537-540)."""
    br.pos = (br.pos + 7) & ~7
    mk = br.get_bits(16)
    if mk & 0xFFF8 != 0xFFD0:
        raise ValueError(f"expected RSTn, got 0x{mk:04x}")


def parse_frame(data: bytes, tables: dict):
    """The header of one SOF3 frame and everything the walk fixes before
    its first sample, with the JAX package's checks in its order (each
    raises where `amv_tpu`'s decode_lossless raises before its loops).
    tables caches decode tables by content across frames."""
    f = parse_jpeg(data, allow_lossless=True)
    if f.sof_marker != 0xC3:
        raise ValueError("not a lossless (SOF3) frame")
    predictor, pt = f.ss, f.al
    hmax = max(c[1] for c in f.components)
    vmax = max(c[2] for c in f.components)
    rgb = hmax == 1 and vmax == 1 and len(f.components) == 3
    pegasus = f.ljif_colorspace == 2
    # mjpegdec.c:203 — 9-bit samples without the Pegasus header imply
    # the biased reversible color transform
    rct = f.bits == 9 and not pegasus
    if f.ljif_colorspace in (1, 2):
        rgb = True
    keys = {}
    for k, (bits, vals) in f.huff.items():
        keys[k] = (bits.tobytes(), vals.tobytes())
        if keys[k] not in tables:
            tables[keys[k]] = T.build_decode_table(bits, vals)
    dc_keys = [keys[(0, dc_id)] for (_, dc_id, _) in f.scan_components]
    p = SimpleNamespace(f=f, predictor=predictor, pt=pt, rgb=rgb,
                        pegasus=pegasus, rct=rct, tables=tables,
                        dc_keys=dc_keys, dc_lut=[tables[k] for k in dc_keys],
                        ri=f.restart_interval)
    if rgb:
        p.mb_w, p.mb_h = f.width, f.height
        p.mask = (1 << f.bits) - 1
        p.buf = np.zeros((p.mb_w, 3), np.int64)
        p.buf[0, :] = 1 << (f.bits + pt - 1)
        p.comps = [(None, 1, 1, None)] * 3
        p.shapes = [(p.mb_h, p.mb_w)] * 3
        return p
    # mjpegdec.c ljpeg_decode_yuv_scan:572-658 (block_size = 1: the mb
    # grid is ceil(size / sampling), one sample per block)
    p.mb_w = (f.width + hmax - 1) // hmax
    p.mb_h = (f.height + vmax - 1) // vmax
    p.comps = [f.components[ci] for (ci, _, _) in f.scan_components]
    # the planes cropped to the true component sizes (numpy's slice clamp)
    p.shapes = [(min((f.height * v + vmax - 1) // vmax, v * p.mb_h),
                 min((f.width * h + hmax - 1) // hmax, h * p.mb_w))
                for (_, h, v, _) in p.comps]
    return p


def decode_lossless(data: bytes, native: bool = True, tables=None):
    """Decode one SOF3 lossless JPEG, as `amv_tpu.bitstream.jpeg_lossless.
    decode_lossless` does.

    Returns ``(mode, planes, frame)``: mode "rgb" with three full-size
    uint8 planes in the C output order (ptr[0], ptr[1], ptr[2] — B, G, R
    of the reference's RGB32 when reconstructed via RCT), or mode "yuv"
    with one plane per component at its sampled size.  native=False walks
    the frame in Python (the plain version); tables caches decode tables
    across calls.
    """
    p = parse_frame(data, {} if tables is None else tables)
    mode = "rgb" if p.rgb else "yuv"
    if native:
        buf = np.empty(sum(r * c for r, c in p.shapes), np.uint8)
        off = np.cumsum([0] + [r * c for r, c in p.shapes])
        decode_into(p, buf, off[:-1])
        return mode, [buf[a:a + r * c].reshape(r, c) for a, (r, c) in
                      zip(off.tolist(), p.shapes)], p.f
    f, predictor, pt, dc_lut = p.f, p.predictor, p.pt, p.dc_lut
    br = R.BitReader(R.unescape_scan(f.scan))
    ri, mb_w, mb_h = p.ri, p.mb_w, p.mb_h

    if p.rgb:
        # mjpegdec.c ljpeg_decode_rgb_scan:509-570
        mask, buf = p.mask, p.buf
        out = np.zeros((mb_h, mb_w, 3), np.uint8)
        restart_count = 0
        for mb_y in range(mb_h):
            modified_predictor = predictor if mb_y else 1
            top = [int(buf[0, i]) for i in range(3)]
            left = list(top)
            topleft = list(top)
            for mb_x in range(mb_w):
                if ri and not restart_count:
                    restart_count = ri
                for i in range(3):
                    topleft[i] = top[i]
                    top[i] = int(buf[mb_x, i])
                    pred = _predict(topleft[i], top[i], left[i],
                                    modified_predictor)
                    v = mask & (pred + (_decode_dc(br, dc_lut[i]) << pt))
                    left[i] = v
                    buf[mb_x, i] = v
                if ri:
                    restart_count -= 1
                    if not restart_count:
                        _rst_skip(br)
            if p.rct:                     # mjpegdec.c:544-548
                o1 = buf[:, 0] - ((buf[:, 1] + buf[:, 2] - 0x200) >> 2)
                out[mb_y, :, 0] = (buf[:, 1] + o1) & 0xFF
                out[mb_y, :, 1] = o1 & 0xFF
                out[mb_y, :, 2] = (buf[:, 2] + o1) & 0xFF
            elif p.pegasus:               # mjpegdec.c:550-554
                o1 = buf[:, 0] - ((buf[:, 1] + buf[:, 2]) >> 2)
                out[mb_y, :, 0] = (buf[:, 1] + o1) & 0xFF
                out[mb_y, :, 1] = o1 & 0xFF
                out[mb_y, :, 2] = (buf[:, 2] + o1) & 0xFF
            else:                         # mjpegdec.c:556-561
                out[mb_y, :, 0] = buf[:, 0] & 0xFF
                out[mb_y, :, 1] = buf[:, 1] & 0xFF
                out[mb_y, :, 2] = buf[:, 2] & 0xFF
        return mode, [out[:, :, i] for i in range(3)], f

    comps = p.comps
    planes = [np.zeros((v * mb_h, h * mb_w), np.uint8)
              for (_, h, v, _) in comps]
    restart_count = 0
    for mb_y in range(mb_h):
        for mb_x in range(mb_w):
            if ri and not restart_count:
                restart_count = ri
            for i, (_, h, v, _) in enumerate(comps):
                pl = planes[i]
                for j in range(h * v):
                    y, x = divmod(j, h)
                    py, px = v * mb_y + y, h * mb_x + x
                    if py == 0:
                        if px == 0:
                            pred = 128 << pt
                        else:
                            pred = int(pl[py, px - 1])
                    elif px == 0:
                        pred = int(pl[py - 1, px])
                    else:
                        pred = _predict(int(pl[py - 1, px - 1]),
                                        int(pl[py - 1, px]),
                                        int(pl[py, px - 1]), predictor)
                    pl[py, px] = (pred +
                                  (_decode_dc(br, dc_lut[i]) << pt)) & 0xFF
            if ri:
                restart_count -= 1
                if not restart_count:
                    _rst_skip(br)
    return mode, [pl[:r, :c] for pl, (r, c) in zip(planes, p.shapes)], f


def decode_into(p, out: np.ndarray, out_off) -> None:
    """Walk the frame `parse_frame` gave (p) in one host C call
    (`native.lossless_frame`), its planes (p.shapes) written into the
    uint8 buffer out at out_off, rows back to back."""
    f = p.f
    if p.rgb and p.mb_h and len(p.dc_lut) < 3:
        raise IndexError("RGB lossless scan with fewer than 3 components")
    n = 3 if p.rgb else len(p.comps)
    key = ("planes", n, tuple(p.dc_keys[:n]))   # frames share their tables
    luts = p.tables.get(key)
    if luts is None:      # filled before it is shared with other threads
        luts = np.zeros((n, 2, 65536), np.uint8)
        for i, (sym, ln) in enumerate(p.dc_lut[:n]):
            luts[i, 0], luts[i, 1] = sym, ln
        p.tables[key] = luts
    geom = (int(p.rgb), p.mb_w, p.mb_h, n, p.predictor, p.pt, f.bits,
            1 if p.rct else 2 if p.pegasus else 0, p.ri)
    _native.lossless_frame(f.scan, geom, [c[1:3] for c in p.comps],
                           p.shapes, luts, out, out_off)


# ---------------------------------------------------------------------------
# Lossless encoder (round-trip gate; no reference counterpart)
# ---------------------------------------------------------------------------

# canonical DC table covering diff sizes 0..16 (K.3 DC tables stop at
# 11; lossless diffs with point transforms can need the full range)
_LL_BITS = np.zeros(17, np.int32)
_LL_BITS[5] = 17        # all 17 symbols at code length 5
_LL_VALS = np.arange(17, dtype=np.int32)


def _size_of(diff: int) -> int:
    return abs(diff).bit_length()


def encode_lossless(planes, predictor: int = 1, point_transform: int = 0,
                    rgb: bool = False, pegasus: bool = False, rct: bool = False,
                    bits: int = 8, restart_interval: int = 0) -> bytes:
    """Encode planes as a SOF3 lossless JPEG decodable by
    decode_lossless (and the reference's ljpeg scan decoders).

    yuv mode: planes are per-component uint8 arrays; sampling factors
    are inferred from their shapes relative to the largest plane.
    rgb mode: three full-size planes in C output order (see
    decode_lossless); pegasus=True applies the forward Pegasus RCT and
    writes the LJIF APP0 header (colorspace 2); rct=True applies the
    0x200-biased RCT the decoder infers from 9-bit samples
    (mjpegdec.c:203).  Both transforms force bits=9 so the
    chroma-difference residuals survive the decoder's sample mask.
    """
    if pegasus or rct:
        bits = 9
    if rgb:
        h0, w0 = planes[0].shape
        ncomp = 3
        samp = [(1, 1)] * 3
        width, height = w0, h0
    else:
        h0, w0 = planes[0].shape
        width, height = w0, h0
        samp = []
        for p in planes:
            ph, pw = p.shape
            samp.append(((w0 + pw - 1) // pw, (h0 + ph - 1) // ph))
        # express as JPEG h/v factors (largest component gets hmax/vmax)
        hmax = max(s[0] for s in samp)
        vmax = max(s[1] for s in samp)
        samp = [(hmax // s[0], vmax // s[1]) for s in samp]
        ncomp = len(planes)

    out = bytearray(b"\xFF\xD8")
    if rgb:
        cs = 2 if pegasus else 1
        out += b"\xFF\xE0" + (2 + 13).to_bytes(2, "big")
        out += b"LJIF" + bytes(8) + bytes([cs])
    dht = bytearray([0x00])
    dht += bytes(_LL_BITS[1:].astype(np.uint8))
    dht += bytes(_LL_VALS.astype(np.uint8))
    out += b"\xFF\xC4" + (len(dht) + 2).to_bytes(2, "big") + dht
    if restart_interval:
        out += b"\xFF\xDD\x00\x04" + int(restart_interval).to_bytes(2, "big")
    sof = bytearray([bits])
    sof += int(height).to_bytes(2, "big") + int(width).to_bytes(2, "big")
    sof.append(ncomp)
    for i in range(ncomp):
        h, v = samp[i]
        sof += bytes([i + 1, (h << 4) | v, 0])
    out += b"\xFF\xC3" + (len(sof) + 2).to_bytes(2, "big") + sof
    sos = bytearray([ncomp])
    for i in range(ncomp):
        sos += bytes([i + 1, 0x00])
    sos += bytes([predictor, 0, point_transform])
    out += b"\xFF\xDA" + (len(sos) + 2).to_bytes(2, "big") + sos

    enc = T.build_huffman_codes(_LL_BITS, _LL_VALS)
    segs = []
    bw = R.BitWriter()
    rst_n = [0]

    def put_diff(diff):
        n = _size_of(diff)
        bw.put_bits(int(enc[0][n]), int(enc[1][n]))
        if n:
            mant = diff if diff > 0 else diff - 1
            bw.put_bits(n, mant & ((1 << n) - 1))

    def emit_rst():
        # byte-align, flush the escaped segment, append a raw RSTn
        # (markers must not themselves be 0xFF-escaped)
        nonlocal bw
        pad = (-bw.bit_count()) & 7
        if pad:
            bw.put_bits(pad, (1 << pad) - 1)
        segs.append(R.escape_ff(bw.flush()))
        segs.append(bytes([0xFF, 0xD0 + (rst_n[0] & 7)]))
        rst_n[0] += 1
        bw = R.BitWriter()

    pt = point_transform
    mask = (1 << bits) - 1
    if rgb:
        # forward transform to the row-buffer domain (see
        # decode_lossless's reconstruction for the inverse)
        o = [p.astype(np.int64) for p in planes]
        if pegasus:
            b1 = (o[0] - o[1]) & mask
            b2 = (o[2] - o[1]) & mask
            b0 = (o[1] + ((b1 + b2) >> 2)) & mask
            buf_t = np.stack([b0, b1, b2], axis=-1)
        elif rct:
            b1 = (o[0] - o[1]) & mask
            b2 = (o[2] - o[1]) & mask
            b0 = (o[1] + ((b1 + b2 - 0x200) >> 2)) & mask
            buf_t = np.stack([b0, b1, b2], axis=-1)
        else:
            buf_t = np.stack(o, axis=-1)
        mb_h, mb_w = planes[0].shape
        prev = np.full((mb_w, 3), 1 << (bits + pt - 1), np.int64)
        restart_count = 0
        for mb_y in range(mb_h):
            modified_predictor = predictor if mb_y else 1
            top = [int(prev[0, i]) for i in range(3)]
            left = list(top)
            topleft = list(top)
            cur = np.zeros((mb_w, 3), np.int64)
            for mb_x in range(mb_w):
                if restart_interval and not restart_count:
                    restart_count = restart_interval
                for i in range(3):
                    topleft[i] = top[i]
                    top[i] = int(prev[mb_x, i])
                    pred = _predict(topleft[i], top[i], left[i],
                                    modified_predictor)
                    tgt = int(buf_t[mb_y, mb_x, i])
                    # choose the stored value v = mask&(pred + d<<pt)
                    # hitting tgt's high bits: d = (tgt - pred) >> pt
                    d = ((tgt - pred) >> pt) if pt else (tgt - pred)
                    d = ((d + (mask >> 1) + 1) & mask) - (mask >> 1) - 1
                    v = mask & (pred + (d << pt))
                    put_diff(d)
                    left[i] = v
                    cur[mb_x, i] = v
                if restart_interval:
                    restart_count -= 1
                    if not restart_count:
                        emit_rst()
            prev = cur
    else:
        hmax = max(s[0] for s in samp)
        vmax = max(s[1] for s in samp)
        mb_w = (width + hmax - 1) // hmax
        mb_h = (height + vmax - 1) // vmax
        padded = []
        for i, p in enumerate(planes):
            h, v = samp[i]
            pp = np.zeros((v * mb_h, h * mb_w), np.int64)
            pp[:p.shape[0], :p.shape[1]] = p
            # edge-pad so padding samples encode cheaply and decode
            # deterministically (they are cropped away anyway)
            pp[p.shape[0]:, :] = pp[p.shape[0] - 1:p.shape[0], :]
            pp[:, p.shape[1]:] = pp[:, p.shape[1] - 1:p.shape[1]]
            padded.append(pp)
        dec = [np.zeros_like(pp) for pp in padded]
        restart_count = 0
        for mb_y in range(mb_h):
            for mb_x in range(mb_w):
                if restart_interval and not restart_count:
                    restart_count = restart_interval
                for i, (h, v) in enumerate(samp):
                    p, q = padded[i], dec[i]
                    for j in range(h * v):
                        y, x = divmod(j, h)
                        py, px = v * mb_y + y, h * mb_x + x
                        if py == 0:
                            pred = (128 << pt) if px == 0 else int(q[py, px - 1])
                        elif px == 0:
                            pred = int(q[py - 1, px])
                        else:
                            pred = _predict(int(q[py - 1, px - 1]),
                                            int(q[py - 1, px]),
                                            int(q[py, px - 1]), predictor)
                        tgt = int(p[py, px])
                        d = ((tgt - pred) >> pt) if pt else (tgt - pred)
                        d = ((d + 128) & 0xFF) - 128
                        put_diff(d)
                        q[py, px] = (pred + (d << pt)) & 0xFF
                if restart_interval:
                    restart_count -= 1
                    if not restart_count:
                        emit_rst()

    pad = (-bw.bit_count()) & 7
    if pad:
        bw.put_bits(pad, (1 << pad) - 1)
    segs.append(R.escape_ff(bw.flush()))
    out += b"".join(segs)
    out += b"\xFF\xD9"
    return bytes(out)
