"""Standard MJPEG on a device: the port of `amv_tpu/codecs/mjpeg.py`'s
decode (baseline SOF0, progressive SOF2 and lossless SOF3 frames) and its
encode.

Decode (`decode_mjpeg_frames`): the frames' headers are parsed on the host
(`bitstream/jpeg_parse.py`; quant and Huffman tables per frame, 4:2:0,
4:2:2, 4:4:4 or gray sampling, DRI/RSTn restart markers).  Baseline
frames of 4:2:0 sampling with the stock K.3 tables and no restart markers
go through kernel D, the AMV scan decoder, as the JAX package sends them
to its AMV decoder; every other baseline frame goes to the host C decoder
(`native.decode_scans_custom`), batched by table set.  Progressive frames
decode scan by scan on the host (`bitstream/jpeg_progressive.py`: the
Python marker parse, then one C call a frame) into levels with the
absolute DC.  The transform runs on the device: DC prediction as a
restart-segmented cumsum per component (or the absolute DC of a
progressive frame), dequant with the int16 wrap, kernel I's `idct_put`,
and the top-down assembly with its crop.  Two-field interlaced packets
decode as fields and are row-interleaved (mjpegdec.c:263-283, :339,
:712-713).  Lossless frames (`decode_lossless_frames`) have no transform:
one host C walk a frame (`bitstream/jpeg_lossless.py`) gives the planes,
which go up in one copy a batch.  The frames' host C calls run on
HOST_THREADS threads.

Encode (`encode_mjpeg_frames`): 4:2:0 without restart markers runs the
AMV encode's kernels V and E on the flipped planes (V's own flip cancels
it, as in the JAX package); other samplings and restart intervals extract
the top-down blocks with edge replication in torch, quantize them with
kernel F's `fdct_quantize`, and pack the scans in the host C library
(`native.pack_scans_generic`).  Each frame carries its full header.

Reference: mjpegdec.c (decode_block, mjpeg_decode_scan, :533-548 restart),
mjpegenc.c (jpeg_table_header, encode_block, escape_FF).
"""

from __future__ import annotations

import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import native
from ..bitstream import jpeg_lossless, jpeg_progressive
from ..bitstream.jpeg_parse import parse_jpeg
from ..kernels.encode_fused import encode_planes
from ..kernels.entropy_decode import decode_scans
from ..kernels.fdct import fdct_quantize
from ..kernels.idct import idct_put
from ..pipeline import resolve_device, upload
from . import jpeg_tables as T
from .amv_video import pack_levels

HOST_FRAMES = 0    # frames decoded by the host C decoder (not kernel D)
HOST_THREADS = min(8, os.cpu_count() or 1)   # host C decoders run at once

_K3 = {
    (0, 0): (T.BITS_DC_LUMA, T.VALS_DC_LUMA),
    (0, 1): (T.BITS_DC_CHROMA, T.VALS_DC_CHROMA),
    (1, 0): (T.BITS_AC_LUMA, T.VALS_AC_LUMA),
    (1, 1): (T.BITS_AC_CHROMA, T.VALS_AC_CHROMA),
}

# per layout: component index of each MCU block
COMP_OF_BLOCK = {"420": (0, 0, 0, 0, 1, 2), "422": (0, 0, 1, 2),
                 "444": (0, 1, 2), "gray": (0,)}
_MCU = {"420": (16, 16), "422": (16, 8), "444": (8, 8), "gray": (8, 8)}
_SOF_SAMPLING = {"420": 0x22, "422": 0x21, "444": 0x11}


def _tables_are_k3(frame) -> bool:
    for key, (bits, vals) in _K3.items():
        got = frame.huff.get(key)
        if got is None:
            return False
        if not (np.array_equal(got[0], bits) and np.array_equal(got[1], vals)):
            return False
    return True


def _layout_of(frame):
    """(kind, nb, mcu_w, mcu_h) for the supported interleaved samplings
    (mjpegdec.c mjpeg_decode_sof's h/v handling, baseline subset)."""
    comps = frame.components
    if len(comps) == 1 and comps[0][1:3] == (1, 1):
        return ("gray", 1, 8, 8)
    if len(comps) == 3:
        sub = tuple(c[1:3] for c in comps)
        if sub == ((2, 2), (1, 1), (1, 1)):
            return ("420", 6, 16, 16)
        if sub == ((2, 1), (1, 1), (1, 1)):
            return ("422", 4, 16, 8)
        if sub == ((1, 1), (1, 1), (1, 1)):
            return ("444", 3, 8, 8)
    raise ValueError(
        "unsupported MJPEG sampling "
        f"{[(c[1], c[2]) for c in comps]} (4:2:0/4:2:2/4:4:4/gray only)")


# ------------------------------------------------------------ markers

def _image_spans(data: bytes) -> list:
    """(start, end) byte spans of each complete SOI..EOI image in the
    buffer: a marker and segment walk (scan data is skipped through its
    escaped-0xFF structure, so table payloads cannot false-positive).
    Interlaced MJPEG carries two field images per packet (mjpegdec.c
    eoi_parser :1277-1285)."""
    spans = []
    pos, n = 0, len(data)
    start = None
    in_scan = False
    while pos + 1 < n:
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if in_scan:
            # inside entropy data: only stuffing, RSTn or a real marker
            if marker == 0x00 or 0xD0 <= marker <= 0xD7:
                pos += 2
                continue
            in_scan = False
            continue  # re-examine the real marker
        if marker == 0xD8:
            if start is None:
                start = pos
            pos += 2
            continue
        if marker == 0xD9:
            if start is not None:
                spans.append((start, pos + 2))
                start = None
            pos += 2
            continue
        if marker == 0x01 or 0xD0 <= marker <= 0xD7 or marker == 0xFF:
            pos += 2 if marker != 0xFF else 1
            continue
        if pos + 4 > n:
            break
        seglen = struct.unpack_from(">H", data, pos + 2)[0]
        if marker == 0xDA:
            in_scan = True
        pos += 2 + seglen
    if start is not None:  # EOI-less trailing image
        spans.append((start, n))
    return spans


def _sof_field(data: bytes, height: bool) -> int:
    """The first SOFn segment's marker byte, or its height field with
    height=True (0 if there is none before the scan): a segment walk, so
    table payloads cannot false-positive."""
    pos, n = 2, len(data)
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return struct.unpack_from(">H", data, pos + 5)[0] if height \
                else marker
        if marker in (0xD9, 0xDA):
            return 0
        pos += 2 + struct.unpack_from(">H", data, pos + 2)[0]
    return 0


# ------------------------------------------------------------ decode

def seg_cumsum(x: torch.Tensor, seg_len: int) -> torch.Tensor:
    """Cumulative int32 sum along dim 1 that restarts every seg_len entries
    (seg_len <= 0: a plain cumsum): the restart markers' DC-prediction
    reset (mjpegdec.c:545-547) as a prefix subtraction."""
    c = torch.cumsum(x, dim=1, dtype=torch.int32)
    if seg_len <= 0 or x.shape[1] <= seg_len:
        return c
    start = torch.arange(x.shape[1], device=x.device) // seg_len * seg_len
    prev = c[:, (start - 1).clamp(min=0)]
    return c - torch.where(start > 0, prev, 0).to(torch.int32)


def _w16(x: torch.Tensor) -> torch.Tensor:
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def assemble(pix: torch.Tensor, layout: str, mb_w: int, mb_h: int,
             width: int, height: int):
    """Pixel blocks uint8 [F, M, nb, 8, 8] -> top-down planes (y, cb, cr)
    for the layout (cb, cr None for gray), cropped to the picture."""
    f = pix.shape[0]
    mcu = pix.reshape(f, mb_h, mb_w, -1, 8, 8)

    def plane(k):                               # one block a component
        return mcu[:, :, :, k].permute(0, 1, 3, 2, 4).reshape(
            f, 8 * mb_h, 8 * mb_w)

    if layout == "420":
        y = mcu[:, :, :, :4].reshape(f, mb_h, mb_w, 2, 2, 8, 8).permute(
            0, 1, 3, 5, 2, 4, 6).reshape(f, 16 * mb_h, 16 * mb_w)
        return (y[:, :height, :width],
                plane(4)[:, :height // 2, :width // 2],
                plane(5)[:, :height // 2, :width // 2])
    if layout == "422":
        y = mcu[:, :, :, :2].permute(0, 1, 4, 2, 3, 5).reshape(
            f, 8 * mb_h, 16 * mb_w)
        cw = (width + 1) // 2
        return (y[:, :height, :width], plane(2)[:, :height, :cw],
                plane(3)[:, :height, :cw])
    if layout == "444":
        return tuple(plane(k)[:, :height, :width] for k in range(3))
    return plane(0)[:, :height, :width], None, None


def dequantize(levels_zz: torch.Tensor, qm_zz, layout: str,
               restart: int = 0, dc_absolute: bool = False) -> torch.Tensor:
    """The decode's dequant on the levels' device: levels int16 [F, M, nb,
    64] zigzag (slot 0 the DC difference, or with dc_absolute the absolute
    quantized DC of a progressive frame), qm_zz int [nb, 64] each block's
    quant table in zigzag order -> raster coefficients int16 [F, M, nb, 8,
    8], kernel I's input.  DC prediction per component (restarting every
    `restart` MCUs; none for an absolute DC), +1024 bias, levels x table
    wrapped to int16."""
    f, m, nb = levels_zz.shape[:3]
    dev = levels_zz.device
    comp_of = COMP_OF_BLOCK[layout]
    lv = levels_zz.to(torch.int32)
    qm = torch.as_tensor(np.asarray(qm_zz, np.int32), device=dev)
    deq = _w16(lv * qm)
    if dc_absolute:
        deq[..., 0] = _w16(lv[..., 0] * qm[:, 0] + 1024)
    else:
        # the blocks of each component are contiguous in MCU order in
        # every layout, so the DC chains concatenate back without a
        # scatter
        parts = []
        for c in sorted(set(comp_of)):
            b0, k = comp_of.index(c), comp_of.count(c)
            x = lv[:, :, b0:b0 + k, 0].reshape(f, m * k) * qm[b0, 0]
            parts.append((seg_cumsum(x, restart * k) + 1024).reshape(f, m,
                                                                     k))
        deq[..., 0] = _w16(torch.cat(parts, dim=2))
    raster = deq[..., torch.as_tensor(T.UNZIGZAG, device=dev).long()]
    return raster.to(torch.int16).reshape(f, m, nb, 8, 8)


def transform(levels_zz: torch.Tensor, qm_zz, layout: str, mb_w: int,
              mb_h: int, width: int, height: int, restart: int = 0,
              dc_absolute: bool = False):
    """`amv_tpu.codecs.mjpeg._transform` on the levels' device:
    `dequantize`, kernel I's idct_put, `assemble`."""
    pix = idct_put(dequantize(levels_zz, qm_zz, layout, restart,
                              dc_absolute))
    return assemble(pix, layout, mb_w, mb_h, width, height)


def _hkey(f):
    return tuple(sorted((k, bits.tobytes(), vals.tobytes())
                        for k, (bits, vals) in f.huff.items())) + \
        tuple(map(tuple, f.scan_components)) + (f.restart_interval,)


def _qkey(f, prog: bool):
    """The transform's run key: the blocks' quant tables, the restart
    interval and the DC convention (a progressive frame's DC is absolute,
    its restarts resolved by the scan decode)."""
    ri = 0 if prog else f.restart_interval
    return b"".join(f.quant[tq].tobytes() for (_, _, _, tq) in
                    f.mcu_blocks()) + bytes([ri & 0xFF, ri >> 8, prog])


def _scan_levels(frames, n_mcu: int, nb: int, layout: str, dev):
    """The zigzag levels int16 [F, n_mcu, nb, 64] of parsed frames on dev:
    kernel D for 4:2:0 frames with the stock tables and no restart
    markers (frames it rejects, and all others, through the host C
    decoder, which raises ValueError on a malformed one)."""
    global HOST_FRAMES
    std = layout == "420" and all(
        f.scan_components == [(0, 0, 0), (1, 1, 1), (2, 1, 1)] and
        f.restart_interval == 0 and _tables_are_k3(f) for f in frames)
    host, levels = range(len(frames)), None
    if std:
        rows, lens = native.unescape_frames(
            [b"\xFF\xD8" + f.scan + b"\xFF\xD9" for f in frames])
        lv, ok = decode_scans(upload(rows, dev), upload(lens, dev),
                              n_mcu * 6)
        levels = lv.reshape(len(frames), n_mcu, 6, 64)
        host = torch.nonzero(ok == 0).flatten().tolist()
    groups = {}
    for i in host:
        groups.setdefault(_hkey(frames[i]), []).append(i)
    if levels is None and len(groups) > 1:
        levels = torch.empty((len(frames), n_mcu, nb, 64),
                             dtype=torch.int16, device=dev)
    for idxs in groups.values():
        got = _host_decode([frames[i] for i in idxs], n_mcu, nb, dev)
        if len(idxs) == len(frames):
            levels = got
        else:
            levels[torch.as_tensor(idxs, device=dev)] = got
        HOST_FRAMES += len(idxs)
    return levels


def _threads(fn, items) -> None:
    """fn(part) over items split into HOST_THREADS runs, on as many
    threads (the host C calls drop the GIL); re-raises the error of the
    earliest part that failed."""
    parts = [p for p in np.array_split(np.asarray(items), HOST_THREADS)
             if len(p)]
    with ThreadPoolExecutor(len(parts)) as ex:
        list(ex.map(fn, parts))


def _progressive_levels(scans, n_mcu: int, nb: int, dev) -> torch.Tensor:
    """Levels int16 [F, n_mcu, nb, 64] (absolute DC) of parsed progressive
    frames (`jpeg_progressive.parse_scans`) on dev: each frame's scans in
    one host C call, the frames on HOST_THREADS threads into one host
    buffer (pinned for a CUDA dev), then one upload."""
    buf = torch.empty((len(scans), n_mcu, nb, 64), dtype=torch.int16,
                      pin_memory=dev.type == "cuda")
    out = buf.numpy()

    def run(part):
        for j in part:
            out[j] = jpeg_progressive.decode_scans(scans[j])[0]

    _threads(run, range(len(scans)))
    return buf.to(dev, non_blocking=True)


def _host_decode(frames, n_mcu: int, nb: int, dev) -> torch.Tensor:
    """The host C decode of frames of one table set -> levels int16 [F,
    n_mcu, nb, 64] on dev: the frames split over HOST_THREADS threads (the
    ctypes call drops the GIL), each decoding straight into its rows of
    one host buffer (pinned for a CUDA dev), then one upload."""
    f = frames[0]
    pairs = [(dc, ac) for (_, dc, ac, _) in f.mcu_blocks()]
    buf = torch.empty((len(frames), n_mcu, nb, 64), dtype=torch.int16,
                      pin_memory=dev.type == "cuda")
    out = buf.numpy()

    def run(part):
        native.decode_scans_custom(
            [frames[j].scan for j in part], n_mcu, f.huff, pairs,
            restart_interval=f.restart_interval,
            out=out[part[0]:part[-1] + 1])

    _threads(run, range(len(frames)))
    return buf.to(dev, non_blocking=True)


def decode_mjpeg_frames(payloads: list[bytes], org_height: int = 0, *,
                        device, batch_frames: int | None = None):
    """Decode MJPEG frames on `device` -> (y, cb, cr) uint8 tensors,
    top-down: chroma None for gray, half-width for 4:2:2, half-size for
    4:2:0, full-size for 4:4:4; equal to `amv_tpu.codecs.mjpeg.
    decode_mjpeg_frames`' planes.  Baseline (SOF0) and progressive (SOF2)
    frames may mix; lossless (SOF3) frames, YUV or gray, come alone
    (`decode_lossless_frames`; an RGB-mode stream raises).  All frames
    share geometry and sampling; tables and restart intervals may vary per
    frame.

    org_height is the container's frame height: when the coded height is
    less than 3/4 of it, or without it when a packet holds two complete
    images, the packets are two-field interlaced (mjpegdec.c:266-274) and
    go through `decode_interlaced_frames`.  The frames' scans and
    transforms run batch_frames at a time (all at once by default)."""
    dev = resolve_device(device)
    if payloads:
        nimg = len(_image_spans(payloads[0]))
        h0 = _sof_field(payloads[0], height=True)
        if nimg == 2 and (not org_height or h0 < (org_height * 3) // 4):
            # polarity from the AVI1 APP0 marker when tagged
            # (mjpegdec.c:890-914), top-field-first otherwise
            return decode_interlaced_frames(payloads, None, device=dev,
                                            batch_frames=batch_frames)
    sofs = [_sof_field(p, height=False) for p in payloads]
    if 0xC3 in sofs:
        if any(m != 0xC3 for m in sofs):
            raise ValueError("cannot mix lossless and DCT frames")
        mode, planes = decode_lossless_frames(payloads, device=dev,
                                              batch_frames=batch_frames)
        if mode == "rgb":
            raise ValueError("RGB-mode lossless stream: use "
                             "decode_lossless_frames")
        if len(planes) == 1:
            return planes[0], None, None
        if len(planes) != 3:
            raise ValueError("unsupported lossless component count")
        return tuple(planes)
    frames, scans = [], {}
    for i, p in enumerate(payloads):
        if sofs[i] == 0xC2:
            scans[i] = jpeg_progressive.parse_scans(p)
            f = scans[i].frame
            # the scan bookkeeping mcu_blocks() reads
            f.scan_components = [(ci, 0, 0)
                                 for ci in range(len(f.components))]
            frames.append(f)
        else:
            frames.append(parse_jpeg(p))
    f0 = frames[0]
    layout, nb, mcu_w, mcu_h = _layout_of(f0)
    for f in frames[1:]:
        if _layout_of(f)[0] != layout or (f.width, f.height) != \
                (f0.width, f0.height):
            raise ValueError("frames must share geometry and sampling")
    w, h = f0.width, f0.height
    mb_w, mb_h = (w + mcu_w - 1) // mcu_w, (h + mcu_h - 1) // mcu_h
    n = len(frames)
    step = batch_frames or n
    out = None
    for a in range(0, n, step):
        z = min(n, a + step)
        prog = [i - a for i in range(a, z) if i in scans]
        base = [i - a for i in range(a, z) if i not in scans]
        parts = []
        if base:
            parts.append((base, _scan_levels([frames[a + i] for i in base],
                                             mb_w * mb_h, nb, layout, dev)))
        if prog:
            parts.append((prog, _progressive_levels(
                [scans[a + i] for i in prog], mb_w * mb_h, nb, dev)))
        if len(parts) == 1:
            levels = parts[0][1]
        else:                                   # a mixed batch
            levels = torch.empty((z - a, mb_w * mb_h, nb, 64),
                                 dtype=torch.int16, device=dev)
            for idxs, lv in parts:
                levels[torch.as_tensor(idxs, device=dev)] = lv
        # quant tables, the restart interval and the DC convention may
        # vary per frame
        runs = {}
        for i in range(z - a):
            runs.setdefault(_qkey(frames[a + i], a + i in scans),
                            []).append(i)
        for idxs in runs.values():
            f, absolute = frames[a + idxs[0]], a + idxs[0] in scans
            qm = np.stack([f.quant[tq].astype(np.int32)
                           for (_, _, _, tq) in f.mcu_blocks()])
            sel = torch.as_tensor(idxs, device=dev)
            planes = transform(levels[sel], qm, layout, mb_w, mb_h, w, h,
                               restart=0 if absolute else f.restart_interval,
                               dc_absolute=absolute)
            if out is None:
                out = [None if p is None else torch.empty(
                    (n, *p.shape[1:]), dtype=torch.uint8, device=dev)
                    for p in planes]
            for dst, p in zip(out, planes):
                if p is not None:
                    dst[sel + a] = p
    return tuple(out)


def decode_lossless_frames(payloads: list[bytes], *, device,
                           batch_frames: int | None = None):
    """Decode lossless (SOF3) JPEG frames on `device` -> (mode, planes),
    equal to `amv_tpu.codecs.mjpeg.decode_lossless_frames`: mode "rgb"
    with three full-size [F, H, W] uint8 tensors in the reference's RGB32
    byte order (B, G, R: mjpegdec.c ljpeg_decode_rgb_scan:544-561), or
    mode "yuv" with one [F, ...] tensor per component at its sampled size
    (gray: one); (None, None) for no frames.  All frames share geometry
    and mode (mjpegdec.c:1254-1261 SOF3 dispatch); predictors, the point
    transform and the colour transform are per frame.

    Each frame is one host C walk (`jpeg_lossless.decode_into`), the
    frames of a batch (batch_frames, all by default) on HOST_THREADS
    threads into one host buffer (pinned for a CUDA device: the caching
    host allocator keeps it until its copy has run), which goes up in one
    copy."""
    dev = resolve_device(device)
    if not payloads:
        return None, None
    tables = {}
    p0 = jpeg_lossless.parse_frame(payloads[0], tables)
    shapes = p0.shapes
    size = [r * c for r, c in shapes]
    off = np.cumsum([0] + size)
    n = len(payloads)
    step = batch_frames or n
    planes = torch.empty((n, int(off[-1])), dtype=torch.uint8, device=dev)
    for a in range(0, n, step):
        z = min(n, a + step)
        buf = planes[a:z] if dev.type == "cpu" else torch.empty(
            (z - a, int(off[-1])), dtype=torch.uint8, pin_memory=True)
        host = buf.numpy()

        def run(part):
            for i in part:
                p = p0 if i == 0 else jpeg_lossless.parse_frame(payloads[i],
                                                                tables)
                if p.rgb != p0.rgb or p.shapes != shapes:
                    # the JAX package decodes the frame before it compares
                    jpeg_lossless.decode_lossless(payloads[i], tables=tables)
                    raise ValueError("lossless frames must share "
                                     "geometry/mode")
                jpeg_lossless.decode_into(p, host[i - a], off[:-1])

        _threads(run, range(a, z))
        if dev.type != "cpu":
            planes[a:z].copy_(buf, non_blocking=True)
    return ("rgb" if p0.rgb else "yuv"), [
        planes[:, o:o + s].reshape(n, r, c).contiguous()
        for o, s, (r, c) in zip(off.tolist(), size, shapes)]


def _interleave_fields(top: torch.Tensor, bottom: torch.Tensor):
    """Row-interleave two field plane stacks [F, fh, w] -> [F, 2fh, w]
    (mjpegdec.c:339 doubles the line stride per field; :712-713 offsets
    the bottom field by one picture row)."""
    f, fh, w = top.shape
    out = torch.empty((f, 2 * fh, w), dtype=top.dtype, device=top.device)
    out[:, 0::2] = top
    out[:, 1::2] = bottom
    return out


def decode_interlaced_frames(payloads: list[bytes],
                             interlace_polarity: int | None = 0, *,
                             device, batch_frames: int | None = None):
    """Decode two-field interlaced MJPEG packets (each payload carries
    both field images) and row-interleave them into full frames
    (mjpegdec.c:263-283, :339, :712-713, :1277-1285).  polarity 0 = first
    field on even rows; None = from the first field's AVI1 APP0 marker
    when present (2 means the first image is the bottom field,
    mjpegdec.c:890-914).  -> (y, cb, cr) with height 2 x field height."""
    spans = [_image_spans(p) for p in payloads]
    if not all(len(s) == 2 for s in spans):
        raise ValueError("interlaced packets must carry two field images")
    fields = []
    for p, s in zip(payloads, spans):
        fields.append(p[s[0][0]:s[0][1]])
        fields.append(p[s[1][0]:s[1][1]])
    if interlace_polarity is None:
        pol = parse_jpeg(fields[0]).avi1_polarity
        interlace_polarity = 1 if pol == 2 else 0
    y, cb, cr = decode_mjpeg_frames(
        fields, device=device,
        batch_frames=batch_frames and 2 * batch_frames)
    f0, f1 = (0, 1) if interlace_polarity == 0 else (1, 0)
    yo = _interleave_fields(y[f0::2], y[f1::2])
    if cb is None:
        return yo, None, None
    return (yo, _interleave_fields(cb[f0::2], cb[f1::2]),
            _interleave_fields(cr[f0::2], cr[f1::2]))


# ------------------------------------------------------------ encode

def jpeg_header_with_tables(width, height, qm_zz: np.ndarray,
                            layout: str = "420",
                            restart_interval: int = 0) -> bytes:
    """Full JPEG header with the given quant table (all components) and the
    K.3 Huffman set (mjpegenc.c jpeg_table_header/picture_header layout),
    plus an optional DRI and the 4:2:2/4:4:4/gray SOF variants."""
    out = bytearray(b"\xFF\xD8\xFF\xDB" + (2 + 65).to_bytes(2, "big") +
                    b"\x00")
    out += bytes(np.clip(qm_zz, 1, 255).astype(np.uint8))
    out += T.DHT_K3
    if restart_interval:
        out += b"\xFF\xDD\x00\x04" + int(restart_interval).to_bytes(2, "big")
    size = int(height).to_bytes(2, "big") + int(width).to_bytes(2, "big")
    if layout == "gray":
        out += b"\xFF\xC0\x00\x0B\x08" + size + b"\x01\x01\x11\x00"
        out += b"\xFF\xDA\x00\x08\x01\x01\x00\x00\x3F\x00"
    else:
        out += b"\xFF\xC0\x00\x11\x08" + size
        out += bytes([3, 1, _SOF_SAMPLING[layout], 0, 2, 0x11, 0, 3, 0x11, 0])
        out += b"\xFF\xDA\x00\x0C\x03\x01\x00\x02\x11\x03\x11\x00\x3F\x00"
    return bytes(out)


def _pad_edge(p: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """p [F, h, w] -> [F, th, tw], the last row and column repeated."""
    rows = torch.arange(th, device=p.device).clamp(max=p.shape[1] - 1)
    cols = torch.arange(tw, device=p.device).clamp(max=p.shape[2] - 1)
    return p.index_select(1, rows).index_select(2, cols)


def extract_blocks_topdown(y, cb, cr, layout: str, mb_w: int, mb_h: int):
    """Top-down planes -> MCU blocks uint8 [F, M, nb, 8, 8] with bottom and
    right edge replication (ff_emulated_edge_mc semantics, no AMV flip)."""
    f = y.shape[0]

    def blocks8(p, bh, bw):
        return _pad_edge(p, 8 * bh, 8 * bw).reshape(
            f, bh, 8, bw, 8).permute(0, 1, 3, 2, 4).reshape(
            f, bh * bw, 1, 8, 8)

    if layout == "gray":
        return blocks8(y, mb_h, mb_w)
    if layout == "444":
        return torch.cat([blocks8(p, mb_h, mb_w) for p in (y, cb, cr)],
                         dim=2)
    if layout == "422":
        yb = _pad_edge(y, 8 * mb_h, 16 * mb_w).reshape(
            f, mb_h, 8, mb_w, 2, 8).permute(0, 1, 3, 4, 2, 5).reshape(
            f, mb_h * mb_w, 2, 8, 8)
    else:
        yb = _pad_edge(y, 16 * mb_h, 16 * mb_w).reshape(
            f, mb_h, 2, 8, mb_w, 2, 8).permute(0, 1, 4, 2, 5, 3, 6).reshape(
            f, mb_h * mb_w, 4, 8, 8)
    return torch.cat([yb, blocks8(cb, mb_h, mb_w), blocks8(cr, mb_h, mb_w)],
                     dim=2)


def encode_mjpeg_frames(y, cb=None, cr=None, qscale: int = 2,
                        subsampling: str = "420",
                        restart_interval: int = 0, *,
                        device) -> list[bytes]:
    """Encode top-down YUV frames (uint8 arrays or tensors) as standalone
    baseline JPEGs on `device`, byte-identical to `amv_tpu.codecs.mjpeg.
    encode_mjpeg_frames`: each carries the encoder's quant matrix (so any
    JPEG decoder reconstructs it) and the K.3 tables, DC predictions start
    at 128 (the decoder's 1024 bias cancels against qm[0] = 8).
    subsampling "420", "422", "444" or "gray" (cb, cr ignored);
    restart_interval > 0 writes DRI and RSTn markers every that many MCUs
    with the DC prediction reset (mjpegdec.c:533-548 reads them)."""
    if subsampling not in _MCU:
        raise ValueError(f"unsupported subsampling {subsampling!r}")
    dev = resolve_device(device)
    yt = upload(y, dev)
    f, h, w = yt.shape
    qm_zz = T.encoder_quant_matrix(qscale)[T.ZIGZAG]
    hdr = jpeg_header_with_tables(w, h, qm_zz, layout=subsampling,
                                  restart_interval=restart_interval)
    if subsampling == "420" and restart_interval == 0:
        # the AMV encode's V flips its input: flip it first to code top-down
        planes = [t.flip(1) for t in (yt, upload(cb, dev), upload(cr, dev))]
        words, bits = pack_levels(encode_planes(*planes, qscale))
        return [hdr + p[2:] for p in native.escape_frames(
            words.cpu().numpy(), bits.cpu().numpy())]
    mcu_w, mcu_h = _MCU[subsampling]
    mb_w, mb_h = (w + mcu_w - 1) // mcu_w, (h + mcu_h - 1) // mcu_h
    chroma = (None, None) if subsampling == "gray" else \
        (upload(cb, dev), upload(cr, dev))
    blocks = extract_blocks_topdown(yt, *chroma, subsampling, mb_w, mb_h)
    lv = fdct_quantize(blocks.contiguous(), T.encoder_qmat(qscale))
    lv_zz = lv[..., torch.as_tensor(T.ZIGZAG, device=dev).long()]
    scans = native.pack_scans_generic(lv_zz.cpu().numpy(),
                                      COMP_OF_BLOCK[subsampling],
                                      restart_interval)
    return [hdr + s + b"\xFF\xD9" for s in scans]
