"""AVI container support on a device: the port of `amv_tpu/containers/
avi.py` (the reference pipeline's input and output).

* demux: the RIFF-AVI chunk walk (avidec.c) with the idx1 index
  (avi_read_idx1, avidec.c:740-806), the ODML indx / ix## index
  (read_braindead_odml_indx, avidec.c:520-598) and AVIX, and `seek_frame`
  (avi_read_seek, avidec.c:933-1012): copied from the JAX package, pure
  Python and numpy;
* `extract_yuv420`: raw video to YUV420 planes on the device.  The frames
  go up in batches of BATCH_FRAMES, each through a pinned buffer in one
  non-blocking copy, and unpack there all at once: I420/IYUV, YV12,
  YUY2/YUYV/V422/YUNV, UYVY/Y422/UYNV, Y800/GREY, gray and colour pal8
  DIBs, RGB555 and BI_BITFIELDS RGB565, BGR24 (rows padded to 4 bytes)
  and BGRX32 (RGB DIBs are bottom-up), the RGB ones through
  `kernels.color.rgb_to_yuv420_bt601`.  MJPG/JPEG streams decode
  through `codecs.mjpeg` (baseline and progressive frames, BATCH_FRAMES
  a batch) and go to 4:2:0 on the device: 4:4:4 chroma by the rounded 2x2
  mean, 4:2:2 by the rounded mean of row pairs (odd widths cropped to
  w/2), gray with chroma 128, interlaced frames cropped to the container's
  height.  A stream whose first frame is lossless (SOF3) goes through
  `codecs.mjpeg.decode_lossless_frames` (BATCH_FRAMES a batch): RGB mode
  through `rgb_to_yuv420_bt601`, YUV and gray through the same 4:2:0
  reductions, without the interlace crop;
* `extract_pcm`: the audio stream to mono int16 on the device
  (`codecs.wav_audio`);
* mux: an AVI of I420 video and mono s16 PCM with an idx1 index (copied).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np
import torch

from ..codecs.wav_audio import decode_pcm_bytes, downmix
from ..kernels.color import rgb_to_yuv420_bt601
from ..pipeline import resolve_device

BATCH_FRAMES = 1024     # frames unpacked a batch (the transcode's batch)

@dataclass
class AviStream:
    kind: str                 # "video" | "audio"
    codec: bytes = b""        # fourcc / wFormatTag
    width: int = 0
    height: int = 0
    fps_num: int = 0
    fps_den: int = 1
    sample_rate: int = 0
    channels: int = 0
    bits: int = 0
    chunks: list = field(default_factory=list)
    # per-chunk (file_offset_of_payload, size, keyframe) from idx1/indx;
    # empty when the file carries no index
    index: list = field(default_factory=list)
    # pal8: BGRX RGBQUAD palette from strf (BITMAPINFOHEADER tail)
    palette: object = None
    # BI_BITFIELDS: (r, g, b) channel masks (e.g. RGB565) from strf
    bitmasks: object = None
    # audio: nBlockAlign from strf (ADPCM block size)
    block_align: int = 0



def _parse_idx1(data, body, size, movi_start, streams):
    """idx1 entries -> per-stream (payload_offset, size, keyframe) lists
    (avi_read_idx1, avidec.c:740-806).  Entry offsets are either absolute
    file offsets or relative to the movi list's 'movi' tag; detected like
    the reference does, by checking whether the first entry's offset
    points at its own chunk tag."""
    n = size // 16
    if n == 0:
        return
    tag0, _, ofs0, _ = struct.unpack_from("<4sIII", data, body)
    base = 0
    if data[ofs0:ofs0 + 4] != tag0:
        base = movi_start  # offsets relative to 'movi' tag
    for k in range(n):
        tag, flags, ofs, ln = struct.unpack_from("<4sIII", data,
                                                 body + 16 * k)
        if tag[2:4] not in (b"db", b"dc", b"wb") or not tag[:2].isdigit():
            continue
        sid = int(tag[:2])
        if sid < len(streams):
            streams[sid].index.append((base + ofs + 8, ln,
                                       bool(flags & 0x10)))


def _parse_odml_indx(data, body, size, sid, streams):
    """OpenDML 'indx' super/standard index (read_braindead_odml_indx,
    avidec.c:520-598).  Handles AVI_INDEX_OF_CHUNKS (standard ix##
    entries, relative to qwBaseOffset) and AVI_INDEX_OF_INDEXES
    (super index whose entries point at ix## chunks)."""
    if size < 24 or sid >= len(streams):
        return
    longs_per_entry, _sub, idx_type = struct.unpack_from("<HBB", data, body)
    n_in_use = struct.unpack_from("<I", data, body + 4)[0]
    base_ofs = struct.unpack_from("<Q", data, body + 12)[0]
    ent = body + 24
    if idx_type == 1:          # AVI_INDEX_OF_CHUNKS
        if longs_per_entry != 2:
            return
        for k in range(n_in_use):
            ofs, ln = struct.unpack_from("<II", data, ent + 8 * k)
            streams[sid].index.append(
                (base_ofs + ofs, ln & 0x7FFFFFFF,
                 not (ln & 0x80000000)))  # high bit set = non-key
    elif idx_type == 0:        # AVI_INDEX_OF_INDEXES
        if longs_per_entry != 4:
            return
        for k in range(n_in_use):
            qw_ofs, sz = struct.unpack_from("<QI", data, ent + 16 * k)
            # nested standard index chunk: 'ix##' + size + body
            if data[qw_ofs:qw_ofs + 2] == b"ix":
                sub_sz = struct.unpack_from("<I", data, qw_ofs + 4)[0]
                _parse_odml_indx(data, qw_ofs + 8, sub_sz, sid, streams)


def demux(data: bytes, use_index: bool = True):
    """Returns list[AviStream] (video first when present).

    With use_index=True (default) and an idx1/ODML index present,
    chunks are read through the index (avi_load_index semantics)
    instead of the linear movi walk — this is what makes seeking and
    sparse access O(1) per chunk.
    """
    if data[0:4] != b"RIFF" or data[8:12] not in (b"AVI ", b"AVIX"):
        raise ValueError("not an AVI file")
    streams: list[AviStream] = []
    movi_ranges = []
    idx1_loc = []
    indx_pending = []  # (strl stream id, body, size)

    def parse_strl(pos, end):
        st = None
        p = pos
        while p + 8 <= end:
            tag = data[p:p + 4]
            size = struct.unpack_from("<I", data, p + 4)[0]
            body = p + 8
            if tag == b"indx":
                indx_pending.append((len(streams), body, size))
            if tag == b"strh":
                fcc_type = data[body:body + 4]
                handler = data[body + 4:body + 8]
                scale, rate = struct.unpack_from("<II", data, body + 20)
                if fcc_type == b"vids":
                    st = AviStream("video", codec=handler,
                                   fps_num=rate, fps_den=max(scale, 1))
                elif fcc_type == b"auds":
                    st = AviStream("audio")
            elif tag == b"strf" and st is not None:
                if st.kind == "video":
                    (_, w, hgt, _, bits, compr) = struct.unpack_from(
                        "<IiiHH4s", data, body)
                    st.width, st.height, st.bits = w, abs(hgt), bits
                    if bits == 8 and size > 40:
                        # pal8: RGBQUAD palette follows the 40-byte
                        # BITMAPINFOHEADER (biClrUsed at offset 32;
                        # 0 means the full 256)
                        (ncol,) = struct.unpack_from("<I", data, body + 32)
                        ncol = ncol or 256
                        ncol = min(ncol, (size - 40) // 4)
                        if ncol:
                            st.palette = np.frombuffer(
                                data, np.uint8, 4 * ncol,
                                body + 40).reshape(ncol, 4).copy()
                    if compr == b"\x03\x00\x00\x00":
                        # BI_BITFIELDS: three DWORD channel masks follow
                        # the 40-byte BITMAPINFOHEADER (this is how real
                        # RGB565 DIBs are declared — avidec.c defers to
                        # raw.c/avcodec_get_pix_fmt via the masks)
                        if size >= 52:
                            st.bitmasks = struct.unpack_from(
                                "<III", data, body + 40)
                        st.codec = b"DIB "
                    elif compr.strip(b"\x00") and compr != b"\x00\x00\x00\x00":
                        st.codec = compr
                    elif not st.codec.strip(b"\x00"):
                        st.codec = b"DIB "
                else:
                    fmt, ch, rate_, _, balign, bits = struct.unpack_from(
                        "<HHIIHH", data, body)
                    st.codec = struct.pack("<H", fmt)
                    st.channels, st.sample_rate, st.bits = ch, rate_, bits
                    st.block_align = balign
            p = body + size + (size & 1)
        if st is not None:
            streams.append(st)

    # walk top-level lists
    pos = 12
    n = len(data)
    while pos + 8 <= n:
        tag = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        body = pos + 8
        if tag == b"LIST":
            ltype = data[body:body + 4]
            if ltype == b"hdrl":
                # parse nested strl lists
                p2 = body + 4
                while p2 + 8 <= body + size:
                    t2 = data[p2:p2 + 4]
                    s2 = struct.unpack_from("<I", data, p2 + 4)[0]
                    if t2 == b"LIST" and data[p2 + 8:p2 + 12] == b"strl":
                        parse_strl(p2 + 12, p2 + 8 + s2)
                    p2 += 8 + s2 + (s2 & 1)
            elif ltype == b"movi":
                movi_ranges.append((body, body + size))
        elif tag == b"idx1":
            idx1_loc.append((body, size))
        pos = body + size + (size & 1)

    # index-based chunk extraction (preferred when an index exists)
    if use_index:
        for sid, body, size in indx_pending:
            _parse_odml_indx(data, body, size, sid, streams)
        if not any(st.index for st in streams):
            for body, size in idx1_loc:
                # relative idx1 offsets count from the 'movi' fourcc
                movi_start = movi_ranges[0][0] if movi_ranges else 0
                _parse_idx1(data, body, size, movi_start, streams)
        if any(st.index for st in streams):
            for st in streams:
                st.chunks = [data[o:o + ln] for (o, ln, _) in st.index]
            return streams

    for lo, hi in movi_ranges:
        p = lo + 4
        while p + 8 <= hi:
            tag = data[p:p + 4]
            size = struct.unpack_from("<I", data, p + 4)[0]
            body = p + 8
            if tag[2:4] in (b"db", b"dc", b"wb") and tag[:2].isdigit():
                idx = int(tag[:2])
                if idx < len(streams) and size:
                    streams[idx].chunks.append(data[body:body + size])
                    streams[idx].index.append((body, size, True))
            elif tag == b"LIST":
                p = body + 4
                continue
            p = body + size + (size & 1)
    return streams


def seek_frame(st: AviStream, frame: int) -> int:
    """Index-based seek: clamp `frame` into range and back up to the
    nearest keyframe at or before it (avi_read_seek, avidec.c:933-1012 —
    av_index_search_timestamp with AVSEEK_FLAG_BACKWARD semantics).
    Returns the chunk index to start decoding from."""
    if not st.index:
        return max(0, min(frame, len(st.chunks) - 1))
    frame = max(0, min(frame, len(st.index) - 1))
    while frame > 0 and not st.index[frame][2]:
        frame -= 1
    return frame


def read(path: str):
    with open(path, "rb") as f:
        return demux(f.read())



def _is_dib(tag: bytes) -> bool:
    return tag.startswith(b"DIB") or not tag.strip(b"\x00")


def _gray_palette(pal) -> bool:
    """No palette, or an identity-gray one (an 8-bit DIB that is luma)."""
    return pal is None or (
        pal.shape[0] >= 256 and
        np.array_equal(pal[:256, 0], np.arange(256)) and
        np.array_equal(pal[:256, 0], pal[:256, 1]) and
        np.array_equal(pal[:256, 0], pal[:256, 2]))


def _layout(st: AviStream):
    """(format, bytes a frame's unpacking reads) of a raw-video stream, in
    the JAX package's order of tests."""
    w, h, tag = st.width, st.height, bytes(st.codec).upper()
    if tag.startswith((b"I420", b"IYUV")):
        return "i420", w * h * 3 // 2
    if tag.startswith(b"YV12"):
        return "yv12", w * h * 3 // 2
    if tag.startswith((b"YUY2", b"YUYV", b"V422", b"YUNV")):
        return "yuyv", w * h * 2
    if tag.startswith((b"UYVY", b"Y422", b"UYNV")):
        return "uyvy", w * h * 2
    if tag.startswith((b"Y800", b"GREY")) or (st.bits == 8 and _is_dib(tag)):
        if tag.startswith((b"Y800", b"GREY")) or _gray_palette(st.palette):
            return "gray", w * h
        return "pal8", ((w + 3) & ~3) * h
    if st.bits == 16 and _is_dib(tag):
        return "rgb16", ((w * 2 + 3) & ~3) * h
    if st.bits == 32 and _is_dib(tag):
        return "bgrx", w * h * 4
    if tag.startswith(b"DIB") or st.bits == 24:
        return "bgr24", ((w * 3 + 3) & ~3) * h
    raise ValueError(f"unsupported AVI video codec {st.codec!r}")


def _rgb16(px: torch.Tensor, masks) -> torch.Tensor:
    """Little-endian 16-bit pixels uint8 [..., 2 W] -> RGB uint8 [..., W,
    3]: each channel's mask shifted down and widened to 8 bits by bit
    replication (5 bits: << 3 | >> 2)."""
    v = px[..., 0::2].to(torch.int32) | px[..., 1::2].to(torch.int32) << 8
    chans = []
    for m in masks:
        shift = (m & -m).bit_length() - 1 if m else 0
        width = max(1, int(m >> shift).bit_length())
        if width > 8:
            raise ValueError(f"RGB16 channel mask {m:#x} is wider than 8 "
                             "bits")
        c = (v >> shift) & (m >> shift)
        chans.append((c << (8 - width)) | (c >> max(0, 2 * width - 8)))
    return torch.stack(chans, dim=-1).to(torch.uint8)


def _unpack(fmt: str, buf: torch.Tensor, st: AviStream, lut):
    """A batch of frames' bytes uint8 [B, frame bytes] -> (y, cb, cr) uint8
    [B, H, W], [B, H/2, W/2] x2 on buf's device."""
    b, w, h = buf.shape[0], st.width, st.height
    if fmt in ("i420", "yv12"):
        y = buf[:, :w * h].reshape(b, h, w)
        u = buf[:, w * h:w * h * 5 // 4].reshape(b, h // 2, w // 2)
        v = buf[:, w * h * 5 // 4:w * h * 3 // 2].reshape(b, h // 2, w // 2)
        return (y, u, v) if fmt == "i420" else (y, v, u)
    if fmt in ("yuyv", "uyvy"):
        pk = buf[:, :w * h * 2].reshape(b, h, w // 2, 4)
        ly, lu, lv = (0, 1, 3) if fmt == "yuyv" else (1, 0, 2)

        def rows_mean(k):          # 4:2:2 -> 4:2:0, the rounded row mean
            return ((pk[:, 0::2, :, k].to(torch.int32) + pk[:, 1::2, :, k]
                     + 1) >> 1).to(torch.uint8)

        return (pk[..., ly::2].reshape(b, h, w), rows_mean(lu),
                rows_mean(lv))
    if fmt == "gray":
        c = torch.full((b, h // 2, w // 2), 128, dtype=torch.uint8,
                       device=buf.device)
        return buf[:, :w * h].reshape(b, h, w), c, c.clone()
    if fmt == "pal8":
        row = (w + 3) & ~3
        idx = buf[:, :row * h].reshape(b, h, row)[:, :, :w].flip(1)
        rgb = lut[idx.long()][..., [2, 1, 0]]          # BGRX -> RGB
    elif fmt == "rgb16":
        row = (w * 2 + 3) & ~3
        px = buf[:, :row * h].reshape(b, h, row)[:, :, :w * 2].flip(1)
        rgb = _rgb16(px, st.bitmasks or (0x7C00, 0x3E0, 0x1F))
    elif fmt == "bgrx":
        rgb = buf[:, :w * h * 4].reshape(b, h, w, 4).flip(1)[..., [2, 1, 0]]
    else:                                               # bgr24
        row = (w * 3 + 3) & ~3
        rgb = buf[:, :row * h].reshape(b, h, row)[:, :, :w * 3].reshape(
            b, h, w, 3).flip(1).flip(3)
    return rgb_to_yuv420_bt601(rgb)


def _downsample_chroma(c: torch.Tensor) -> torch.Tensor:
    """Full-size chroma [F, H, W] -> 4:2:0 by the rounded 2x2 mean
    (libswscale's default chroma reduction)."""
    _, h, w = c.shape
    c = c[:, :h & ~1, :w & ~1].to(torch.int32)
    return ((c[:, 0::2, 0::2] + c[:, 0::2, 1::2] + c[:, 1::2, 0::2] +
             c[:, 1::2, 1::2] + 2) >> 2).to(torch.uint8)


def mjpeg_to_yuv420(y, cb, cr, w: int, h: int):
    """Decoded MJPEG planes (`codecs.mjpeg.decode_mjpeg_frames`) -> 4:2:0
    planes of a w x h stream (`amv_tpu.containers.avi.extract_yuv420`'s
    MJPG branch): interlaced frames cropped to h rows, gray with chroma
    128, 4:4:4 and 4:2:2 chroma reduced by rounded means."""
    if y.shape[1] > h:
        # interlaced: the coded height is 2 x the field height, which may
        # pad past the container's height
        ratio = 1 if cb is None else y.shape[1] // cb.shape[1]
        y = y[:, :h]
        if cb is not None:
            cb, cr = cb[:, :h // ratio], cr[:, :h // ratio]
    return _to_yuv420(y, cb, cr, w, h)


def _to_yuv420(y, cb, cr, w: int, h: int):
    """Decoded planes of a w x h stream -> 4:2:0: gray with chroma 128,
    4:4:4 and 4:2:2 chroma reduced by rounded means, others as they are."""
    if cb is None:                                      # gray
        gray = torch.full((y.shape[0], h // 2, w // 2), 128,
                          dtype=torch.uint8, device=y.device)
        return y, gray, gray.clone()
    if tuple(cb.shape[1:]) == (h, w):                   # 4:4:4
        return y, _downsample_chroma(cb), _downsample_chroma(cr)
    if tuple(cb.shape[1:]) == (h, (w + 1) // 2):        # 4:2:2
        # odd-width 4:2:2 chroma is (w + 1) // 2 wide: crop it to w // 2
        h2 = h & ~1

        def rows_mean(c):
            c = c[:, :, :w // 2].to(torch.int32)
            return ((c[:, 0:h2:2] + c[:, 1:h2:2] + 1) >> 1).to(torch.uint8)

        return y, rows_mean(cb), rows_mean(cr)
    return y, cb, cr


def extract_yuv420(st: AviStream, *, device):
    """Decode an AVI video stream's chunks to (y, cb, cr) uint8 tensors
    [F, H, W], [F, H/2, W/2] x2 on `device`, equal to the JAX package's
    planes.  Format breadth: libswscale's inputs (swscale.c
    isSupportedIn) and baseline MJPEG, as listed in the module
    docstring."""
    dev = resolve_device(device)
    w, h, n = st.width, st.height, len(st.chunks)
    if n and bytes(st.codec).upper().startswith((b"MJPG", b"JPEG")):
        from ..codecs import mjpeg
        if mjpeg._sof_field(st.chunks[0], height=False) == 0xC3:
            mode, planes = mjpeg.decode_lossless_frames(
                st.chunks, device=dev, batch_frames=BATCH_FRAMES)
            if mode == "yuv":
                return _to_yuv420(planes[0], *(planes[1:3] if len(planes)
                                               == 3 else (None, None)), w, h)
            # planes in the reference's RGB32 byte order (B, G, R)
            out = None
            for a in range(0, n, BATCH_FRAMES):
                rgb = torch.stack([planes[2][a:a + BATCH_FRAMES],
                                   planes[1][a:a + BATCH_FRAMES],
                                   planes[0][a:a + BATCH_FRAMES]], dim=-1)
                part = rgb_to_yuv420_bt601(rgb)
                if out is None:
                    out = [torch.empty((n, *p.shape[1:]), dtype=torch.uint8,
                                       device=dev) for p in part]
                for dst, p in zip(out, part):
                    dst[a:a + BATCH_FRAMES] = p
            return tuple(out)
        return mjpeg_to_yuv420(*mjpeg.decode_mjpeg_frames(
            st.chunks, org_height=h, device=dev, batch_frames=BATCH_FRAMES),
            w, h)
    planes = (torch.empty((n, h, w), dtype=torch.uint8, device=dev),
              torch.empty((n, h // 2, w // 2), dtype=torch.uint8, device=dev),
              torch.empty((n, h // 2, w // 2), dtype=torch.uint8, device=dev))
    if n == 0:
        return planes
    fmt, fb = _layout(st)
    short = [i for i, c in enumerate(st.chunks) if len(c) < fb]
    if short:
        raise ValueError(f"{st.codec!r} frames of {w}x{h} need {fb} bytes; "
                         f"chunk(s) {short[:8]} hold fewer")
    lut = None
    if fmt == "pal8":
        lut = np.zeros((256, 4), np.uint8)
        lut[:st.palette.shape[0]] = st.palette
        lut = torch.from_numpy(lut).to(dev)
    pinned = dev.type == "cuda"
    slots = [[None, None], [None, None]]   # a pinned buffer, its copy's event
    for k, a in enumerate(range(0, n, BATCH_FRAMES)):
        z = min(n, a + BATCH_FRAMES)
        slot = slots[k % 2]
        if slot[0] is None:
            slot[0] = torch.empty((min(n, BATCH_FRAMES), fb),
                                  dtype=torch.uint8, pin_memory=pinned)
        elif slot[1] is not None:
            slot[1].synchronize()           # its last copy has been read
        host = slot[0].numpy()
        for i in range(a, z):
            host[i - a] = np.frombuffer(st.chunks[i], np.uint8, fb)
        buf = slot[0][:z - a].to(dev, non_blocking=True)
        if pinned:
            slot[1] = torch.cuda.Event()
            slot[1].record()
        for dst, src in zip(planes, _unpack(fmt, buf, st, lut)):
            dst[a:z] = src
    return planes


def extract_pcm(st: AviStream, *, device) -> torch.Tensor:
    """Audio stream -> mono int16 PCM tensor [n] on `device`: PCM
    u8/s16/s24/s32, A-law/mu-law, IMA-ADPCM-WAV (0x11) and MS-ADPCM
    (0x02) through `codecs/wav_audio.py`; more channels are downmixed by
    their mean, truncated toward zero."""
    data = b"".join(st.chunks)
    fmt = struct.unpack("<H", (st.codec or b"\x01\x00")[:2])[0]
    ch = max(st.channels, 1)
    bits = 16 if fmt == 1 and st.bits in (0, 16) else st.bits
    pcm = decode_pcm_bytes(data, fmt, bits, ch, st.block_align,
                           device=device)
    return downmix(pcm) if ch > 1 else pcm


def mux(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, pcm: np.ndarray,
        fps: int, sample_rate: int, video_chunks: list[bytes] = None) -> bytes:
    """Write an AVI with I420 video + PCM s16 mono audio.

    When `video_chunks` is given they are written as MJPG-compressed
    frames (full-header baseline JPEGs, the `ffmpeg -vcodec mjpeg out.avi`
    shape) instead of raw I420 planes; y is still consulted for geometry.
    """
    F, H, W = y.shape
    if video_chunks is not None:
        fourcc, frame_bytes = b"MJPG", max(len(c) for c in video_chunks)
    else:
        fourcc, frame_bytes = b"I420", W * H * 3 // 2
    samples_per_frame = sample_rate // fps if fps else 0

    def chunk(tag, payload):
        pad = b"\x00" if len(payload) & 1 else b""
        return tag + struct.pack("<I", len(payload)) + payload + pad

    # headers
    avih = struct.pack("<14I", 1_000_000 // fps, frame_bytes * fps, 0, 0x10,
                       F, 0, 2 if len(pcm) else 1, frame_bytes, W, H, 0, 0, 0, 0)
    strh_v = (b"vids" + fourcc + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0,
              1, fps, 0, F, frame_bytes, 0xFFFFFFFF, 0)
              + struct.pack("<4h", 0, 0, W, H))
    strf_v = struct.pack("<IiiHH4sIiiII", 40, W, H, 1,
                         24 if video_chunks is not None else 12, fourcc,
                         frame_bytes, 0, 0, 0, 0)
    strl_v = b"LIST" + struct.pack(
        "<I", 4 + len(chunk(b"strh", strh_v)) + len(chunk(b"strf", strf_v))) \
        + b"strl" + chunk(b"strh", strh_v) + chunk(b"strf", strf_v)

    strls = strl_v
    if len(pcm):
        strh_a = (b"auds" + b"\x00" * 4 + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0,
                  1, sample_rate, 0, len(pcm), 2, 0xFFFFFFFF, 2)
                  + struct.pack("<4h", 0, 0, 0, 0))
        strf_a = struct.pack("<HHIIHH", 1, 1, sample_rate, sample_rate * 2, 2, 16)
        strl_a = b"LIST" + struct.pack(
            "<I", 4 + len(chunk(b"strh", strh_a)) + len(chunk(b"strf", strf_a))) \
            + b"strl" + chunk(b"strh", strh_a) + chunk(b"strf", strf_a)
        strls += strl_a

    hdrl = b"LIST" + struct.pack("<I", 4 + len(chunk(b"avih", avih)) + len(strls)) \
        + b"hdrl" + chunk(b"avih", avih) + strls

    movi = bytearray(b"movi")
    index = []  # (tag, flags, offset-from-movi-fourcc, size) for idx1
    for i in range(F):
        if video_chunks is not None:
            payload = video_chunks[i]
        else:
            payload = y[i].tobytes() + cb[i].tobytes() + cr[i].tobytes()
        index.append((b"00dc", 0x10, len(movi), len(payload)))
        movi += chunk(b"00dc", payload)
        if len(pcm):
            lo = i * samples_per_frame
            hi = min(len(pcm), (i + 1) * samples_per_frame)
            if i == F - 1:
                hi = len(pcm)
            ab = np.ascontiguousarray(pcm[lo:hi], dtype="<i2").tobytes()
            index.append((b"01wb", 0x10, len(movi), len(ab)))
            movi += chunk(b"01wb", ab)
    movi_list = b"LIST" + struct.pack("<I", len(movi)) + bytes(movi)

    # idx1 (avi_write_idx1 layout): offsets relative to the 'movi' fourcc,
    # AVIIF_KEYFRAME on every chunk (raw video is all-intra)
    idx1 = b"".join(struct.pack("<4sIII", tag, flags, ofs, sz)
                    for (tag, flags, ofs, sz) in index)
    riff_body = b"AVI " + hdrl + movi_list + chunk(b"idx1", idx1)
    return b"RIFF" + struct.pack("<I", len(riff_body)) + riff_body
