"""amvlib-shaped Python API (C-AMVDecoder/amvlib/AMVDec.h:94-109 parity):
the port of `amv_tpu/amvlib_api.py`, on a torch device.

The standalone C decoder exposes a small sequential-reader API that the
MFC GUI and console test drive:

    AMVDecoder *AmvOpen(const char *amvname);
    void  AmvClose(AMVDecoder *amv);
    int   AmvReadNextFrame(AMVDecoder *amv);
    int   AmvRewindFrameStart(AMVDecoder *amv);
    int   AmvVideoDecode(AMVDecoder *amv);
    int   AmvAudioDecode(AMVDecoder *amv);
    int   AmvCreateJpegFileFromFrameBuffer(AMVDecoder *amv, const char *dir);
    int   AmvCreateJpegFileFromBuffer(AMVInfo*, FRAMEBUFF*, const char *file);
    int   AmvConvertJpegFileToBmpFile(const char *jpg, const char *bmp);
    int   AmvCreateWavFileFromAmvFile(AMVDecoder *amv, int type, const char *wav);

This module keeps that call surface (names, return conventions: 0 = ok,
negative = error, same as AMVDec.c) so code written against amvlib ports
mechanically, while the work runs on the decoder's device (`AmvOpen(...,
device="cuda")` by default; a missing card raises):

* AmvVideoDecode fills ``videobuf`` with bottom-up BGR rows exactly like
  amvlib's StoreBuffer (AmvJpeg.c:789-840), with amvlib's decode semantics
  (its ~Q75 quant tables, Wang IDCT and fixed-point YUV->BGR): kernels D
  and W through `codecs/amvlib_video.decode_frames_amvlib_rgb`.
* AmvAudioDecode fills ``audiobuf`` with int16 PCM through kernel A; like
  AMVDec.c:288-340 every nibble byte present is decoded (the chunk
  header's sample count only sizes the buffer).
* AmvCreateWavFileFromAmvFile supports both AUDIO_FILE_TYPE_PCM (kernel A)
  and AUDIO_FILE_TYPE_ADPCM_IMA (raw-ADPCM 'fact' WAV, AMVDec.c:384-547).
* AmvConvertJpegFileToBmpFile decodes through `codecs/mjpeg.py` and
  `kernels/color.py` on its `device`.

Frame stepping reads from the pre-demuxed chunk lists rather than
re-seeking the file per frame; ``dataseekpos``/``fileseekpos`` become a
frame cursor, and end-of-stream mirrors the C behavior (AMVDec.c:173-190:
after AMV_END_ the frame buffers come back empty with framenum = -1 and
the call still returns 0).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np
import torch

from .containers import riff, wav
from .pipeline import resolve_device

AUDIO_FILE_TYPE_PCM = 0
AUDIO_FILE_TYPE_ADPCM_IMA = 1


@dataclass
class FrameBuff:
    """FRAMEBUFF analog (AMVDec.h:49-57)."""
    videobuff: bytes | None = None
    audiobuff: bytes | None = None
    framenum: int = -1

    @property
    def videobufflen(self) -> int:
        return len(self.videobuff) if self.videobuff else 0

    @property
    def audiobufflen(self) -> int:
        return len(self.audiobuff) if self.audiobuff else 0


@dataclass
class AMVDecoder:
    """AMVDecoder analog (AMVDec.h:74-91)."""
    amvfilename: str
    amvinfo: riff.AmvInfo
    streams: riff.AmvStreams
    opened: bool = True
    currentframe: int = 0
    totalframe: int = 0
    framebuf: FrameBuff = field(default_factory=FrameBuff)
    videobuf: np.ndarray | None = None   # bottom-up BGR uint8 [H, W, 3]
    audiobuf: np.ndarray | None = None   # int16 PCM
    device: torch.device = torch.device("cuda")   # where the decodes run
    _cursor: int = 0                     # frame index (dataseekpos analog)


def AmvOpen(amvname: str, device="cuda") -> AMVDecoder | None:
    """Open + validate an AMV file (AMVDec.c:15-129). None on failure.  The
    decoder's work runs on `device`; a CUDA device without a card raises
    RuntimeError."""
    dev = resolve_device(device)
    try:
        streams = riff.read(amvname)
    except (OSError, ValueError):
        return None
    info = streams.info
    amv = AMVDecoder(amvfilename=amvname, amvinfo=info, streams=streams,
                     device=dev)
    # totalframe = duration * fps (AMVDec.c:112-114), NOT the chunk count
    amv.totalframe = info.duration_sec * info.fps_num
    return amv


def AmvClose(amv: AMVDecoder | None) -> None:
    if amv is not None:
        amv.opened = False
        amv.framebuf = FrameBuff()
        amv.videobuf = None
        amv.audiobuf = None


def AmvReadNextFrame(amv: AMVDecoder) -> int:
    """Advance to the next video+audio chunk pair (AMVDec.c:150-238)."""
    if amv is None or not amv.opened:
        return -1
    i = amv._cursor
    if i >= len(amv.streams.video_chunks) or \
            i >= len(amv.streams.audio_chunks):
        # AMV_END_ reached: clear buffers, framenum=-1, return 0
        amv.framebuf = FrameBuff()
        return 0
    amv.framebuf.videobuff = amv.streams.video_chunks[i]
    amv.framebuf.audiobuff = amv.streams.audio_chunks[i]
    amv.framebuf.framenum = i
    amv.currentframe = i
    amv._cursor = i + 1
    return 0


def AmvRewindFrameStart(amv: AMVDecoder) -> int:
    """Seek back to the first movi chunk (AMVDec.c:240-257)."""
    if amv is None or not amv.opened:
        return -1
    amv._cursor = 0
    return 0


def AmvVideoDecode(amv: AMVDecoder) -> int:
    """Decode framebuf.videobuff to bottom-up BGR (AMVDec.c:259-286).

    Uses the amvlib decode semantics (Q75-ish tables + Wang IDCT +
    fixed-point YUV->BGR, AmvJpeg.c:1515/789-840) on the decoder's device;
    rows are stored bottom-up so the AMV flip cancels, exactly like
    StoreBuffer's BMP-order writes.
    """
    if amv is None or not amv.opened:
        return -1
    fb = amv.framebuf
    if not fb.videobuff:
        return -1
    from .codecs.amvlib_video import decode_frames_amvlib_rgb
    info = amv.amvinfo
    rgb = decode_frames_amvlib_rgb([fb.videobuff], info.width, info.height,
                                   device=amv.device)[0]
    # bottom-up rows, BGR byte order
    amv.videobuf = rgb.flip(0).flip(-1).cpu().numpy()
    return 0


def AmvAudioDecode(amv: AMVDecoder) -> int:
    """Decode framebuf.audiobuff to int16 PCM (AMVDec.c:288-340)."""
    if amv is None or not amv.opened:
        return -1
    fb = amv.framebuf
    if not fb.audiobuff or fb.audiobufflen < 8:
        return -1
    from .codecs.amv_audio import decode_chunks
    amv.audiobuf = decode_chunks([fb.audiobuff], device=amv.device)
    return 0


def AmvCreateJpegFileFromBuffer(amvinfo: riff.AmvInfo, framebuf: FrameBuff,
                                filename: str) -> int:
    """Write one frame as a standalone JPEG (AMVDec.c:342-374 semantics:
    canonical header + raw scan bytes with the SOI/EOI wrapper restored)."""
    if not framebuf.videobuff:
        return -1
    from .codecs.jpeg_tables import canned_jpeg_header
    payload = framebuf.videobuff
    try:
        with open(filename, "wb") as f:
            f.write(canned_jpeg_header(amvinfo.width, amvinfo.height))
            f.write(payload[2:len(payload) - 2])
            f.write(b"\xFF\xD9")
    except OSError:
        return -2
    return 0


def AmvCreateJpegFileFromFrameBuffer(amv: AMVDecoder, dirname: str) -> int:
    """Write the current frame as <dir>/<framenum>.jpg (AMVDec.c:342-374)."""
    if amv is None or not amv.opened or amv.framebuf.framenum < 0:
        return -1
    path = os.path.join(dirname, f"{amv.framebuf.framenum}.jpg")
    return AmvCreateJpegFileFromBuffer(amv.amvinfo, amv.framebuf, path)


def AmvConvertJpegFileToBmpFile(jpgname: str, bmpname: str,
                                device="cuda") -> int:
    """Decode a (canonical-AMV) JPEG file on `device` and write a 24-bit
    BMP.

    amvlib pairs its JPEG export with this converter (AMVDec.h:106);
    the frame inside is upside-down by AMV convention, and BMP rows are
    bottom-up, so writing decode output in file order shows it upright —
    same cancellation StoreBuffer exploits.  A file that does not parse
    as a baseline JPEG returns -1, as in the JAX package.
    """
    try:
        with open(jpgname, "rb") as f:
            data = f.read()
    except OSError:
        return -1
    from .codecs.mjpeg import decode_mjpeg_frames
    dev = resolve_device(device)
    try:
        y, cb, cr = (p[0] if p is not None else None
                     for p in decode_mjpeg_frames([data], device=dev))
    except (ValueError, IndexError, KeyError, struct.error):
        return -1   # not a JPEG the decoder parses
    if cb is None or tuple(cb.shape) != (y.shape[0] // 2, y.shape[1] // 2):
        return -1  # amvlib's converter handles its own 4:2:0 exports only
    h, w = y.shape
    # 4:2:0 upsample + BT.601 full-range like the CLI's .bmp export
    from .kernels.color import yuv420_to_rgb
    rgb = yuv420_to_rgb(y[None], cb[None], cr[None])[0].cpu().numpy()
    row = (w * 3 + 3) & ~3
    img = np.zeros((h, row), dtype=np.uint8)
    img[:, :w * 3] = rgb[:, :, ::-1].reshape(h, w * 3)  # file order = bottom-up
    hdr = b"BM" + struct.pack("<IHHI", 54 + img.size, 0, 0, 54)
    hdr += struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, img.size,
                       2835, 2835, 0, 0)
    try:
        with open(bmpname, "wb") as f:
            f.write(hdr + img.tobytes())
    except OSError:
        return -2
    return 0


def AmvCreateWavFileFromAmvFile(amv: AMVDecoder, type: int,
                                wavfile: str) -> int:
    """Export the audio stream as WAV (AMVDec.c:384-547).

    type 0 (PCM): decode every chunk (kernel A, one launch) -> s16 WAV;
    type 1 (ADPCM): stream-copy the raw chunks under wFormatTag=0x11 with
    a 'fact' total-sample header.
    """
    if amv is None or not amv.opened:
        return -1
    chunks = amv.streams.audio_chunks
    info = amv.amvinfo
    try:
        if type == AUDIO_FILE_TYPE_PCM:
            from .codecs.amv_audio import decode_chunks
            pcm = decode_chunks(chunks, device=amv.device)
            wav.write_pcm(wavfile, pcm, info.sample_rate, info.channels)
        elif type == AUDIO_FILE_TYPE_ADPCM_IMA:
            wav.write_adpcm_raw(wavfile, chunks, info.sample_rate,
                                info.channels)
        else:
            return -1
    except OSError:
        return -2
    return 0
