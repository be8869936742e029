"""The AMV reference: the frozen C codec (amv_ref.c) over many frames on a
few threads, and a plain AMV muxer.

`mux` is a frozen copy of the layout of FFmpeg's AMV muxer
(libavformat/amvenc.c:116-344, as amv_tpu/containers/riff.py reproduces
it byte for byte): the fixed 0x138-byte header, strictly alternating
'00dc' / '01wb' chunks starting with video with no padding, "AMV_END_",
and the back-patched counters.
"""

from __future__ import annotations

import ctypes
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import library

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_OUT_CAP = 1 << 20          # bytes a frame may take (160x120: ~3 KB)


def _lib():
    lib = library("amv_ref")
    if not hasattr(lib, "_pb_ready"):
        lib.pb_encode_frames.argtypes = [_P, _P, _P, _I64, _I, _I, _I, _P,
                                         _I64, _P]
        lib.pb_encode_frames.restype = _I64
        lib.pb_transcode_frame.argtypes = [_P, _I64, _I, _I, _I, _I, _P,
                                           _I64]
        lib.pb_transcode_frame.restype = _I64
        lib.pb_scan_bytes.argtypes = [_P, _I64]
        lib.pb_scan_bytes.restype = _I64
        lib.pb_init()
        lib._pb_ready = True
    return lib


def _split(n: int, parts: int):
    step = -(-n // max(1, parts))
    return [(a, min(n, a + step)) for a in range(0, n, step)]


def encode_pictures(y, cb, cr, qscale: int, threads: int = 8) -> list:
    """AMV frames (bytes) of pictures y [n, h, w], cb, cr [n, h/2, w/2]."""
    lib = _lib()
    n, h, w = y.shape
    y, cb, cr = (np.ascontiguousarray(a, np.uint8) for a in (y, cb, cr))

    def part(ab):
        a, b = ab
        out = np.empty((b - a) * 16384 + _OUT_CAP, np.uint8)
        lens = np.zeros(b - a, np.int64)
        rc = lib.pb_encode_frames(y[a:].ctypes.data, cb[a:].ctypes.data,
                                  cr[a:].ctypes.data, b - a, w, h, qscale,
                                  out.ctypes.data, out.size, lens.ctypes.data)
        if rc < 0:
            raise RuntimeError(f"reference encode failed ({rc})")
        offs = np.concatenate([[0], np.cumsum(lens)])
        return [out[offs[i]:offs[i + 1]].tobytes() for i in range(b - a)]

    with ThreadPoolExecutor(threads) as ex:
        return [f for p in ex.map(part, _split(n, threads)) for f in p]


def transcode_frames(payloads, width: int, height: int, qscale: int,
                     drop_bits: int = 0, threads: int = 8) -> list:
    """Each frame decoded and re-encoded at qscale by the reference (with
    drop_bits, the control); a frame it rejects raises."""
    lib = _lib()

    def part(ab):
        a, b = ab
        buf = np.empty(_OUT_CAP, np.uint8)
        res = []
        for i in range(a, b):
            p = bytes(payloads[i])
            k = lib.pb_transcode_frame(p, len(p), width, height, qscale,
                                       drop_bits, buf.ctypes.data, buf.size)
            if k < 0:
                raise ValueError(f"reference rejects frame {i} ({k})")
            res.append(buf[:k].tobytes())
        return res

    with ThreadPoolExecutor(threads) as ex:
        return [f for p in ex.map(part, _split(len(payloads), threads))
                for f in p]


def scan_bytes(payload) -> int:
    """The bytes of a frame's scan without its markers and stuffing."""
    p = bytes(payload)
    return int(_lib().pb_scan_bytes(p, len(p)))


def mux(video, audio, *, width: int, height: int, fps: int,
        sample_rate: int, audio_bit_rate: int = 64000) -> bytes:
    """An .amv file of the video and audio chunks, as FFmpeg's muxer
    writes it."""
    nv, na = len(video), len(audio)
    audio_bytes = sum(len(c) for c in audio)
    dur = nv // fps
    u32, u16 = (lambda v: struct.pack("<I", v & 0xFFFFFFFF),
                lambda v: struct.pack("<H", v & 0xFFFF))
    movi = []
    vi = ai = 0
    last = 1
    while vi < nv or ai < na:
        if (last == 1 and vi < nv) or ai >= na:
            movi += [b"00dc", u32(len(video[vi])), video[vi]]
            vi, last = vi + 1, 0
        else:
            movi += [b"01wb", u32(len(audio[ai])), audio[ai]]
            ai, last = ai + 1, 1
    movi_len = 4 + sum(len(x) for x in movi)
    amvh = b"".join([
        b"amvh", u32(56), u32(1_000_000 // fps), u32(audio_bit_rate // 8),
        u32(0), u32(0x800 | 0x100 | 0x10), u32(nv), u32(0), u32(2),
        u32(1 << 20), u32(width), u32(height), u32(fps), u32(1), u32(0),
        bytes([dur % 60, (dur // 60) & 0xFF]), u16(dur // 3600)])
    vstrh = b"".join([
        b"vids", u32(0), u32(0), u16(0), u16(0), u32(0), u32(1), u32(fps),
        u32(0), u32(nv), u32(1 << 20), u32(0xFFFFFFFF), u32(0), u32(0),
        u16(width), u16(height)])
    vstrl = b"".join([b"strl", b"strh", u32(len(vstrh)), vstrh,
                      b"strf", u32(36), bytes(36)])
    astrh = b"".join([
        b"auds", u32(1), u32(0), u16(0), u16(0), u32(0), u32(1), u32(fps),
        u32(0), u32(audio_bytes // 2), u32(2), u32(0), u16(0), u16(0)])
    astrf = b"".join([u16(1), u16(1), u32(sample_rate),
                      u32(audio_bit_rate // 8), u16(2), u16(16), u32(0)])
    astrl = b"".join([b"strl", b"strh", u32(len(astrh)), astrh,
                      b"strf", u32(len(astrf)), astrf])
    hdrl = b"".join([b"hdrl", amvh, b"LIST", u32(len(vstrl)), vstrl,
                     b"LIST", u32(len(astrl)), astrl])
    head = b"".join([b"AMV ", b"LIST", u32(len(hdrl)), hdrl,
                     b"LIST", u32(movi_len), b"movi"])
    if len(head) + 8 != 0x13C:
        raise AssertionError(f"movi at 0x{len(head) + 4:x}, not 0x138")
    riff_len = len(head) + movi_len - 4 + 8
    return b"".join([b"RIFF", u32(riff_len), head, *movi, b"AMV_END_"])
