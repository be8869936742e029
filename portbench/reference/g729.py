"""The G.729A reference: the frozen C decoder (g729_ref.c) on a few
threads, the ACT container as FFmpeg reads and writes it, and a plain
PCM WAV reader.

The ACT layout is FFmpeg's libavformat/act.c: a WAVE-like header, a
duration record at offset 256 (tag 0x84, msec le16, sec u8, minutes
le32), then chunks of 512 bytes from offset 512, each 51 frames of 10
bytes and 2 unused; every frame's bytes are stored permuted (act.c:84-93
write side, 210-219 read side); the writer pads the last chunk with zero
frames, a whole zero chunk when the frames end on a chunk's end.
"""

from __future__ import annotations

import ctypes
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import library

PERM_READ = np.array([5, 0, 6, 1, 7, 2, 8, 3, 9, 4])
PERM_WRITE = np.array([1, 3, 5, 7, 9, 0, 2, 4, 6, 8])
CHUNK, FRAMES_A_CHUNK, FRAME_BYTES = 512, 51, 10


def _lib():
    lib = library("g729_ref")
    if not hasattr(lib, "_pb_ready"):
        lib.pb_g729_decode.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_void_p]
        lib.pb_g729_decode.restype = ctypes.c_int64
        lib._pb_ready = True
    return lib


def decode(frames: np.ndarray) -> np.ndarray:
    """Packed frames uint8 [n, 10] of one stream -> int16 PCM [n * 80].
    Raises where the reference's arithmetic is undefined."""
    f = np.ascontiguousarray(frames, np.uint8).reshape(-1, FRAME_BYTES)
    pcm = np.zeros(len(f) * 80, np.int16)
    rc = _lib().pb_g729_decode(f.ctypes.data, len(f), pcm.ctypes.data)
    if rc:
        raise ValueError(f"reference decode undefined at frame {-rc - 1}")
    return pcm


def decode_many(streams, threads: int = 8) -> list:
    """decode() of each stream, on `threads` threads (the C call drops the
    GIL)."""
    _lib()
    with ThreadPoolExecutor(threads) as ex:
        return list(ex.map(decode, streams))


def defined_many(streams, threads: int = 8) -> list:
    """For each stream, whether the reference decodes it without an
    undefined step."""
    lib = _lib()

    def ok(frames):
        f = np.ascontiguousarray(frames, np.uint8).reshape(-1, FRAME_BYTES)
        pcm = np.empty(len(f) * 80, np.int16)
        return lib.pb_g729_decode(f.ctypes.data, len(f), pcm.ctypes.data) == 0

    with ThreadPoolExecutor(threads) as ex:
        return list(ex.map(ok, streams))


def control(pcm: np.ndarray) -> np.ndarray:
    """The control: the reference's output carried in 8 bits (each
    sample's low byte cleared), the precision below its 16."""
    return (np.asarray(pcm, np.int16) & np.int16(-256)).astype(np.int16)


def act_mux(frames: np.ndarray, sample_rate: int = 8000) -> bytes:
    """An ACT file of packed frames uint8 [n, 10]."""
    f = np.asarray(frames, np.uint8).reshape(-1, FRAME_BYTES)
    n = len(f)
    n_chunks = n // FRAMES_A_CHUNK + 1
    slots = np.zeros((n_chunks * FRAMES_A_CHUNK, FRAME_BYTES), np.uint8)
    slots[:n] = f[:, PERM_WRITE]
    body = np.zeros((n_chunks, CHUNK), np.uint8)
    body[:, :FRAMES_A_CHUNK * FRAME_BYTES] = slots.reshape(n_chunks, -1)
    hdr = bytearray(512)
    size = 512 + body.size
    hdr[0:4], hdr[8:12], hdr[12:16], hdr[36:40] = (b"RIFF", b"WAVE",
                                                   b"fmt ", b"data")
    struct.pack_into("<I", hdr, 4, size - 8)
    struct.pack_into("<IHHIIHH", hdr, 16, 16, 1, 1, sample_rate,
                     sample_rate * 2, 2, 16)
    struct.pack_into("<I", hdr, 40, size - 44)
    ms = n * 80 * 1000 // sample_rate
    hdr[256] = 0x84
    struct.pack_into("<H", hdr, 257, ms % 1000)
    hdr[259] = (ms // 1000) % 60
    struct.pack_into("<I", hdr, 260, ms // 60000)
    return bytes(hdr) + body.tobytes()


def act_demux(data: bytes) -> np.ndarray:
    """Every whole chunk's frames, uint8 [n, 10] (act.c reads to the end:
    the writer's zero padding decodes as erasures)."""
    if data[0:4] != b"RIFF" or data[8:12] != b"WAVE" or data[256] != 0x84:
        raise ValueError("not an ACT file")
    n_chunks = (len(data) - 512) // CHUNK
    chunks = np.frombuffer(data, np.uint8, n_chunks * CHUNK,
                           512).reshape(n_chunks, CHUNK)
    return chunks[:, :FRAMES_A_CHUNK * FRAME_BYTES].reshape(
        -1, FRAME_BYTES)[:, PERM_READ]


def wav_pcm(data: bytes, sample_rate: int) -> np.ndarray:
    """The samples of a canonical 44-byte-header mono 16-bit PCM WAV at
    sample_rate; raises on any other header."""
    want = (b"RIFF", b"WAVE", b"fmt ", 16, 1, 1, sample_rate,
            sample_rate * 2, 2, 16, b"data")
    got = (data[0:4], data[8:12], data[12:16],
           *struct.unpack_from("<IHHIIHH", data, 16), data[36:40])
    n = struct.unpack_from("<I", data, 40)[0]
    if got != want or len(data) != 44 + n or \
            struct.unpack_from("<I", data, 4)[0] != 36 + n:
        raise ValueError(f"unexpected WAV header {got}")
    return np.frombuffer(data, "<i2", n // 2, 44)
