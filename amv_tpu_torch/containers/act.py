"""ACT dictaphone container (G.729A frames): the port of
`amv_tpu/containers/act.py`, the same bytes out, with numpy in place of a
Python loop a byte.

Reference: AMVmuxer/ffmpeg/libavformat/act.c.  Layout: a WAVE-like
header, an ACT duration record at offset 256 (tag 0x84, msec le16, sec u8,
minutes le32), audio data from offset 512 in chunks of 512 bytes, each
holding 51 frames of 10 bytes and 2 unused bytes.  Every frame's bytes are
stored permuted (act.c:210-219 read side, :84-93 write side).  The
writer's trailer pads to a whole chunk, a full zero chunk when the data
is already aligned, so a file always ends in zero frames, which decode as
erasures (act.c reads to the end).
"""

from __future__ import annotations

import struct

import numpy as np

from ..utils.profiling import span

# packet[i] = frame_byte[PERM_READ[i]] (act_read_packet)
PERM_READ = [5, 0, 6, 1, 7, 2, 8, 3, 9, 4]
# file_byte[i] = packet[PERM_WRITE[i]] (act_write_packet)
PERM_WRITE = [1, 3, 5, 7, 9, 0, 2, 4, 6, 8]

CHUNK_SIZE = 512
FRAMES_A_CHUNK = 51
FRAME_BYTES = 10


def probe(data: bytes) -> bool:
    if len(data) < 512:
        return False
    if data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        return False
    if struct.unpack_from("<I", data, 16)[0] != 16:
        return False
    return data[256] == 0x84


def demux(data: bytes):
    """-> (frames uint8 [N, 10], sample_rate, duration_csec); every whole
    chunk's 51 frames, a partial last chunk dropped (act.c)."""
    with span("act.demux"):
        if not probe(data):
            raise ValueError("not an ACT file")
        sample_rate = struct.unpack_from("<I", data, 24)[0]
        msec = struct.unpack_from("<H", data, 257)[0]
        sec = data[259]
        minutes = struct.unpack_from("<I", data, 260)[0]
        duration_csec = (minutes * 60 + sec) * 100 + msec // 10
        n_chunks = (len(data) - 512) // CHUNK_SIZE
        chunks = np.frombuffer(data, np.uint8, n_chunks * CHUNK_SIZE,
                               512).reshape(n_chunks, CHUNK_SIZE)
        frames = chunks[:, :FRAMES_A_CHUNK * FRAME_BYTES].reshape(
            -1, FRAME_BYTES)[:, PERM_READ]
        return frames, sample_rate, duration_csec


def mux(frames: np.ndarray, sample_rate: int = 8000) -> bytes:
    """An ACT file of packed G.729 frames uint8 [N, 10] (act_write_*)."""
    with span("act.mux"):
        f = np.asarray(frames, np.uint8).reshape(-1, FRAME_BYTES)
        n = len(f)
        # the frames fill chunks of 51; the trailer pads the last chunk out, or
        # adds a whole zero chunk when the frames end on a chunk's end
        n_chunks = n // FRAMES_A_CHUNK + 1
        slots = np.zeros((n_chunks * FRAMES_A_CHUNK, FRAME_BYTES), np.uint8)
        slots[:n] = f[:, PERM_WRITE]
        body = np.zeros((n_chunks, CHUNK_SIZE), np.uint8)
        body[:, :FRAMES_A_CHUNK * FRAME_BYTES] = slots.reshape(n_chunks, -1)
        hdr = bytearray(512)
        size = 512 + body.size
        hdr[0:4] = b"RIFF"
        struct.pack_into("<I", hdr, 4, size - 8)
        hdr[8:12] = b"WAVE"
        hdr[12:16] = b"fmt "
        struct.pack_into("<IHHIIHH", hdr, 16, 16, 1, 1, sample_rate,
                         sample_rate * 2, 2, 16)
        hdr[36:40] = b"data"
        struct.pack_into("<I", hdr, 40, size - 44)
        # duration record: frames * 80 samples at sample_rate
        duration_ms = (n * 80 * 1000) // sample_rate
        hdr[256] = 0x84
        struct.pack_into("<H", hdr, 257, duration_ms % 1000)
        duration_s = duration_ms // 1000
        hdr[259] = duration_s % 60
        struct.pack_into("<I", hdr, 260, duration_s // 60)
        return bytes(hdr) + body.tobytes()


def to_itu_bitstream(frames: np.ndarray) -> bytes:
    """ACT frames uint8 [N, 10] -> the ITU .BIT serial format
    (G.729/act2bit.c): per frame the sync word 0x6b21, the count 80, then
    80 soft bits (0x81 for a 1, 0x7f for a 0), each le16."""
    f = np.asarray(frames, np.uint8).reshape(-1, FRAME_BYTES)
    out = np.empty((len(f), 82), "<u2")
    out[:, 0], out[:, 1] = 0x6B21, 80
    out[:, 2:] = np.where(np.unpackbits(f, axis=1) != 0, 0x81, 0x7F)
    return out.tobytes()
