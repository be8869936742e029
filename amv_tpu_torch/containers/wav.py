"""WAV import/export of 16-bit PCM (the counterpart of `amv_tpu/
containers/wav.py`'s `write_pcm` and the 16-bit PCM route of its
`read_pcm`).  Any other format tag or sample width is not yet ported and
raises."""

from __future__ import annotations

import struct

import numpy as np


def write_pcm(path: str, pcm: np.ndarray, sample_rate: int,
              channels: int = 1):
    """Write int16 samples as a canonical 44-byte-header PCM WAV."""
    data = np.asarray(pcm, dtype="<i2").tobytes()
    block_align = 2 * channels
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, sample_rate,
                                 sample_rate * block_align, block_align, 16)
    hdr += b"data" + struct.pack("<I", len(data))
    with open(path, "wb") as f:
        f.write(hdr + data)


def read_pcm(path: str):
    """16-bit PCM WAV -> (pcm int16 [n] or [n, channels], sample rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a WAV file")
    pos = 12
    fmt = pcm = None
    while pos + 8 <= len(data):
        tag = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8:pos + 8 + size]
        if tag == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
        elif tag == b"data":
            pcm = body
        pos += 8 + size + (size & 1)
    if fmt is None or pcm is None:
        raise ValueError("missing fmt/data chunk")
    audio_fmt, channels, rate, _, _, bits = fmt
    if channels < 1:
        raise ValueError("WAV fmt declares zero channels")
    if audio_fmt != 1 or bits != 16:
        raise NotImplementedError(
            f"WAV format tag {audio_fmt} with {bits}-bit samples is not yet "
            "ported: only 16-bit PCM (ROADMAP queue 1, item 7)")
    samples = np.frombuffer(pcm[:len(pcm) & ~1], dtype="<i2")
    samples = samples[:len(samples) // channels * channels]
    if channels > 1:
        samples = samples.reshape(-1, channels)
    return samples, rate
