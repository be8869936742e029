"""WAV import/export: the counterpart of `amv_tpu/containers/wav.py`'s
`write_pcm`, `write_adpcm_raw` (`-acodec copy`) and `read_pcm`.
`read_pcm` decodes every format the reference's WAV ingest accepts on a
device, through `codecs/wav_audio.py`."""

from __future__ import annotations

import struct

import numpy as np

from ..codecs.wav_audio import decode_pcm_bytes


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


def write_adpcm_raw(path: str, chunks: list[bytes], sample_rate: int,
                    channels: int = 1):
    """Raw IMA-ADPCM WAV with a fact header (AMVDec.c:447-530 layout): the
    '01wb' payloads stream-copied, their 8-byte headers included, under
    wFormatTag 0x11; the fact chunk sums the headers' sample counts."""
    data = b"".join(chunks)
    total_samples = sum(
        struct.unpack_from("<I", c, 4)[0] for c in chunks if len(c) >= 8)
    block_align = 2 * channels
    hdr = b"RIFF" + struct.pack("<I", 4 + 26 + 12 + 8 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHHHH", 18, 0x11, channels,
                                 sample_rate, sample_rate // 2, block_align,
                                 4, 0, 0)
    hdr += b"fact" + struct.pack("<II", 4, total_samples)
    hdr += b"data" + struct.pack("<I", len(data))
    with open(path, "wb") as f:
        f.write(hdr + data)


def read_pcm(path: str, *, device):
    """WAV -> (pcm int16 tensor [n] or [n, channels] on `device`, sample
    rate): PCM u8/s16/s24/s32, A-law, mu-law (pcm.c:380-470), IMA-ADPCM-WAV
    (tag 0x11) and MS-ADPCM (tag 0x02) blocks (adpcm.c:983-1106)."""
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
    audio_fmt, channels, rate, _, block_align, bits = fmt
    if channels < 1:
        raise ValueError("WAV fmt declares zero channels")
    return decode_pcm_bytes(pcm, audio_fmt, bits, channels, block_align,
                            device=device), rate
