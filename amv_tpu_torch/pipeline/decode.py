"""End-to-end AMV decode: .amv bytes -> YUV420 frames + PCM, on a device.

The counterpart of `amv_tpu/pipeline/decode.py`: RIFF demux on the host,
video through kernels D and U (`codecs.amv_video.decode_frames`), audio
through kernel A (`codecs.amv_audio.decode_chunks`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..codecs import amv_audio, amv_video
from ..containers import riff
from . import resolve_device


@dataclass
class DecodedAmv:
    info: riff.AmvInfo
    y: np.ndarray    # uint8 [F, H, W]
    cb: np.ndarray   # uint8 [F, H/2, W/2]
    cr: np.ndarray   # uint8 [F, H/2, W/2]
    pcm: np.ndarray  # int16 [n_samples]


def decode_bytes(data: bytes, *, video=True, audio=True,
                 max_frames: int | None = None, start_frame: int = 0,
                 device) -> DecodedAmv:
    """Decode an AMV file on `device`.  start_frame seeks: AMV frames are
    intra-only and each audio chunk header resets the codec state, so
    decode can begin at any chunk; max_frames caps the video frames and
    the audio chunks alike."""
    dev = resolve_device(device)
    s = riff.demux(data)
    info = s.info
    vchunks = s.video_chunks[start_frame:]
    achunks = s.audio_chunks[start_frame:]
    if max_frames:
        vchunks, achunks = vchunks[:max_frames], achunks[:max_frames]
    if video and vchunks:
        y, cb, cr = amv_video.decode_frames(vchunks, info.width, info.height,
                                            device=dev)
    else:
        y = np.zeros((0, info.height, info.width), np.uint8)
        cb = np.zeros((0, info.height // 2, info.width // 2), np.uint8)
        cr = cb.copy()
    pcm = (amv_audio.decode_chunks(achunks, device=dev) if audio and achunks
           else np.zeros(0, np.int16))
    return DecodedAmv(info=info, y=y, cb=cb, cr=cr, pcm=pcm)


def decode_file(path: str, **kw) -> DecodedAmv:
    with open(path, "rb") as f:
        return decode_bytes(f.read(), **kw)
