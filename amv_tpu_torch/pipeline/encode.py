"""End-to-end AMV encode: raw YUV420 frames + PCM -> .amv bytes, on a
device.

The counterpart of `amv_tpu/pipeline/encode.py`, the canonical reference
invocation `ffmpeg -i in.avi -f amv -r 16 -s 160x120 -ac 1 -ar 22050
out.amv` (AMVmuxer/Makefile:25-27): video through kernels V and E
(`codecs.amv_video.encode_frames`), mono ADPCM audio through kernel Q
(`codecs.amv_audio.encode_stream`; trellis=True adds kernel L's Viterbi
quantizer) with a per-chunk sample budget that tracks the frame rate (frame_size = av_rescale(sample_rate, 1, fps),
amvenc.c:276-281).
"""

from __future__ import annotations

import numpy as np
import torch

from ..codecs import amv_audio, amv_video
from ..containers import riff
from . import resolve_device


def av_rescale_near(a: int, b: int, c: int) -> int:
    """av_rescale with AV_ROUND_NEAR_INF (round half away from zero)."""
    return (2 * a * b + c) // (2 * c)


def encode_to_bytes(y, cb, cr, pcm, *, fps: int = 16,
                    sample_rate: int = 22050, qscale: int = 2,
                    trellis: bool = False, quant: str = "ffmpeg",
                    device) -> bytes:
    """Encode video frames + PCM into a complete .amv file on `device`;
    byte-identical to `amv_tpu.pipeline.encode.encode_to_bytes`.  The
    planes (uint8 [F, H, W], [F, H/2, W/2] x2) and the PCM (int16 [n]) are
    numpy arrays or tensors: planes already on the device go to kernel V
    from there."""
    dev = resolve_device(device)
    _, h, w = y.shape
    video_chunks = amv_video.encode_frames(y, cb, cr, qscale=qscale,
                                           quant=quant, device=dev)
    frame_size = av_rescale_near(sample_rate, 1, fps)
    if isinstance(pcm, torch.Tensor):
        pcm = pcm.cpu().numpy()
    audio_chunks = amv_audio.encode_stream(
        np.asarray(pcm, np.int16), frame_size, sample_rate, trellis=trellis,
        device=dev)
    return riff.mux(video_chunks, audio_chunks, width=w, height=h, fps=fps,
                    sample_rate=sample_rate)


def encode_to_file(path: str, *args, **kw) -> int:
    data = encode_to_bytes(*args, **kw)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)
