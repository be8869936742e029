"""Multi-file batched decode: one device dispatch for many .amv files.

The counterpart of `amv_tpu/pipeline/batch.py`: the video frames of all
files of one geometry decode as one batch (kernel D, the DC prediction
and kernel U once for the group, `codecs.amv_video.decode_frames`); the
audio decodes file by file through kernel A, as the JAX package does.
"""

from __future__ import annotations

import numpy as np

from ..codecs import amv_audio, amv_video
from ..containers import riff
from . import resolve_device
from .decode import DecodedAmv


def decode_many(datas: list[bytes], *, device) -> list[DecodedAmv]:
    """Decode several AMV files on `device`; the video of same-geometry
    files shares one device dispatch.  `amv_tpu.pipeline.batch.
    decode_many`'s contract: one DecodedAmv per file, in order."""
    dev = resolve_device(device)
    streams = [riff.demux(d) for d in datas]
    groups: dict[tuple, list[int]] = {}
    for i, s in enumerate(streams):
        groups.setdefault((s.info.width, s.info.height), []).append(i)

    results: list[DecodedAmv | None] = [None] * len(datas)
    for (w, h), idxs in groups.items():
        payloads = [p for i in idxs for p in streams[i].video_chunks]
        if payloads:
            y, cb, cr = amv_video.decode_frames(payloads, w, h, device=dev)
        else:
            y = np.zeros((0, h, w), np.uint8)
            cb = cr = np.zeros((0, h // 2, w // 2), np.uint8)
        off = 0
        for i in idxs:
            s = streams[i]
            n = len(s.video_chunks)
            pcm = (amv_audio.decode_chunks(s.audio_chunks, device=dev)
                   if s.audio_chunks else np.zeros(0, np.int16))
            results[i] = DecodedAmv(info=s.info, y=y[off:off + n],
                                    cb=cb[off:off + n], cr=cr[off:off + n],
                                    pcm=pcm)
            off += n
    return results
