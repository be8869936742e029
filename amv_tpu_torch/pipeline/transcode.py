"""The complete AMV->AMV transcode (the port's main path).

`transcode_bytes` is the counterpart of `amv_tpu/pipeline/transcode.py:
transcode_bytes`: host C unescape, a length sort, the device chain
(`transcode_complete`: Huffman decode, DC prediction, block transcode,
Huffman encode), the unsort, host C escape/framing and the RIFF mux.
Audio chunks pass through untouched.

The chain runs in frame-major layout ([F, n_blocks, 64]); the TPU's slab
layout, lane tiles, segmentation (`segs`, `segs_dec`, `pick_segments`)
and the serving hand-over existed for TPU VMEM and dispatch limits and
are not carried over: one thread per frame has no VMEM cap, and a whole
frame escaped by `escape_frames` is byte-identical to its segments spliced
by `concat_escape_frames`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..codecs.amv_video import (check_decoded, encoder_qmat, pack_levels,
                                resolve_dc)
from ..containers import riff
from ..kernels.entropy_decode import decode_scans
from ..kernels.transcode import transcode_blocks, transcode_blocks_pix
from . import resolve_device


def transcode_levels_fused(levels_zz: torch.Tensor, qscale=2, size=None):
    """Zigzag levels int16 [F, M, 6, 64] (slot 0 = DC difference) ->
    (re-quantized zigzag levels int16 [F, M, 6, 64], slot 0 = absolute DC;
    decoded pixels uint8 [F, M, 6, 8, 8]) on the levels' device.
    `amv_tpu.pipeline.transcode.transcode_levels_fused`'s contract;
    `qscale` is an int or a JAX-style qmat_key tuple.  size=(w, h) gives
    the levels of the two-stage decode + re-encode of a picture of that
    size (edge-replicated pad), which is what the fused JAX transform
    differs from when w or h is not a multiple of 16."""
    f, m = levels_zz.shape[:2]
    dc = resolve_dc(levels_zz).reshape(-1)
    lv2, pix = transcode_blocks_pix(levels_zz.reshape(-1, 64), dc,
                                    encoder_qmat(qscale), size)
    return lv2.reshape(f, m, 6, 64), pix.reshape(f, m, 6, 8, 8)


def word_budget(scans: torch.Tensor) -> int:
    """Output words per frame for the encoder: twice the longest input scan
    plus slack, which holds a same-qscale re-encode with room to spare.  A
    guess, not a measured bound: `pack_levels` re-packs on overflow and
    trims the words to the longest re-encode."""
    return max(64, (2 * scans.shape[1] + 255) // 256 * 64)


def transcode_complete(scans: torch.Tensor, lens: torch.Tensor, n_mcu: int,
                       qmat, size=None):
    """Device chain: unescaped scans uint8 [F, stride] + lens int64 [F] ->
    (words int32 [F, w_out] big-endian scan words, bits int32 [F],
    ok bool [F]) for `native.escape_frames`.

    `transcode_complete_async`'s contract at segs=1, with ok per frame;
    `qmat` is a qscale or a qmat_key, `size` as `transcode_levels_fused`.
    ok False marks a frame the decoder rejected.  The encoder's words never
    truncate (`pack_levels`)."""
    levels, ok = decode_scans(scans, lens, n_mcu * 6)
    dc = resolve_dc(levels.reshape(-1, n_mcu, 6, 64)).reshape(-1)
    lv2 = transcode_blocks(levels.reshape(-1, 64), dc, encoder_qmat(qmat),
                           size)
    words, bits = pack_levels(lv2.reshape(levels.shape), word_budget(scans))
    return words, bits, ok.bool()


def transcode_bytes(data: bytes, *, qscale: int = 2, quant: str = "ffmpeg",
                    device) -> bytes:
    """Re-encode a complete .amv file on `device` (video re-quantized at
    qscale; audio chunks pass through).  Byte-identical to
    `amv_tpu.pipeline.transcode.transcode_bytes`.  A frame whose scan the
    Huffman decoder rejects raises ValueError naming it, as the JAX
    package's host route raises there."""
    dev = resolve_device(device)
    s = riff.demux(data)
    w, h = s.info.width, s.info.height
    if quant != "ffmpeg":
        raise NotImplementedError(
            f"quant={quant!r} is not yet ported: it needs the two-stage "
            "video decode/encode (ROADMAP queue 1, item 6)")

    def mux(vchunks):
        return riff.mux(vchunks, s.audio_chunks, width=w, height=h,
                        fps=s.info.fps_num, sample_rate=s.info.sample_rate)

    if not s.video_chunks:
        return mux([])
    n_mcu = ((w + 15) // 16) * ((h + 15) // 16)
    rows, lens = native.unescape_frames(s.video_chunks)
    order = np.argsort(np.array([len(p) for p in s.video_chunks]),
                       kind="stable")
    inv = np.argsort(order)
    words, bits, ok = transcode_complete(
        torch.from_numpy(rows[order]).to(dev),
        torch.from_numpy(lens[order]).to(dev), n_mcu, qscale, (w, h))
    check_decoded(ok, order)
    return mux(native.escape_frames(words.cpu().numpy()[inv],
                                    bits.cpu().numpy()[inv]))
