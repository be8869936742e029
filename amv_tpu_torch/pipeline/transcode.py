"""The complete AMV->AMV transcode (the port's main path).

`transcode_bytes` is the counterpart of `amv_tpu/pipeline/transcode.py:
transcode_bytes`: the RIFF demux, the video through
`serving.AsyncTranscoder` (host C unescape into pinned memory, the device
chain on CUDA streams: Huffman decode, DC prediction, block transcode,
Huffman encode; host C escape/framing into one buffer) and the RIFF mux.
Audio chunks pass through untouched.  `transcode_scans` is the chain up
to the entropy encoder, which runs with no host sync.

`transcode_complete(enc=...)` picks the entropy encoder, as
`transcode_complete_async` does: "async" is kernel E; "record" the
tokenizer and kernel P, "rechunk" the block-local pack and kernel P,
"parallel" the scatter-add packer (`kernels/entropy_records.py`,
`kernels/entropy_parallel.py`).  All give the same bytes.

The transform between the entropy stages is kernel T (dequant, IDCT,
edge replication, FDCT, requant in one pass) for quant="ffmpeg" at the
sizes it takes, and otherwise the two-stage route of the JAX package's
`transcode_bytes` (`decode_transform` then `encode_transform`,
amv_tpu/pipeline/transcode.py:603-611): kernel U to display planes kept
on the device, then kernel V (`reencode_planes`).  It carries
quant="q60" and odd picture sizes.

The chain runs in frame-major layout ([F, n_blocks, 64]); the TPU's slab
layout, lane tiles and segmentation (`segs`, `segs_dec`, `pick_segments`)
existed for TPU VMEM limits and are not carried over: a thread block per
frame has no VMEM cap, and a whole frame escaped by `escape_frames` is
byte-identical to its segments spliced by `concat_escape_frames`.
"""

from __future__ import annotations

import os

import torch

from .. import native
from ..codecs.amv_video import (QUANTS, decode_planes, encode_planes,
                                encoder_qmat, pack_levels, resolve_dc,
                                used_words)
from ..containers import riff
from ..kernels.entropy_decode import decode_scans
from ..kernels.entropy_parallel import (FITTING_WINDOWS,
                                        encode_layout_parallel,
                                        encode_layout_rechunk)
from ..kernels.entropy_records import encode_layout_async
from ..kernels.transcode import (takes_size, transcode_blocks,
                                 transcode_blocks_pix)
from ..utils.profiling import span
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
    """The record routes' first word budget per frame: twice the longest
    input scan plus slack, which holds a same-qscale re-encode with room to
    spare.  A guess, not a measured bound: `encode_route` packs again on
    overflow and trims the words to the longest re-encode."""
    return max(64, (2 * scans.shape[1] + 255) // 256 * 64)


# The record routes' encoders: levels [F, NB, 64], w_out -> (words, bits,
# ok).  Their record budget and windows are ones no input overflows (a
# block owns at most 64 records; the batch's longest block; windows of
# WL_MAX-word blocks), where JAX's defaults are sized for its corpus and
# its callers fall back to the lockstep encoder on an overflow: on
# chip_smoke.py's 160x120 corpus at qscale 2, 2,030 of 4,800 frames decode
# to more than JAX's 8,192 records, and their re-encodes take about as
# many.  So only the word budget can overflow here.
ROUTES = {
    "record": lambda lv2, w_out: encode_layout_async(lv2, w_out,
                                                     64 * lv2.shape[1]),
    "rechunk": lambda lv2, w_out: encode_layout_rechunk(lv2, w_out, None),
    "parallel": lambda lv2, w_out: encode_layout_parallel(
        lv2, w_out, **FITTING_WINDOWS),
}
ENCODERS = ("async",) + tuple(ROUTES)


def encode_route(lv2: torch.Tensor, w_first: int, enc: str):
    """Re-quantized levels int16 [F, NB, 64] -> (words int32 [F, w_used],
    bits int32 [F]) by encoder `enc`, trimmed to the longest frame.  Kernel
    E ("async") counts the bits first and packs once at the exact budget
    (`pack_levels`); a record route that overflows w_first words packs
    again with the exact budget."""
    if enc == "async":
        return pack_levels(lv2)
    words, bits, _ = ROUTES[enc](lv2, w_first)
    w_used = used_words(bits)
    if w_used > w_first:
        words, bits, _ = ROUTES[enc](lv2, w_used)
    return words[:, :w_used].contiguous(), bits


def reencode_planes(levels: torch.Tensor, dc: torch.Tensor, size, qmat,
                    quant: str = "ffmpeg") -> torch.Tensor:
    """The two-stage transform: zigzag levels int16 [F, 6 M, 64] (slot 0
    ignored) and their resolved DC int32 [F * 6 M] -> display planes of
    size=(width, height) (kernel U; they stay on the device) ->
    re-quantized zigzag levels int16 [F, 6 M, 64] (kernel V, `quant`;
    `qmat` a qscale or a qmat_key)."""
    if size is None:
        raise ValueError("the two-stage transform needs the picture size")
    planes = decode_planes(levels.reshape(-1, 64), dc, *size)
    return encode_planes(*planes, qmat, quant)


def transcode_scans(scans: torch.Tensor, lens: torch.Tensor, n_mcu: int,
                    qmat, size=None, quant: str = "ffmpeg"):
    """The device chain before the entropy encoder, with no host sync:
    unescaped scans uint8 [F, stride] + lens int64 [F] -> (re-quantized
    zigzag levels int16 [F, 6 n_mcu, 64], slot 0 the absolute DC; ok uint8
    [F], 0 for a frame kernel D rejected).  Kernel D, the DC prediction,
    then kernel T for quant="ffmpeg" at the sizes it takes (`takes_size`),
    else `reencode_planes` (kernels U, V); arguments as
    `transcode_complete`."""
    if quant not in QUANTS:
        raise ValueError(f"quant must be one of {QUANTS}, got {quant!r}")
    levels, ok = decode_scans(scans, lens, n_mcu * 6)
    dc = resolve_dc(levels.reshape(-1, n_mcu, 6, 64)).reshape(-1)
    if quant == "ffmpeg" and takes_size(size):
        return transcode_blocks(levels.reshape(-1, 64), dc,
                                encoder_qmat(qmat),
                                size).reshape(levels.shape), ok
    return reencode_planes(levels, dc, size, qmat, quant), ok


def transcode_complete(scans: torch.Tensor, lens: torch.Tensor, n_mcu: int,
                       qmat, size=None, enc: str = "async",
                       quant: str = "ffmpeg"):
    """Device chain: unescaped scans uint8 [F, stride] + lens int64 [F] ->
    (words int32 [F, w_out] big-endian scan words, bits int32 [F],
    ok bool [F]) for `native.escape_frames`.

    `transcode_complete_async`'s contract at segs=1, with ok per frame;
    `qmat` is a qscale or a qmat_key, `size` as `transcode_levels_fused`,
    `enc` one of ENCODERS, `quant` one of QUANTS.  Kernel T transforms
    quant="ffmpeg" at the sizes it takes (`takes_size`); "q60" and odd
    sizes take `reencode_planes`.  ok False marks a frame the decoder
    rejected.  The encoder's words never truncate (`encode_route`)."""
    if enc not in ENCODERS:
        raise ValueError(f"enc must be one of {ENCODERS}, got {enc!r}")
    lv2, ok = transcode_scans(scans, lens, n_mcu, qmat, size, quant)
    words, bits = encode_route(lv2, word_budget(scans), enc)
    return words, bits, ok.bool()


# The served route's batch: 1,024 frames with 4 in flight, where the JAX
# class's default is 4,096 (one compiled shape on the TPU).  On the H100
# the host stages bind, and at 1,024 frames the escape of earlier batches
# runs beside the unescape of later ones on more of the file (PERF.md
# section 6: 1,024 x 4 against 4,096 x 4 in `tools/time_serving.py`).
SERVE_BATCH_FRAMES = 1024


def transcode_bytes(data: bytes, *, qscale: int = 2, quant: str = "ffmpeg",
                    device) -> bytes:
    """Re-encode a complete .amv file on `device` (video re-quantized at
    qscale, or with the decoder's Q60 tables for quant="q60"; audio chunks
    pass through).  Byte-identical to
    `amv_tpu.pipeline.transcode.transcode_bytes`.  A frame whose scan the
    Huffman decoder rejects raises ValueError naming it, as the JAX
    package's host route raises there.

    The video goes through `serving.AsyncTranscoder`: a file of up to
    AMV_SERVE_THRESHOLD video frames (default 8,192, the JAX package's
    variable) as one batch, a longer one in batches of SERVE_BATCH_FRAMES
    with 4 in flight, as the JAX package routes it.  Both routes give the
    same bytes."""
    from .serving import AsyncTranscoder
    with span("transcode_bytes"):
        dev = resolve_device(device)
        s = riff.demux(data)
        w, h = s.info.width, s.info.height
        n = len(s.video_chunks)
        serve = n > int(os.environ.get("AMV_SERVE_THRESHOLD", "8192"))
        tr = AsyncTranscoder(((w + 15) // 16) * ((h + 15) // 16), qscale,
                             batch_frames=SERVE_BATCH_FRAMES if serve else
                             max(1, n), depth=4 if serve else 1,
                             w_bytes=native.row_stride(s.video_chunks),
                             size=(w, h), quant=quant, device=dev)
        video = []
        for buf, offsets, lens in tr.batches(s.video_chunks):
            mv = memoryview(buf)
            video += [mv[o:o + k] for o, k in zip(offsets.tolist(),
                                                  lens.tolist())]
        return riff.mux(video, s.audio_chunks, width=w, height=h,
                        fps=s.info.fps_num, sample_rate=s.info.sample_rate)
