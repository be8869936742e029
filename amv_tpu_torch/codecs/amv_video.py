"""AMV MJPEG-variant video codec on the device: decode and encode.

The counterpart of `amv_tpu/codecs/amv_video.py` on its device route:

* decode: host C unescape, kernel D (Huffman decode), DC prediction
  (`resolve_dc`), kernel U (Q60 dequant + IDCT + MCU assembly, with the
  AMV flip, the crop and the un-sort in its store: `decode_planes`);
* encode: kernel V (flip and edge padding in its load, FDCT, and the
  "ffmpeg" or "q60" quantizer: `encode_planes`), kernel E (its bit count,
  then the Huffman pack at the exact word budget: `pack_levels`), host C
  escape and framing.

`decode_transform` and `encode_transform` keep the JAX package's
contracts over kernels U and V.  Frames are batched frame-major; the
batch is length-sorted before kernel D.  A frame kernel D rejects raises
ValueError naming it, as the JAX package's host route does.

Reference semantics: sp5xdec.c + mjpegdec.c (decode), mjpegenc.c +
mpegvideo_enc.c (encode).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..kernels.decode_fused import (assemble_planes,  # noqa: F401
                                    decode_planes)
from ..kernels.encode_fused import (QUANTS, encode_planes,  # noqa: F401
                                    extract_blocks)
from ..kernels.entropy_decode import decode_scans
from ..kernels.entropy_encode import count_bits, encode_levels
from .jpeg_tables import QDC_CHROMA, QDC_LUMA, encoder_qmat  # noqa: F401


def resolve_dc(levels: torch.Tensor) -> torch.Tensor:
    """DC prediction: zigzag levels [F, M, 6, 64] with slot 0 = DC
    difference -> resolved dequantized DC int32 [F, M, 6] (+1024 bias), a
    per-component cumsum (Y over its 4 blocks per MCU, then Cb, Cr)."""
    f, m = levels.shape[:2]
    d = levels[..., 0].to(torch.int32)
    dy = torch.cumsum(d[:, :, :4].reshape(f, m * 4) * QDC_LUMA, dim=1,
                      dtype=torch.int32).reshape(f, m, 4) + 1024
    dcb = torch.cumsum(d[:, :, 4] * QDC_CHROMA, dim=1, dtype=torch.int32) + 1024
    dcr = torch.cumsum(d[:, :, 5] * QDC_CHROMA, dim=1, dtype=torch.int32) + 1024
    return torch.cat([dy, dcb[..., None], dcr[..., None]], dim=2)


def check_decoded(ok: torch.Tensor, order: np.ndarray) -> None:
    """Raise ValueError naming the frames (their indices before the length
    sort `order`) whose scans kernel D rejected (ok 0)."""
    if not bool(ok.all()):
        bad = sorted(int(order[i]) for i in
                     torch.nonzero(ok == 0).flatten().cpu().numpy())
        raise ValueError(f"malformed scan in frame(s) {bad}: the Huffman "
                         "decoder rejected them")


def used_words(bits) -> int:
    """The word budget kernel E packs at: the longest frame's 32-bit words
    (at least one) from bits [F], a tensor or an array."""
    return max(1, (int(bits.max()) + 31) // 32) if len(bits) else 1


def pack_levels(levels: torch.Tensor):
    """Kernel E at a word budget that never truncates: levels int16
    [F, n_blocks, 64] (slot 0 = absolute DC) -> (words int32 [F, w_used],
    bits int32 [F]) for `native.escape_frames`.  Kernel E's count entry
    gives every frame's bits first; the pack then runs once, at w_used
    (`used_words`), so no unused words reach the host."""
    words, bits, _ = encode_levels(levels, used_words(count_bits(levels)))
    return words, bits


def _check_geometry(n_mcu: int, mb_w: int, mb_h: int, width: int,
                    height: int) -> None:
    if (mb_w, mb_h) != ((width + 15) // 16, (height + 15) // 16) or \
            n_mcu != mb_w * mb_h:
        raise ValueError(f"{n_mcu} MCUs of {mb_w}x{mb_h} do not make a "
                         f"{width}x{height} picture")


def decode_transform(levels_zz: torch.Tensor, mb_w: int, mb_h: int,
                     width: int, height: int):
    """`amv_tpu.codecs.amv_video.decode_transform`'s contract on the
    levels' device: levels int16 [F, n_mcu, 6, 64] zigzag, slot 0 the DC
    difference -> (y uint8 [F, H, W], cb and cr uint8 [F, H/2, W/2])
    display planes.  DC prediction, then kernel U."""
    _check_geometry(levels_zz.shape[1], mb_w, mb_h, width, height)
    dc = resolve_dc(levels_zz).reshape(-1)
    return decode_planes(levels_zz.reshape(-1, 64), dc, width, height)


def decode_frames(payloads: list[bytes], width: int, height: int, *,
                  device):
    """Decode a batch of AMV '00dc' payloads to YUV420 planes (numpy
    uint8 [F, H, W], [F, H/2, W/2] x2) on `device`."""
    dev = torch.device(device)
    n_mcu = ((width + 15) // 16) * ((height + 15) // 16)
    rows, lens = native.unescape_frames(payloads)
    order = np.argsort(np.array([len(p) for p in payloads]), kind="stable")
    levels, ok = decode_scans(torch.from_numpy(rows[order]).to(dev),
                              torch.from_numpy(lens[order]).to(dev),
                              n_mcu * 6)
    check_decoded(ok, order)
    dc = resolve_dc(levels.reshape(len(payloads), n_mcu, 6, 64)).reshape(-1)
    y, cb, cr = decode_planes(levels.reshape(-1, 64), dc, width, height,
                              dst=torch.from_numpy(order).to(dev))
    return y.cpu().numpy(), cb.cpu().numpy(), cr.cpu().numpy()


def encode_transform(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                     mb_w: int, mb_h: int, qscale: int = 2,
                     quant: str = "ffmpeg") -> torch.Tensor:
    """`amv_tpu.codecs.amv_video.encode_transform`'s contract on the
    planes' device: YUV420 display planes (uint8 [F, H, W], [F, H/2, W/2]
    x2) -> levels int16 [F, n_mcu, 6, 64] zigzag, slot 0 the absolute DC.
    quant "ffmpeg" is the reference encoder's quantizer at qscale; "q60"
    quantizes with the decoder's own Q60 tables (qscale unused).  Kernel
    V."""
    f, h, w = y.shape
    _check_geometry(mb_w * mb_h, mb_w, mb_h, w, h)
    return encode_planes(y, cb, cr, qscale, quant).view(f, mb_w * mb_h, 6,
                                                        64)


def encode_frames(y, cb, cr, qscale: int = 2, quant: str = "ffmpeg", *,
                  device) -> list[bytes]:
    """Encode YUV420 frames (uint8 arrays or tensors [F, H, W], [F, H/2,
    W/2] x2; tensors already on `device` stay there) into AMV '00dc'
    payloads on `device`.  quant "ffmpeg" is byte-identical to the C
    reference encoder; "q60" quantizes with the decoder's Q60 tables
    (`encode_transform`), packed by the same mjpegenc rules."""
    dev = torch.device(device)
    planes = [(p if isinstance(p, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(p, np.uint8))).to(dev, torch.uint8)
        for p in (y, cb, cr)]
    levels = encode_planes(*planes, qscale, quant)
    words, bits = pack_levels(levels)
    return native.escape_frames(words.cpu().numpy(), bits.cpu().numpy())
