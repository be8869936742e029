"""AMV MJPEG-variant video codec on the device: decode and encode.

The counterpart of `amv_tpu/codecs/amv_video.py` on its device route:

* decode: host C unescape, kernel D (Huffman decode), DC prediction
  (`resolve_dc`), kernel I (Q60 dequant + IDCT), MCU assembly and the AMV
  flip (`assemble_planes`);
* encode: flip and edge padding (`extract_blocks`), kernel F (FDCT +
  quantize), kernel E (Huffman pack, `pack_levels`), host C escape and
  framing.

Frames are batched frame-major; the batch is length-sorted before kernel D
(the longest frames' threads then share warps).  A frame kernel D rejects
raises ValueError naming it, as the JAX package's host route does.

Reference semantics: sp5xdec.c + mjpegdec.c (decode), mjpegenc.c +
mpegvideo_enc.c (encode).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..kernels.entropy_decode import decode_scans
from ..kernels.entropy_encode import encode_levels
from ..kernels.fdct import fdct_quant_blocks
from ..kernels.idct import idct_blocks
from .jpeg_tables import QDC_CHROMA, QDC_LUMA, encoder_qmat


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


def pack_levels(levels: torch.Tensor, w_first: int):
    """Kernel E with a word budget that never truncates: levels int16
    [F, n_blocks, 64] (slot 0 = absolute DC) -> (words int32 [F, w_used],
    bits int32 [F]) for `native.escape_frames`.  Packs with `w_first`
    words a frame; if a frame overflows, packs again with the exact budget
    from the bit counts; w_used is the longest frame's word count, so no
    unused words reach the host."""
    words, bits, _ = encode_levels(levels, w_first)
    w_used = max(1, (int(bits.max()) + 31) // 32) if bits.numel() else 1
    if w_used > words.shape[1]:
        words, bits, _ = encode_levels(levels, w_used)
    return words[:, :w_used].contiguous(), bits


def assemble_planes(pix: torch.Tensor, mb_w: int, mb_h: int, width: int,
                    height: int):
    """Decoded blocks uint8 [F, M, 6, 8, 8] -> YUV420 display planes
    (MCU assembly + AMV flip, mjpeg_decode_scan:672-723)."""
    f = pix.shape[0]
    mcu = pix.reshape(f, mb_h, mb_w, 6, 8, 8)
    yb = mcu[:, :, :, :4].reshape(f, mb_h, mb_w, 2, 2, 8, 8)
    ycoded = yb.permute(0, 1, 3, 5, 2, 4, 6).reshape(f, 16 * mb_h, 16 * mb_w)
    cbc = mcu[:, :, :, 4].permute(0, 1, 3, 2, 4).reshape(f, 8 * mb_h, 8 * mb_w)
    crc = mcu[:, :, :, 5].permute(0, 1, 3, 2, 4).reshape(f, 8 * mb_h, 8 * mb_w)
    ch, cw = height // 2, width // 2
    y = ycoded[:, :height, :width].flip(1)
    cb = cbc[:, :ch, :cw].flip(1)
    cr = crc[:, :ch, :cw].flip(1)
    return y, cb, cr


def decode_frames(payloads: list[bytes], width: int, height: int, *,
                  device):
    """Decode a batch of AMV '00dc' payloads to YUV420 planes (numpy
    uint8 [F, H, W], [F, H/2, W/2] x2) on `device`."""
    dev = torch.device(device)
    mb_w, mb_h = (width + 15) // 16, (height + 15) // 16
    n_mcu = mb_w * mb_h
    rows, lens = native.unescape_frames(payloads)
    order = np.argsort(np.array([len(p) for p in payloads]), kind="stable")
    levels, ok = decode_scans(torch.from_numpy(rows[order]).to(dev),
                              torch.from_numpy(lens[order]).to(dev),
                              n_mcu * 6)
    check_decoded(ok, order)
    f = len(payloads)
    dc = resolve_dc(levels.reshape(f, n_mcu, 6, 64)).reshape(-1)
    pix = idct_blocks(levels.reshape(-1, 64), dc)
    inv = torch.from_numpy(np.argsort(order)).to(dev)
    y, cb, cr = assemble_planes(pix.reshape(f, n_mcu, 6, 8, 8)[inv],
                                mb_w, mb_h, width, height)
    return y.cpu().numpy(), cb.cpu().numpy(), cr.cpu().numpy()


def extract_blocks(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                   mb_w: int, mb_h: int) -> torch.Tensor:
    """YUV420 planes -> encoder block layout uint8 [F, n_mcu, 6, 8, 8]
    (flip + bottom/right edge replication, amv_encode_picture:467-471 +
    ff_emulated_edge_mc)."""
    f = y.shape[0]

    def flip_pad(p, th, tw):
        p = p.flip(1)
        h, w = p.shape[1], p.shape[2]
        rows = torch.arange(th, device=p.device).clamp(max=h - 1)
        cols = torch.arange(tw, device=p.device).clamp(max=w - 1)
        return p[:, rows][:, :, cols]

    yc = flip_pad(y, 16 * mb_h, 16 * mb_w)
    cbc = flip_pad(cb, 8 * mb_h, 8 * mb_w)
    crc = flip_pad(cr, 8 * mb_h, 8 * mb_w)
    yb = yc.reshape(f, mb_h, 2, 8, mb_w, 2, 8).permute(0, 1, 4, 2, 5, 3, 6)
    cbb = cbc.reshape(f, mb_h, 8, mb_w, 8).permute(0, 1, 3, 2, 4)
    crb = crc.reshape(f, mb_h, 8, mb_w, 8).permute(0, 1, 3, 2, 4)
    return torch.cat([
        yb.reshape(f, mb_h * mb_w, 4, 8, 8),
        cbb.reshape(f, mb_h * mb_w, 1, 8, 8),
        crb.reshape(f, mb_h * mb_w, 1, 8, 8),
    ], dim=2)


def first_word_budget(n_mcu: int) -> int:
    """Kernel E's first guess at the words a frame needs, the JAX
    package's `min(1664, 1024 * ceil(M / 48))` (amv_video.py:280)."""
    return min(1664, 1024 * ((n_mcu + 47) // 48))


def encode_frames(y, cb, cr, qscale: int = 2, quant: str = "ffmpeg", *,
                  device) -> list[bytes]:
    """Encode YUV420 frames (uint8 arrays [F, H, W], [F, H/2, W/2] x2) into
    AMV '00dc' payloads on `device`; byte-identical to the C reference
    encoder.  quant="q60" is not yet ported."""
    if quant != "ffmpeg":
        raise NotImplementedError(
            f"quant={quant!r} is not yet ported (ROADMAP queue 1, item 6)")
    dev = torch.device(device)
    f, h, w = y.shape
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    planes = [torch.as_tensor(np.ascontiguousarray(p, np.uint8)).to(dev)
              for p in (y, cb, cr)]
    blocks = extract_blocks(*planes, mb_w, mb_h)
    levels = fdct_quant_blocks(blocks.reshape(-1, 64), encoder_qmat(qscale))
    words, bits = pack_levels(levels.reshape(f, mb_w * mb_h * 6, 64),
                              first_word_budget(mb_w * mb_h))
    return native.escape_frames(words.cpu().numpy(), bits.cpu().numpy())
