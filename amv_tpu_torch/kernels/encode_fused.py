"""Kernel V: the AMV encode transform from the planes, MCU block gather +
jfdctint + quantizer -> levels.

The port of `amv_tpu/kernels/encode_fused_pallas.py:encode_fused`, backed
by one CUDA kernel, csrc/encode_fused.cu, whose template parameters pick
the entry and the quantizer:

* `encode_fused`: JAX's contract, coded (flipped, padded) planes -> raster
  levels, the encoder's quantizer (`dct_quantize_c`);
* `encode_planes`: the encode path's transform, display planes -> zigzag
  levels for kernel E, with the AMV flip and the edge replication of
  `extract_blocks` done by the kernel's load, and either quantizer:
  "ffmpeg" (the reference encoder's) or "q60" (`amv_tpu.codecs.
  amv_video.encode_transform(quant="q60")`, the decoder's own Q60 tables).

On a CUDA tensor the wrappers launch the kernel; on a CPU tensor they run
the plain torch versions in this module: the block gather's index
arithmetic (`mcu_blocks`, `extract_blocks`), then kernel F's plain FDCT
and quantizer (`kernels/fdct.py`) or `q60_quantize_plain`.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..codecs.jpeg_tables import Q60_CHROMA, Q60_LUMA, ZIGZAG, encoder_qmat
from . import _build
from .fdct import fdct_plain, fdct_quantize_plain

LAUNCHES = 0
QUANTS = ("ffmpeg", "q60")      # csrc/encode_fused.cu kQuant 0, 1


def encode_fused(ycoded: torch.Tensor, cbcoded: torch.Tensor,
                 crcoded: torch.Tensor, mb_w: int, mb_h: int, qmat_key):
    """`amv_tpu.kernels.encode_fused_pallas.encode_fused`'s contract: coded
    planes, already flipped and padded (y uint8 [F, 16 mb_h, 16 mb_w], cb
    and cr uint8 [F, 8 mb_h, 8 mb_w]) -> levels int16 [F, M, 6, 64] raster,
    slot 0 the absolute DC (coef + 32) >> 6, AC coef * qmat with a
    sign-symmetric >> 22 and a clip to +-1023 in int32 wraparound.
    qmat_key is a 64-tuple or a qscale (`encoder_qmat`).  Any F."""
    f = ycoded.shape[0]
    _check_planes(ycoded, cbcoded, crcoded, (f, 16 * mb_h, 16 * mb_w))
    qmat = encoder_qmat(qmat_key)
    if ycoded.device.type == "cpu":
        return encode_fused_plain(ycoded, cbcoded, crcoded, mb_w, mb_h, qmat)
    out = _launch(ycoded, cbcoded, crcoded, qmat, mb_w, False, "ffmpeg")
    return out.view(f, mb_w * mb_h, 6, 64)


def encode_planes(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                  qmat, quant: str = "ffmpeg") -> torch.Tensor:
    """The encode path's transform: display planes (y uint8 [F, H, W], cb
    and cr uint8 [F, H/2, W/2]) -> zigzag levels int16 [F, 6 M, 64], slot
    0 the absolute DC, kernel E's input.  The flip and the bottom/right
    edge replication of `extract_blocks`; quant "ffmpeg" quantizes with
    qmat (a qscale or a raster matrix, as `encoder_qmat` takes), "q60" with
    the decoder's Q60 tables (qmat unused)."""
    if quant not in QUANTS:
        raise ValueError(f"quant must be one of {QUANTS}, got {quant!r}")
    if y.dim() != 3:
        raise ValueError(f"y must be [F, H, W], got {tuple(y.shape)}")
    f, h, w = y.shape
    if w < 2 or h < 2:
        raise ValueError(f"{w}x{h}: a picture needs at least two rows and "
                         "two columns (one of chroma)")
    _check_planes(y, cb, cr, (f, h, w))
    qmat = encoder_qmat(qmat) if quant == "ffmpeg" else np.zeros(64, np.int32)
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    if y.device.type == "cpu":
        return encode_planes_plain(y, cb, cr, qmat, quant)
    return _launch(y, cb, cr, qmat, mb_w, True, quant).view(
        f, 6 * mb_w * mb_h, 64)


def _check_planes(y, cb, cr, yshape):
    f, h, w = yshape
    for name, p, shape in (("y", y, (f, h, w)),
                           ("cb", cb, (f, h // 2, w // 2)),
                           ("cr", cr, (f, h // 2, w // 2))):
        if tuple(p.shape) != shape or p.dtype != torch.uint8:
            raise ValueError(f"{name} must be uint8 {shape}, got {p.dtype} "
                             f"{tuple(p.shape)}")


def _launch(y, cb, cr, qmat, mb_w, display, quant):
    """One launch of kernel V over the planes -> levels int16 [N, 64]."""
    _build.require_cuda(y, cb, cr)
    y, cb, cr = (p.contiguous() for p in (y, cb, cr))
    f, h, w = y.shape
    n_mcu = mb_w * ((h + 15) // 16)
    n = f * 6 * n_mcu
    if f * n_mcu >= 1 << 31:
        raise ValueError(f"{f} frames of {n_mcu} MCUs: at most 2^31 MCUs a "
                         "launch")
    out = torch.empty((n, 64), dtype=torch.int16, device=y.device)
    if n == 0:
        return out
    tables = np.concatenate([qmat, Q60_LUMA, Q60_CHROMA]).astype(np.int32)
    tables = np.concatenate([tables, q60_reciprocals().view(np.int32)])
    geo = struct.pack("<qqii", n_mcu, mb_w, w, h)
    with _build.on_device(y, cb, cr) as (lib, stream):
        rc = lib.amv_encode_fused(
            y.data_ptr(), cb.data_ptr(), cr.data_ptr(), tables.ctypes.data,
            geo, out.data_ptr(), n, int(display), QUANTS.index(quant),
            stream)
    _build.check(rc, "amv_encode_fused")
    global LAUNCHES
    LAUNCHES += 1
    return out


def q60_reciprocals() -> np.ndarray:
    """Kernel V's q60 multipliers uint32 [128] (luma then chroma, raster):
    m = ceil(2^32 / den) for den = 8 * Q60, so that the high word of a * m
    (`__umulhi`) equals a // den for every a below 2^17."""
    den = 8 * np.concatenate([Q60_LUMA, Q60_CHROMA]).astype(np.uint64)
    return (((1 << 32) + den - 1) // den).astype(np.uint32)


# ---------------------------------------------------------------- plain

def mcu_blocks(yc: torch.Tensor, cbc: torch.Tensor, crc: torch.Tensor,
               mb_w: int, mb_h: int) -> torch.Tensor:
    """Coded planes -> encoder block layout [F, M, 6, 8, 8] (4 Y, Cb, Cr
    per MCU)."""
    f = yc.shape[0]
    yb = yc.reshape(f, mb_h, 2, 8, mb_w, 2, 8).permute(0, 1, 4, 2, 5, 3, 6)
    cbb = cbc.reshape(f, mb_h, 8, mb_w, 8).permute(0, 1, 3, 2, 4)
    crb = crc.reshape(f, mb_h, 8, mb_w, 8).permute(0, 1, 3, 2, 4)
    return torch.cat([
        yb.reshape(f, mb_h * mb_w, 4, 8, 8),
        cbb.reshape(f, mb_h * mb_w, 1, 8, 8),
        crb.reshape(f, mb_h * mb_w, 1, 8, 8),
    ], dim=2)


def extract_blocks(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                   mb_w: int, mb_h: int) -> torch.Tensor:
    """YUV420 display planes -> encoder block layout uint8 [F, M, 6, 8, 8]
    (flip + bottom/right edge replication, amv_encode_picture:467-471 +
    ff_emulated_edge_mc)."""

    def flip_pad(p, th, tw):
        p = p.flip(1)
        h, w = p.shape[1], p.shape[2]
        rows = torch.arange(th, device=p.device).clamp(max=h - 1)
        cols = torch.arange(tw, device=p.device).clamp(max=w - 1)
        return p[:, rows][:, :, cols]

    return mcu_blocks(flip_pad(y, 16 * mb_h, 16 * mb_w),
                      flip_pad(cb, 8 * mb_h, 8 * mb_w),
                      flip_pad(cr, 8 * mb_h, 8 * mb_w), mb_w, mb_h)


def q60_quantize_plain(coef: torch.Tensor) -> torch.Tensor:
    """`encode_transform(quant="q60")`'s quantizer on FDCT coefficients
    [N, 64] raster (block n luma iff n % 6 < 4) -> levels int16 [N, 64]
    raster: round to nearest by 8 * Q60 after taking 8192 off the DC, a
    clip to +-1023, then +128 at the DC."""
    dev = coef.device
    luma = (torch.arange(coef.shape[0], device=dev) % 6 < 4)[:, None]
    q = torch.where(luma, torch.as_tensor(Q60_LUMA, device=dev).long(),
                    torch.as_tensor(Q60_CHROMA, device=dev).long())
    num = coef.long().clone()
    num[:, 0] -= 8192
    den = 8 * q
    mag = (num.abs() + (den >> 1)) // den
    lv = torch.where(num < 0, -mag, mag).clamp(-1023, 1023)
    lv[:, 0] += 128
    return lv.to(torch.int16)


def encode_fused_plain(yc, cbc, crc, mb_w: int, mb_h: int,
                       qmat: np.ndarray) -> torch.Tensor:
    """Plain torch version of `encode_fused` on any device."""
    blocks = mcu_blocks(yc, cbc, crc, mb_w, mb_h).reshape(-1, 64)
    return fdct_quantize_plain(blocks, qmat).view(yc.shape[0], mb_w * mb_h,
                                                  6, 64)


def encode_planes_plain(y, cb, cr, qmat: np.ndarray,
                        quant: str = "ffmpeg") -> torch.Tensor:
    """Plain torch version of `encode_planes` on any device."""
    f, h, w = y.shape
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    blocks = extract_blocks(y, cb, cr, mb_w, mb_h).reshape(-1, 64)
    lv = (q60_quantize_plain(fdct_plain(blocks)) if quant == "q60"
          else fdct_quantize_plain(blocks, qmat))
    zz = torch.as_tensor(ZIGZAG, device=y.device).long()
    return lv[:, zz].reshape(f, 6 * mb_w * mb_h, 64)
