"""Kernel U: the AMV decode transform into the planes, Q60 dequant +
simple_idct + MCU assembly.

The port of `amv_tpu/kernels/decode_fused_pallas.py:decode_fused`, backed
by one CUDA kernel, csrc/decode_fused.cu, whose template mode picks the
entry:

* `decode_fused`: JAX's contract, raster levels [F, M, 6, 64] -> coded,
  un-flipped planes;
* `decode_planes`: the decode path's transform, kernel D's zigzag levels
  -> display planes, with the AMV flip, the crop and the un-sort of the
  length-sorted batch done by the kernel's store.

On a CUDA tensor the wrappers launch the kernel; on a CPU tensor they run
the plain torch versions in this module: kernel I's plain dequant and IDCT
(`kernels/idct.py`), then the assembly's index arithmetic (`coded_planes`,
`assemble_planes`).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..codecs.jpeg_tables import Q60_CHROMA, Q60_LUMA, ZIGZAG
from . import _build
from .idct import idct_blocks_plain

LAUNCHES = 0
_CODED, _DISPLAY = 0, 1     # csrc/decode_fused.cu kMode


def decode_fused(levels: torch.Tensor, dc: torch.Tensor, mb_w: int,
                 mb_h: int):
    """`amv_tpu.kernels.decode_fused_pallas.decode_fused`'s contract:
    levels int16 [F, M, 6, 64] raster (slot 0 ignored), dc int32 [F, M, 6]
    resolved dequantized DC (+1024 bias), M = mb_w * mb_h -> coded,
    un-flipped planes (y uint8 [F, 16 mb_h, 16 mb_w], cb and cr uint8
    [F, 8 mb_h, 8 mb_w]).  Any F."""
    m = mb_w * mb_h
    if levels.dim() != 4 or tuple(levels.shape[1:]) != (m, 6, 64) or \
            levels.dtype != torch.int16:
        raise ValueError(f"levels must be int16 [F, {m}, 6, 64], got "
                         f"{levels.dtype} {tuple(levels.shape)}")
    if dc.shape != levels.shape[:3] or dc.dtype != torch.int32:
        raise ValueError(f"dc must be int32 {tuple(levels.shape[:3])}, got "
                         f"{dc.dtype} {tuple(dc.shape)}")
    lv, d = levels.reshape(-1, 64), dc.reshape(-1)
    if lv.device.type == "cpu" and d.device.type == "cpu":
        return decode_fused_plain(levels, dc, mb_w, mb_h)
    return _launch(lv, d, mb_w, 16 * mb_w, 16 * mb_h, None, _CODED)


def decode_planes(levels: torch.Tensor, dc: torch.Tensor, width: int,
                  height: int, dst=None):
    """The decode path's transform: zigzag levels int16 [F * M * 6, 64] as
    kernel D leaves them (slot 0 ignored), dc int32 [F * M * 6] from
    `resolve_dc` -> display planes (y uint8 [F, H, W], cb and cr uint8
    [F, H/2, W/2]): the MCU assembly, the AMV flip and the crop of
    `assemble_planes`.  dst (int64 [F] on the levels' device, a
    permutation such as the inverse of a length sort): batch frame f lands
    on output frame dst[f]; None keeps the batch order.  The kernel skips
    a frame whose dst lies outside [0, F)."""
    if levels.dim() != 2 or levels.shape[1] != 64 or \
            levels.dtype != torch.int16:
        raise ValueError(f"levels must be int16 [N, 64], got "
                         f"{levels.dtype} {tuple(levels.shape)}")
    if width < 2 or height < 2:
        raise ValueError(f"{width}x{height}: a picture needs at least two "
                         "rows and two columns (one of chroma)")
    mb_w, mb_h = (width + 15) // 16, (height + 15) // 16
    nb = 6 * mb_w * mb_h
    if levels.shape[0] % nb:
        raise ValueError(f"{levels.shape[0]} blocks are not whole "
                         f"{width}x{height} frames")
    if dc.shape != levels.shape[:1] or dc.dtype != torch.int32:
        raise ValueError(f"dc must be int32 [{levels.shape[0]}], got "
                         f"{dc.dtype} {tuple(dc.shape)}")
    f = levels.shape[0] // nb
    if dst is not None and (dst.shape != (f,) or dst.dtype != torch.int64
                            or dst.device != levels.device):
        raise ValueError(f"dst must be int64 [{f}] on {levels.device}, got "
                         f"{getattr(dst, 'dtype', type(dst))} "
                         f"{tuple(getattr(dst, 'shape', ()))}")
    if levels.device.type == "cpu" and dc.device.type == "cpu":
        return decode_planes_plain(levels, dc, width, height, dst)
    return _launch(levels, dc, mb_w, width, height, dst, _DISPLAY)


def _launch(levels, dc, mb_w, width, height, dst, mode):
    """One launch of kernel U over levels [N, 64] into new planes."""
    _build.require_cuda(levels, dc)
    levels, dc = levels.contiguous(), dc.contiguous()
    if levels.data_ptr() % 16:
        raise ValueError("levels must be 16-byte aligned (vector loads)")
    dev, n = levels.device, levels.shape[0]
    n_mcu = mb_w * ((height + 15) // 16)
    f = n // (6 * n_mcu)
    y = torch.empty((f, height, width), dtype=torch.uint8, device=dev)
    cb = torch.empty((f, height // 2, width // 2), dtype=torch.uint8,
                     device=dev)
    cr = torch.empty_like(cb)
    if n == 0:
        return y, cb, cr
    tables = np.concatenate([Q60_LUMA, Q60_CHROMA]).astype(np.int32)
    geo = struct.pack("<qqqii", n_mcu, mb_w, f, width, height)
    with torch.cuda.device(dev):
        rc = _build.library().amv_decode_fused(
            levels.data_ptr(), dc.data_ptr(), tables.ctypes.data, geo,
            None if dst is None else dst.contiguous().data_ptr(), y.data_ptr(),
            cb.data_ptr(), cr.data_ptr(), n, mode, _build.stream())
    _build.check(rc, "amv_decode_fused")
    global LAUNCHES
    LAUNCHES += 1
    return y, cb, cr


# ---------------------------------------------------------------- plain

def coded_planes(pix: torch.Tensor, mb_w: int, mb_h: int):
    """Decoded blocks uint8 [F, M, 6, 8, 8] -> coded planes (y [F, 16 mb_h,
    16 mb_w], cb and cr [F, 8 mb_h, 8 mb_w]): the MCU assembly
    (mjpeg_decode_scan:672-723)."""
    f = pix.shape[0]
    mcu = pix.reshape(f, mb_h, mb_w, 6, 8, 8)
    yb = mcu[:, :, :, :4].reshape(f, mb_h, mb_w, 2, 2, 8, 8)
    y = yb.permute(0, 1, 3, 5, 2, 4, 6).reshape(f, 16 * mb_h, 16 * mb_w)
    cb = mcu[:, :, :, 4].permute(0, 1, 3, 2, 4).reshape(f, 8 * mb_h, 8 * mb_w)
    cr = mcu[:, :, :, 5].permute(0, 1, 3, 2, 4).reshape(f, 8 * mb_h, 8 * mb_w)
    return y, cb, cr


def assemble_planes(pix: torch.Tensor, mb_w: int, mb_h: int, width: int,
                    height: int):
    """Decoded blocks uint8 [F, M, 6, 8, 8] -> YUV420 display planes
    (MCU assembly + crop + AMV flip)."""
    y, cb, cr = coded_planes(pix, mb_w, mb_h)
    ch, cw = height // 2, width // 2
    return (y[:, :height, :width].flip(1), cb[:, :ch, :cw].flip(1),
            cr[:, :ch, :cw].flip(1))


def decode_fused_plain(levels: torch.Tensor, dc: torch.Tensor, mb_w: int,
                       mb_h: int):
    """Plain torch version of `decode_fused` on any device."""
    f = levels.shape[0]
    zz = torch.as_tensor(ZIGZAG, device=levels.device).long()
    pix = idct_blocks_plain(levels.reshape(-1, 64)[:, zz], dc.reshape(-1))
    return coded_planes(pix.view(f, mb_w * mb_h, 6, 8, 8), mb_w, mb_h)


def decode_planes_plain(levels: torch.Tensor, dc: torch.Tensor, width: int,
                        height: int, dst=None):
    """Plain torch version of `decode_planes` on any device."""
    mb_w, mb_h = (width + 15) // 16, (height + 15) // 16
    pix = idct_blocks_plain(levels, dc).view(-1, mb_w * mb_h, 6, 8, 8)
    planes = assemble_planes(pix, mb_w, mb_h, width, height)
    if dst is None:
        return planes
    out = tuple(torch.empty_like(p) for p in planes)
    for o, p in zip(out, planes):
        o[dst] = p
    return out
