"""amvlib's own AMV video decoder (the reference's second decoder), with
kernel W for its transform.

The port of `amv_tpu/codecs/amvlib_video.py`.  C-AMVDecoder/amvlib decodes
AMV frames in its own way, which differs from the FFmpeg path in three
places (SURVEY.md section 7.1):

* fixed ~Q75 quant tables (AmvJpeg.c:30-61, `codecs/jpeg_tables.py:
  AMVLIB_QUANT_*`), applied to the levels in zigzag order, instead of the
  sp5x Q60 pair;
* the Wang integer IDCT (AmvJpeg.c idctrow/idctcol:1082-1176) with
  [-256, 255] output clipping and +128 on luma after it
  (IQtIZzBlock:1010-1048);
* DC prediction accumulated in the level domain from 0.

Its zigzag table (AmvJpeg.c:133-143) has entry 37 twice and no 31; it is
kept verbatim.

`decode_transform_amvlib` keeps the JAX contract; on a CUDA tensor it
launches kernel W (csrc/amvlib_idct.cu), on a CPU tensor it runs the
plain torch version `decode_transform_amvlib_plain`, which follows the JAX
function step by step in int32 (torch's int32 products and left shifts
wrap as XLA's do; right shifts are arithmetic).
`decode_frames_amvlib_rgb` is the whole decode to RGB: host C unescape,
kernel D for the levels, then W's RGB entry (StoreBuffer's fixed point,
AmvJpeg.c:789-840, in its store).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from .. import native
from ..kernels import _build
from ..kernels.entropy_decode import decode_scans
from ..pipeline import resolve_device
from . import jpeg_tables as T
from .amv_video import check_decoded

LAUNCHES = 0
_PLANES, _RGB = 0, 1        # csrc/amvlib_idct.cu kMode

# amvlib's zigzag (AmvJpeg.c:133-143), the 37/31 bug kept verbatim; the
# same table is csrc/amvlib_idct.cu's kZigzag
AMVLIB_ZIGZAG = np.array([
    0, 1, 5, 6, 14, 15, 27, 28,
    2, 4, 7, 13, 16, 26, 29, 42,
    3, 8, 12, 17, 25, 30, 41, 43,
    9, 11, 18, 24, 37, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54,
    20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61,
    35, 36, 48, 49, 57, 58, 62, 63,
], dtype=np.int32)

W1, W2, W3, W5, W6, W7 = 2841, 2676, 2408, 1609, 1108, 565


def _check(levels_zz, mb_w: int, mb_h: int, width: int, height: int):
    if levels_zz.dim() != 4 or tuple(levels_zz.shape[1:]) != \
            (mb_w * mb_h, 6, 64) or levels_zz.dtype != torch.int16:
        raise ValueError(f"levels must be int16 [F, {mb_w * mb_h}, 6, 64], "
                         f"got {levels_zz.dtype} {tuple(levels_zz.shape)}")
    if (mb_w, mb_h) != ((width + 15) // 16, (height + 15) // 16) or \
            width < 2 or height < 2:
        raise ValueError(f"{mb_w}x{mb_h} MCUs do not make a {width}x{height}"
                         " picture")


def resolve_dc_levels(levels_zz: torch.Tensor) -> torch.Tensor:
    """amvlib's DC prediction (HufBlock): levels [F, M, 6, 64], slot 0 the
    DC difference -> the DC levels int32 [F, M, 6], a cumsum from 0 in the
    level domain (Y over its 4 blocks an MCU, then Cb, then Cr)."""
    f, m = levels_zz.shape[:2]
    d = levels_zz[..., 0].to(torch.int32)
    dy = torch.cumsum(d[:, :, :4].reshape(f, m * 4), dim=1,
                      dtype=torch.int32).reshape(f, m, 4)
    du = torch.cumsum(d[:, :, 4], dim=1, dtype=torch.int32)
    dv = torch.cumsum(d[:, :, 5], dim=1, dtype=torch.int32)
    return torch.cat([dy, du[..., None], dv[..., None]], dim=2)


def decode_transform_amvlib(levels_zz: torch.Tensor, mb_w: int, mb_h: int,
                            width: int, height: int):
    """amvlib's transform on the levels' device: levels int16 [F, mb_w
    mb_h, 6, 64] zigzag, slot 0 the DC difference -> (y, u, v) int32
    display planes [F, H, W], [F, H/2, W/2] x2; y level-shifted (+128) in
    [-128, 383] like amvlib's Y buffer, u and v zero-centred in [-256,
    255] (StoreBuffer consumes them so)."""
    _check(levels_zz, mb_w, mb_h, width, height)
    if levels_zz.device.type == "cpu":
        return decode_transform_amvlib_plain(levels_zz, mb_w, mb_h, width,
                                             height)
    return _launch(levels_zz, width, height, _PLANES)


def decode_rgb_amvlib(levels_zz: torch.Tensor, width: int, height: int):
    """amvlib's transform and StoreBuffer's RGB (AmvJpeg.c:789-840) on the
    levels' device: levels as `decode_transform_amvlib` takes them, even
    width and height -> uint8 RGB [F, H, W, 3], display rows."""
    mb_w, mb_h = (width + 15) // 16, (height + 15) // 16
    _check(levels_zz, mb_w, mb_h, width, height)
    if width % 2 or height % 2:
        raise ValueError(f"amvlib's RGB needs even sizes, got {width}x"
                         f"{height}")
    if levels_zz.device.type == "cpu":
        return rgb_amvlib_plain(*decode_transform_amvlib_plain(
            levels_zz, mb_w, mb_h, width, height))
    return _launch(levels_zz, width, height, _RGB)


def decode_frames_amvlib_rgb(payloads: list[bytes], width: int, height: int,
                             *, device) -> torch.Tensor:
    """The whole amvlib decode of AMV '00dc' payloads on `device` -> uint8
    RGB [F, H, W, 3]: host C unescape, kernel D (the levels, equal to
    `amv_tpu.bitstream.entropy.huffman_decode_frames`'), then kernel W.  A
    frame kernel D rejects raises ValueError naming it."""
    dev = resolve_device(device)
    mb_w, mb_h = (width + 15) // 16, (height + 15) // 16
    n_mcu = mb_w * mb_h
    rows, lens = native.unescape_frames(payloads)
    levels, ok = decode_scans(torch.from_numpy(rows).to(dev),
                              torch.from_numpy(lens).to(dev), n_mcu * 6)
    check_decoded(ok, np.arange(len(payloads)))
    return decode_rgb_amvlib(levels.view(len(payloads), n_mcu, 6, 64), width,
                             height)


def kernel_args(frames: int, width: int, height: int):
    """Kernel W's tables (the ~Q75 pair, int32 [128]) and its struct Frames
    (csrc/amvlib_idct.cu) for `frames` frames of width x height."""
    mb_w, mb_h = (width + 15) // 16, (height + 15) // 16
    tables = np.concatenate([T.AMVLIB_QUANT_LUMA,
                             T.AMVLIB_QUANT_CHROMA]).astype(np.int32)
    return tables, struct.pack("<qqqii", mb_w * mb_h, mb_w, frames, width,
                               height)


def _launch(levels_zz, width: int, height: int, mode: int):
    """One launch of kernel W over every frame (the DC prediction in the
    kernel)."""
    _build.require_cuda(levels_zz)
    f = levels_zz.shape[0]
    levels = levels_zz.contiguous()
    if levels.data_ptr() % 16:
        raise ValueError("levels must be 16-byte aligned (vector loads)")
    dev = levels.device
    if mode == _RGB:
        outs = (torch.empty((f, height, width, 3), dtype=torch.uint8,
                            device=dev),)
    else:
        outs = (torch.empty((f, height, width), dtype=torch.int32,
                            device=dev),
                *(torch.empty((f, height // 2, width // 2),
                              dtype=torch.int32, device=dev)
                  for _ in range(2)))
    if f == 0:
        return outs if mode == _PLANES else outs[0]
    tables, geo = kernel_args(f, width, height)
    ptrs = [o.data_ptr() for o in outs] + [None] * (3 - len(outs))
    with _build.on_device(levels_zz) as (lib, stream):
        rc = lib.amv_amvlib_idct(
            levels.data_ptr(), tables.ctypes.data, geo, *ptrs, mode,
            stream)
    _build.check(rc, "amv_amvlib_idct")
    global LAUNCHES
    LAUNCHES += 1
    return outs if mode == _PLANES else outs[0]


# ---------------------------------------------------------------- plain

def _idct_row_wang(c):
    """idctrow on 8 int32 tensors (AmvJpeg.c:1082-1128)."""
    x1 = c[4] << 11
    x2, x3, x4, x5, x6, x7 = c[6], c[2], c[1], c[7], c[5], c[3]
    shortcut = (x1 | x2 | x3 | x4 | x5 | x6 | x7) == 0
    short_val = c[0] << 3

    x0 = (c[0] << 11) + 128
    x8 = W7 * (x4 + x5)
    x4b = x8 + (W1 - W7) * x4
    x5b = x8 - (W1 + W7) * x5
    x8 = W3 * (x6 + x7)
    x6b = x8 - (W3 - W5) * x6
    x7b = x8 - (W3 + W5) * x7
    x8 = x0 + x1
    x0 = x0 - x1
    x1b = W6 * (x3 + x2)
    x2b = x1b - (W2 + W6) * x2
    x3b = x1b + (W2 - W6) * x3
    x1c = x4b + x6b
    x4c = x4b - x6b
    x6c = x5b + x7b
    x5c = x5b - x7b
    x7c = x8 + x3b
    x8 = x8 - x3b
    x3c = x0 + x2b
    x0 = x0 - x2b
    x2c = (181 * (x4c + x5c) + 128) >> 8
    x4d = (181 * (x4c - x5c) + 128) >> 8
    out = [(x7c + x1c) >> 8, (x3c + x2c) >> 8, (x0 + x4d) >> 8,
           (x8 + x6c) >> 8, (x8 - x6c) >> 8, (x0 - x4d) >> 8,
           (x3c - x2c) >> 8, (x7c - x1c) >> 8]
    return [torch.where(shortcut, short_val, o) for o in out]


def _idct_col_wang(c):
    """idctcol (AmvJpeg.c:1130-1176); clipped to [-256, 255]."""
    x1 = c[4] << 8
    x2, x3, x4, x5, x6, x7 = c[6], c[2], c[1], c[7], c[5], c[3]
    shortcut = (x1 | x2 | x3 | x4 | x5 | x6 | x7) == 0
    short_val = torch.clamp((c[0] + 32) >> 6, -256, 255)

    x0 = (c[0] << 8) + 8192
    x8 = W7 * (x4 + x5) + 4
    x4b = (x8 + (W1 - W7) * x4) >> 3
    x5b = (x8 - (W1 + W7) * x5) >> 3
    x8 = W3 * (x6 + x7) + 4
    x6b = (x8 - (W3 - W5) * x6) >> 3
    x7b = (x8 - (W3 + W5) * x7) >> 3
    x8 = x0 + x1
    x0 = x0 - x1
    x1b = W6 * (x3 + x2) + 4
    x2b = (x1b - (W2 + W6) * x2) >> 3
    x3b = (x1b + (W2 - W6) * x3) >> 3
    x1c = x4b + x6b
    x4c = x4b - x6b
    x6c = x5b + x7b
    x5c = x5b - x7b
    x7c = x8 + x3b
    x8 = x8 - x3b
    x3c = x0 + x2b
    x0 = x0 - x2b
    x2c = (181 * (x4c + x5c) + 128) >> 8
    x4d = (181 * (x4c - x5c) + 128) >> 8
    out = [(x7c + x1c) >> 14, (x3c + x2c) >> 14, (x0 + x4d) >> 14,
           (x8 + x6c) >> 14, (x8 - x6c) >> 14, (x0 - x4d) >> 14,
           (x3c - x2c) >> 14, (x7c - x1c) >> 14]
    return [torch.where(shortcut, short_val, torch.clamp(o, -256, 255))
            for o in out]


def decode_transform_amvlib_plain(levels_zz: torch.Tensor, mb_w: int,
                                  mb_h: int, width: int, height: int):
    """Plain torch version of `decode_transform_amvlib` on any device
    (`amv_tpu/codecs/amvlib_video.py:116-168`)."""
    f, m = levels_zz.shape[0], levels_zz.shape[1]
    dev = levels_zz.device
    lv = levels_zz.to(torch.int32)
    lv[..., 0] = resolve_dc_levels(levels_zz)

    # dequant in zigzag order by amvlib's Q75 pair, then the buggy
    # zigzag -> raster gather
    qt = torch.from_numpy(np.concatenate(
        [np.tile(T.AMVLIB_QUANT_LUMA[None], (4, 1)),
         np.tile(T.AMVLIB_QUANT_CHROMA[None], (2, 1))])).to(dev)
    deq_zz = lv * qt
    raster = deq_zz[..., torch.from_numpy(AMVLIB_ZIGZAG).long().to(dev)]
    blocks = raster.reshape(f, m, 6, 8, 8)

    mid = [_idct_row_wang([blocks[..., r, i] for i in range(8)])
           for r in range(8)]
    cols = [_idct_col_wang([mid[i][j] for i in range(8)]) for j in range(8)]
    # pix[..., i, j] = cols[j][i]
    pix = torch.stack([torch.stack([cols[j][i] for j in range(8)], dim=-1)
                       for i in range(8)], dim=-2)
    offset = torch.where(torch.arange(6, device=dev) < 4, 128, 0).to(
        torch.int32)
    pix = pix + offset[None, None, :, None, None]

    mcu = pix.reshape(f, mb_h, mb_w, 6, 8, 8)
    yb = mcu[:, :, :, :4].reshape(f, mb_h, mb_w, 2, 2, 8, 8)
    ycoded = yb.permute(0, 1, 3, 5, 2, 4, 6).reshape(f, 16 * mb_h,
                                                     16 * mb_w)
    ucoded = mcu[:, :, :, 4].permute(0, 1, 3, 2, 4).reshape(f, 8 * mb_h,
                                                            8 * mb_w)
    vcoded = mcu[:, :, :, 5].permute(0, 1, 3, 2, 4).reshape(f, 8 * mb_h,
                                                            8 * mb_w)
    # amvlib writes bottom-up BMP rows, cancelling the AMV flip: display
    # planes are flipped as on the FFmpeg path
    ch, cw = height // 2, width // 2
    return (ycoded[:, :height, :width].flip(1).contiguous(),
            ucoded[:, :ch, :cw].flip(1).contiguous(),
            vcoded[:, :ch, :cw].flip(1).contiguous())


def rgb_amvlib_plain(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """StoreBuffer's fixed point (AmvJpeg.c:789-840) on amvlib's planes
    (`amv_tpu/codecs/amvlib_video.py:178-185`) -> uint8 RGB [F, H, W, 3]."""
    yv = y << 8
    uu = u.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    vv = v.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    r = (yv + 18 * uu + 367 * vv) >> 8
    g = (yv - 159 * uu - 220 * vv) >> 8
    b = (yv + 411 * uu - 29 * vv) >> 8
    return torch.stack([r, g, b], dim=-1).clamp(0, 255).to(torch.uint8)
