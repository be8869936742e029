"""YUV420 <-> RGB conversion as torch ops on any device (libswscale's
role): the port of `amv_tpu/kernels/color.py`.

* "bt601": full-range BT.601 (the JPEG/JFIF convention) in 16-bit fixed
  point, libswscale's default path;
* "amvlib": amvlib's StoreBuffer constants (C-AMVDecoder/amvlib/
  AmvJpeg.c:808-829) on 128-centred chroma.

Chroma upsampling replicates each sample 2x2; the 4:2:0 reduction of
`rgb_to_yuv420_bt601` is the rounded 2x2 mean.  All arithmetic is int32
with arithmetic right shifts, as in the JAX package, and the results are
clipped to uint8.
"""

from __future__ import annotations

import torch


def _upsample2(c: torch.Tensor) -> torch.Tensor:
    """[..., H/2, W/2] -> int32 [..., H, W] by replication."""
    c = c.to(torch.int32)
    return c.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def _rgb8(r, g, b) -> torch.Tensor:
    return torch.stack([r, g, b], dim=-1).clamp(0, 255).to(torch.uint8)


def yuv420_to_rgb_bt601(y: torch.Tensor, cb: torch.Tensor,
                        cr: torch.Tensor) -> torch.Tensor:
    """Full-range BT.601 -> uint8 RGB [..., H, W, 3]: R = Y + 1.402 (Cr -
    128), G = Y - 0.344136 (Cb - 128) - 0.714136 (Cr - 128), B = Y + 1.772
    (Cb - 128), in 16-bit fixed point."""
    yv = y.to(torch.int32) << 16
    u = _upsample2(cb) - 128
    v = _upsample2(cr) - 128
    return _rgb8((yv + 91881 * v + 32768) >> 16,
                 (yv - 22554 * u - 46802 * v + 32768) >> 16,
                 (yv + 116130 * u + 32768) >> 16)


def yuv420_to_rgb_amvlib(y: torch.Tensor, cb: torch.Tensor,
                         cr: torch.Tensor) -> torch.Tensor:
    """amvlib's StoreBuffer fixed point (AmvJpeg.c:808-829) -> uint8 RGB
    [..., H, W, 3]."""
    yv = y.to(torch.int32) << 8
    u = _upsample2(cb) - 128
    v = _upsample2(cr) - 128
    return _rgb8((yv + 18 * u + 367 * v) >> 8,
                 (yv - 159 * u - 220 * v) >> 8,
                 (yv + 411 * u - 29 * v) >> 8)


def rgb_to_yuv420_bt601(rgb: torch.Tensor):
    """uint8 RGB [..., H, W, 3] -> full-range YUV420 planes (y uint8 [..., H,
    W], cb and cr uint8 [..., H/2, W/2]): Y = 0.299 R + 0.587 G + 0.114 B,
    chroma at full resolution, then the rounded 2x2 mean, offset 128."""
    r, g, b = (rgb[..., k].to(torch.int32) for k in range(3))
    yy = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16
    cb = ((-11059 * r - 21709 * g + 32768 * b + 32768) >> 16) + 128
    cr = ((32768 * r - 27439 * g - 5329 * b + 32768) >> 16) + 128

    def box2(c):
        return (c[..., 0::2, 0::2] + c[..., 0::2, 1::2] + c[..., 1::2, 0::2]
                + c[..., 1::2, 1::2] + 2) >> 2

    return tuple(p.clamp(0, 255).to(torch.uint8)
                 for p in (yy, box2(cb), box2(cr)))


def yuv420_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                  mode: str = "bt601") -> torch.Tensor:
    """uint8 RGB [..., H, W, 3] of YUV420 planes in `mode` ("bt601" or
    "amvlib"), on the planes' device."""
    fn = {"bt601": yuv420_to_rgb_bt601, "amvlib": yuv420_to_rgb_amvlib}[mode]
    return fn(y, cb, cr)
