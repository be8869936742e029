"""Kernel F: AMV block encode, jfdctint FDCT + dct_quantize -> levels.

The port of `amv_tpu/kernels/transcode_layout_pallas.py:encode_mcu_layout`
(the device encode chain's transform, zigzag output) and `amv_tpu/kernels/
fdct_pallas.py:_fdct_quant_soa` (raster output, `fdct_quantize`'s
contract), backed by one CUDA kernel, csrc/fdct.cu.  Arithmetic:
`amv_tpu/kernels/fdct.py` (jfdctint.c, mpegvideo_enc.c dct_quantize_c).

On a CUDA tensor the wrappers launch the kernel; on a CPU tensor they run
the plain torch version in this module, which kernel T's plain version
shares.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codecs.jpeg_tables import ZIGZAG
from . import _build
from .idct import sra, w16, w32

LAUNCHES = 0


def fdct_quant_blocks(pix: torch.Tensor, qmat: np.ndarray) -> torch.Tensor:
    """Layout entry (encode_mcu_layout's role): pixels uint8 [N, 64]
    raster, qmat int32 [64] raster encoder quantizer -> levels int16
    [N, 64] zigzag, slot 0 the absolute DC (coef + 32) >> 6."""
    return _fdct(pix, qmat, zigzag=True)


def fdct_quantize(blocks: torch.Tensor, qmat: np.ndarray) -> torch.Tensor:
    """`amv_tpu.kernels.fdct.fdct_quantize`'s contract: pixels uint8
    [..., 8, 8] -> levels int16 [..., 64] raster, slot 0 the DC."""
    if blocks.dim() < 2 or tuple(blocks.shape[-2:]) != (8, 8):
        raise ValueError(f"blocks must be [..., 8, 8], got "
                         f"{tuple(blocks.shape)}")
    out = _fdct(blocks.reshape(-1, 64), qmat, zigzag=False)
    return out.reshape(*blocks.shape[:-2], 64)


def _fdct(pix, qmat, zigzag):
    if pix.dim() != 2 or pix.shape[1] != 64 or pix.dtype != torch.uint8:
        raise ValueError(f"pixels must be uint8 [N, 64], got "
                         f"{pix.dtype} {tuple(pix.shape)}")
    qmat = np.ascontiguousarray(qmat, np.int32)
    if qmat.shape != (64,):
        raise ValueError(f"qmat must be [64], got {qmat.shape}")
    if pix.device.type == "cpu":
        out = fdct_quantize_plain(pix, qmat)
        return out[:, torch.as_tensor(ZIGZAG).long()] if zigzag else out
    _build.require_cuda(pix)
    pix = pix.contiguous()
    if pix.data_ptr() % 16:
        raise ValueError("pixels must be 16-byte aligned (vector loads)")
    n = pix.shape[0]
    out = torch.empty((n, 64), dtype=torch.int16, device=pix.device)
    with torch.cuda.device(pix.device):
        rc = _build.library().amv_fdct_quant(
            pix.data_ptr(), qmat.ctypes.data, out.data_ptr(), n, int(zigzag),
            _build.stream())
    _build.check(rc, "amv_fdct_quant")
    global LAUNCHES
    LAUNCHES += 1
    return out


# ---------------------------------------------------------------- plain

def _fdct_1d(c, pass1: bool):
    """jfdctint 1-D pass (fdct_pallas._fdct_1d) on 8 tensors."""
    sh = 9 if pass1 else 17

    def desc(x, n):
        return w16(sra(x + (1 << (n - 1)), n))

    t0, t7 = c[0] + c[7], c[0] - c[7]
    t1, t6 = c[1] + c[6], c[1] - c[6]
    t2, t5 = c[2] + c[5], c[2] - c[5]
    t3, t4 = c[3] + c[4], c[3] - c[4]
    t10, t13 = t0 + t3, t0 - t3
    t11, t12 = t1 + t2, t1 - t2
    if pass1:
        o0, o4 = w16((t10 + t11) << 4), w16((t10 - t11) << 4)
    else:
        o0, o4 = desc(t10 + t11, 4), desc(t10 - t11, 4)
    z1 = (t12 + t13) * 4433
    o2 = desc(z1 + t13 * 6270, sh)
    o6 = desc(z1 - t12 * 15137, sh)
    za, zb, zc, zd = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (zc + zd) * 9633
    t4, t5, t6, t7 = t4 * 2446, t5 * 16819, t6 * 25172, t7 * 12299
    za, zb = za * -7373, zb * -20995
    zc = zc * -16069 + z5
    zd = zd * -3196 + z5
    return [o0, desc(t7 + za + zd, sh), o2, desc(t6 + zb + zc, sh),
            o4, desc(t5 + zb + zd, sh), o6, desc(t4 + za + zc, sh)]


def fdct_plain(pix: torch.Tensor) -> torch.Tensor:
    """ff_jpeg_fdct_islow on pixels (0..255 integers) [N, 64] raster ->
    coefficients int64 [N, 64] raster, each wrapped to int16."""
    n = pix.shape[0]
    blk = pix.long().view(n, 8, 8)
    p1 = _fdct_1d([blk[:, :, k] for k in range(8)], pass1=True)
    m1 = torch.stack(p1, dim=2)
    p2 = _fdct_1d([m1[:, i, :] for i in range(8)], pass1=False)
    return torch.stack(p2, dim=1).reshape(n, 64)


def fdct_quantize_plain(pix: torch.Tensor, qmat: np.ndarray) -> torch.Tensor:
    """Plain torch version of kernel F on any device: pixels (0..255
    integers) [N, 64] raster -> levels int16 [N, 64] raster, slot 0 the
    absolute DC (coef + 32) >> 6, AC coef * qmat with a sign-symmetric
    >> 22 and a clip to +-1023, in int32 wraparound."""
    coef = fdct_plain(pix)
    q = torch.as_tensor(np.asarray(qmat, np.int64), device=pix.device)
    level = w32(coef * q)
    neg = -(w32(-level) >> 22)
    quant = torch.clamp(torch.where(level >= 0, level >> 22, neg),
                        -1023, 1023)
    quant[:, 0] = (coef[:, 0] + 32) >> 6
    return quant.to(torch.int16)
