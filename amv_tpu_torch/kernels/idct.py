"""Kernel I: AMV block decode, Q60 dequant + simple_idct -> pixels.

The port of `amv_tpu/kernels/transcode_layout_pallas.py:decode_mcu_layout`
(the device decode chain's transform) and `amv_tpu/kernels/idct_pallas.py:
idct_put_soa` (simple_idct of already dequantized blocks), backed by one
CUDA kernel, csrc/idct.cu.  The layout is frame-major blocks: levels int16
[N, 64] in zigzag order with N = frames * MCUs * 6, block n luma iff
n % 6 < 4.  Arithmetic: `amv_tpu/kernels/idct.py` (simple_idct.c).

On a CUDA tensor the wrappers launch the kernel; on a CPU tensor they run
the plain torch version in this module, which kernel T's plain version
shares.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codecs.jpeg_tables import Q60_CHROMA, Q60_LUMA, ZIGZAG
from . import _build

LAUNCHES = 0

W1, W2, W3, W4, W5, W6, W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520


def idct_blocks(levels: torch.Tensor, dc: torch.Tensor) -> torch.Tensor:
    """Layout entry (decode_mcu_layout's role): levels int16 [N, 64] zigzag
    (slot 0 ignored), dc int32 [N] resolved dequantized DC (+1024 bias) ->
    pixels uint8 [N, 64] raster."""
    if levels.dim() != 2 or levels.shape[1] != 64 or \
            levels.dtype != torch.int16 or levels.shape[0] % 6:
        raise ValueError(f"levels must be int16 [6k, 64], got "
                         f"{levels.dtype} {tuple(levels.shape)}")
    if dc.shape != levels.shape[:1] or dc.dtype != torch.int32:
        raise ValueError(f"dc must be int32 [{levels.shape[0]}], got "
                         f"{dc.dtype} {tuple(dc.shape)}")
    if levels.device.type == "cpu" and dc.device.type == "cpu":
        return idct_blocks_plain(levels, dc)
    _build.require_cuda(levels, dc)
    return _launch(levels.contiguous(), dc.contiguous())


def idct_put(blocks: torch.Tensor) -> torch.Tensor:
    """simple_idct_put (idct_put_soa's role, `amv_tpu.kernels.idct.
    idct_put`'s contract): raster coefficients int16 [..., 8, 8] -> pixels
    uint8 [..., 8, 8], with no dequant."""
    if blocks.dim() < 2 or tuple(blocks.shape[-2:]) != (8, 8) or \
            blocks.dtype != torch.int16:
        raise ValueError(f"blocks must be int16 [..., 8, 8], got "
                         f"{blocks.dtype} {tuple(blocks.shape)}")
    flat = blocks.reshape(-1, 64)
    if flat.device.type == "cpu":
        out = idct_put_plain(flat.long())
    else:
        _build.require_cuda(flat)
        out = _launch(flat.contiguous(), None)
    return out.reshape(blocks.shape).to(torch.uint8)


def _launch(levels, dc):
    if levels.data_ptr() % 16:
        raise ValueError("levels must be 16-byte aligned (vector loads)")
    n = levels.shape[0]
    pix = torch.empty((n, 64), dtype=torch.uint8, device=levels.device)
    tables = np.concatenate([Q60_LUMA, Q60_CHROMA]).astype(np.int32)
    with _build.on_device(levels) as (lib, stream):
        rc = lib.amv_idct_blocks(
            levels.data_ptr(), dc.data_ptr() if dc is not None else None,
            tables.ctypes.data, pix.data_ptr(), n, stream)
    _build.check(rc, "amv_idct_blocks")
    global LAUNCHES
    LAUNCHES += 1
    return pix


# ---------------------------------------------------------------- plain
# int32 two's-complement semantics in int64 tensors: + and * commute with
# the wrap, so values are wrapped (w32) only before a shift or compare.

def w32(x):
    return ((x + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def w16(x):
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def sra(x, n):
    return w32(x) >> n


def dequantize(levels: torch.Tensor, dc: torch.Tensor) -> torch.Tensor:
    """Q60 dequant of zigzag levels int16 [N, 64] (block n luma iff
    n % 6 < 4) with slot 0 replaced by the resolved DC -> raster int64
    [N, 64] coefficients, wrapped to int16 (mjpegdec decode_block)."""
    dev = levels.device
    n = levels.shape[0]
    zz = torch.as_tensor(ZIGZAG, device=dev).long()
    luma = (torch.arange(n, device=dev) % 6 < 4)[:, None]
    qm = torch.where(luma, torch.as_tensor(Q60_LUMA, device=dev).long(),
                     torch.as_tensor(Q60_CHROMA, device=dev).long())
    deq = torch.zeros((n, 64), dtype=torch.int64, device=dev)
    deq[:, zz] = levels.long()
    deq = w16(deq * qm)
    deq[:, 0] = w16(dc.long())
    return deq


def idct_blocks_plain(levels: torch.Tensor, dc: torch.Tensor) -> torch.Tensor:
    """Plain torch version of kernel I's layout entry on any device."""
    return idct_put_plain(dequantize(levels, dc))


def _idct_1d(c, row: bool):
    """simple_idct 1-D pass on 8 tensors (row or column pass)."""
    if row:
        a0 = W4 * c[0] + (1 << 10)
    else:
        a0 = W4 * (c[0] + 32)
    a1 = a0 + W6 * c[2] - W4 * c[4] - W2 * c[6]
    a2 = a0 - W6 * c[2] - W4 * c[4] + W2 * c[6]
    a3 = a0 - W2 * c[2] + W4 * c[4] - W6 * c[6]
    a0 = a0 + W2 * c[2] + W4 * c[4] + W6 * c[6]
    b0 = W1 * c[1] + W3 * c[3] + W5 * c[5] + W7 * c[7]
    b1 = W3 * c[1] - W7 * c[3] - W1 * c[5] - W5 * c[7]
    b2 = W5 * c[1] - W1 * c[3] + W7 * c[5] + W3 * c[7]
    b3 = W7 * c[1] - W5 * c[3] + W3 * c[5] - W1 * c[7]
    return [a0 + b0, a1 + b1, a2 + b2, a3 + b3,
            a3 - b3, a2 - b2, a1 - b1, a0 - b0]


def idct_put_plain(coef: torch.Tensor) -> torch.Tensor:
    """Plain torch simple_idct_put on any device: raster coefficients
    (int16-range integers) [N, 64] -> pixels uint8 [N, 64] raster."""
    n = coef.shape[0]
    blk = coef.long().view(n, 8, 8)
    c = [blk[:, :, k] for k in range(8)]        # column k of every row
    dc_only = (c[1] | c[2] | c[3] | c[4] | c[5] | c[6] | c[7]) == 0
    short = w16(c[0] << 3)
    rows = [torch.where(dc_only, short, w16(sra(o, 11)))
            for o in _idct_1d(c, row=True)]
    mid = torch.stack(rows, dim=2)                      # [n, row, col]
    cols = [mid[:, i, :] for i in range(8)]              # row i, all columns
    pix = [torch.clamp(sra(o, 20), 0, 255) for o in _idct_1d(cols, row=False)]
    return torch.stack(pix, dim=1).reshape(n, 64).to(torch.uint8)
