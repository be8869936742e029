"""Kernel T: the fused block transcode, dequant + IDCT + FDCT + requant.

The port of `amv_tpu/kernels/transcode_layout_pallas.py:
transcode_mcu_layout` (the complete chain's transform) and
`amv_tpu/kernels/transcode_pallas.py:transcode_zz` (the host-entropy
route, which also emits pixels), backed by one CUDA kernel,
csrc/transcode.cu.  The layout here is frame-major blocks: levels int16
[N, 64] in zigzag order with N = frames * MCUs * 6, block n luma iff
n % 6 < 4.

On a CUDA tensor the wrappers launch the kernel; on a CPU tensor they run
`transcode_blocks_plain`, the plain versions of kernels I and F with the
edge replication between them (the kernel shares csrc/dct.cuh with I and
F the same way).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..codecs.jpeg_tables import Q60_CHROMA, Q60_LUMA, ZIGZAG
from . import _build
from .fdct import fdct_quantize_plain
from .idct import dequantize, idct_put_plain

LAUNCHES = 0


def transcode_blocks(levels: torch.Tensor, dc: torch.Tensor,
                     qmat: np.ndarray, size=None) -> torch.Tensor:
    """Layout entry (transcode_mcu_layout's role).

    levels int16 [N, 64] zigzag (slot 0 ignored), N = frames * MCUs * 6;
    dc int32 [N] resolved dequantized DC (+1024 bias); qmat int32 [64]
    raster encoder quantizer -> int16 [N, 64] zigzag re-quantized levels,
    slot 0 = absolute DC.

    size=(width, height) re-encodes the picture of that size: pixels in
    the pad of the last MCU row/column take the encoder's edge
    replication, as the two-stage decode + encode does.  size=None keeps
    every decoded pixel (the JAX fused transform's semantics)."""
    return _transcode(levels, dc, qmat, size, False)[0]


def transcode_blocks_pix(levels: torch.Tensor, dc: torch.Tensor,
                         qmat: np.ndarray, size=None):
    """Pixel entry (transcode_zz's role): as `transcode_blocks`, plus the
    decoded pixels uint8 [N, 64] in raster order (before any edge
    replication)."""
    return _transcode(levels, dc, qmat, size, True)


def _geometry(size, n: int):
    """(mb_w, mb_h, width, height) of the frames of n blocks; a geometry
    with no pad pixels for size=None."""
    if size is None:
        return 1, 1, 16, 16
    w, h = size
    if w % 2 or h % 2 or w <= 0 or h <= 0:
        raise NotImplementedError(
            f"{w}x{h}: odd picture sizes are not yet ported (ROADMAP "
            "queue 1, item 6)")
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    if n % (6 * mb_w * mb_h):
        raise ValueError(f"{n} blocks are not whole {w}x{h} frames")
    return mb_w, mb_h, w, h


def _transcode(levels, dc, qmat, size, with_pix):
    if levels.dim() != 2 or levels.shape[1] != 64 or \
            levels.dtype != torch.int16 or levels.shape[0] % 6:
        raise ValueError(f"levels must be int16 [6k, 64], got "
                         f"{levels.dtype} {tuple(levels.shape)}")
    if dc.shape != levels.shape[:1] or dc.dtype != torch.int32:
        raise ValueError(f"dc must be int32 [{levels.shape[0]}], got "
                         f"{dc.dtype} {tuple(dc.shape)}")
    qmat = np.ascontiguousarray(qmat, np.int32)
    if qmat.shape != (64,):
        raise ValueError(f"qmat must be [64], got {qmat.shape}")
    n = levels.shape[0]
    geom = _geometry(size, n)
    if levels.device.type == "cpu" and dc.device.type == "cpu":
        return transcode_blocks_plain(levels, dc, qmat, geom, with_pix)
    _build.require_cuda(levels, dc)
    levels, dc = levels.contiguous(), dc.contiguous()
    if levels.data_ptr() % 16:
        raise ValueError("levels must be 16-byte aligned (vector loads)")
    out = torch.empty_like(levels)
    pix = (torch.empty((n, 64), dtype=torch.uint8, device=levels.device)
           if with_pix else None)
    tables = np.concatenate([qmat, Q60_LUMA, Q60_CHROMA]).astype(np.int32)
    mb_w, mb_h, w, h = geom
    geo = struct.pack("<qqii", mb_w, mb_w * mb_h, w, h)
    with torch.cuda.device(levels.device):
        rc = _build.library().amv_transcode_blocks(
            levels.data_ptr(), dc.data_ptr(), tables.ctypes.data, geo,
            out.data_ptr(), pix.data_ptr() if with_pix else None, n,
            _build.stream())
    _build.check(rc, "amv_transcode_blocks")
    global LAUNCHES
    LAUNCHES += 1
    return out, pix


# ---------------------------------------------------------------- plain
# the plain halves of kernels I and F (dct.cuh on the card)

def _edge_replicate(pix, geom):
    """Encoder edge replication of decoded blocks [N, 8, 8] for frames of
    geometry (mb_w, mb_h, width, height): every pad pixel takes the value
    of the nearest picture pixel (extract_blocks' flip + edge pad)."""
    mb_w, mb_h, w, h = geom
    if w == 16 * mb_w and h == 16 * mb_h:
        return pix
    dev = pix.device
    b = pix.reshape(-1, mb_h, mb_w, 6, 8, 8)
    f = b.shape[0]
    y = (b[:, :, :, :4].reshape(f, mb_h, mb_w, 2, 2, 8, 8)
         .permute(0, 1, 3, 5, 2, 4, 6).reshape(f, 16 * mb_h, 16 * mb_w))
    ry = torch.arange(16 * mb_h, device=dev).clamp(max=h - 1)
    cy = torch.arange(16 * mb_w, device=dev).clamp(max=w - 1)
    y = y[:, ry][:, :, cy]
    y = (y.reshape(f, mb_h, 2, 8, mb_w, 2, 8).permute(0, 1, 4, 2, 5, 3, 6)
         .reshape(f, mb_h, mb_w, 4, 8, 8))
    rc = torch.arange(8 * mb_h, device=dev).clamp(max=h // 2 - 1)
    cc = torch.arange(8 * mb_w, device=dev).clamp(max=w // 2 - 1)
    chroma = []
    for k in (4, 5):
        p = b[:, :, :, k].permute(0, 1, 3, 2, 4).reshape(f, 8 * mb_h, 8 * mb_w)
        p = p[:, rc][:, :, cc]
        chroma.append(p.reshape(f, mb_h, 8, mb_w, 8).permute(0, 1, 3, 2, 4)
                      [:, :, :, None])
    return torch.cat([y] + chroma, dim=3).reshape(-1, 8, 8)


def transcode_blocks_plain(levels: torch.Tensor, dc: torch.Tensor,
                           qmat: np.ndarray, geom=(1, 1, 16, 16),
                           with_pix: bool = True):
    """Plain torch version of kernel T on any device: (lv2 [N, 64] int16
    zigzag, pix [N, 64] uint8 raster or None); geom as `_geometry`."""
    decoded = idct_put_plain(dequantize(levels, dc))
    pix = _edge_replicate(decoded.view(-1, 8, 8), geom).reshape(-1, 64)
    lv2 = fdct_quantize_plain(pix, qmat)[
        :, torch.as_tensor(ZIGZAG, device=levels.device).long()]
    return lv2, (decoded if with_pix else None)
