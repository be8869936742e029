"""Kernel T: the fused block transcode, dequant + IDCT + FDCT + requant.

The port of `amv_tpu/kernels/transcode_layout_pallas.py:
transcode_mcu_layout` (the complete chain's transform) and
`amv_tpu/kernels/transcode_pallas.py:transcode_zz` (the host-entropy
route, which also emits pixels), backed by one CUDA kernel,
csrc/transcode.cu.  The layout here is frame-major blocks: levels int16
[N, 64] in zigzag order with N = frames * MCUs * 6, block n luma iff
n % 6 < 4.

On a CUDA tensor the wrappers launch the kernel; on a CPU tensor they run
`transcode_blocks_plain`, the same integer formulas vectorized in torch.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..codecs.amv_video import Q60_CHROMA, Q60_LUMA, ZIGZAG
from . import _build

LAUNCHES = 0

W1, W2, W3, W4, W5, W6, W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520


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
# int32 two's-complement semantics in int64 tensors: + and * commute with
# the wrap, so values are wrapped (_w32) only before a shift or compare.

def _w32(x):
    return ((x + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def _w16(x):
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _sra(x, n):
    return _w32(x) >> n


def _idct_1d(c, row: bool):
    """simple_idct 1-D pass on 8 lists-of-tensors (row or column pass)."""
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


def _fdct_1d(c, pass1: bool):
    """jfdctint 1-D pass (fdct_pallas._fdct_1d) on 8 tensors."""
    sh = 9 if pass1 else 17

    def desc(x, n):
        return _w16(_sra(x + (1 << (n - 1)), n))

    t0, t7 = c[0] + c[7], c[0] - c[7]
    t1, t6 = c[1] + c[6], c[1] - c[6]
    t2, t5 = c[2] + c[5], c[2] - c[5]
    t3, t4 = c[3] + c[4], c[3] - c[4]
    t10, t13 = t0 + t3, t0 - t3
    t11, t12 = t1 + t2, t1 - t2
    if pass1:
        o0, o4 = _w16((t10 + t11) << 4), _w16((t10 - t11) << 4)
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
    dev = levels.device
    n = levels.shape[0]
    zz = torch.as_tensor(ZIGZAG, device=dev)
    luma = (torch.arange(n, device=dev) % 6 < 4)[:, None]
    qm = torch.where(luma, torch.as_tensor(Q60_LUMA, device=dev).long(),
                     torch.as_tensor(Q60_CHROMA, device=dev).long())
    deq = torch.zeros((n, 64), dtype=torch.int64, device=dev)
    deq[:, zz] = levels.long()
    deq = _w16(deq * qm)
    deq[:, 0] = _w16(dc.long())
    blk = deq.view(n, 8, 8)

    # row pass: c[k] = column k of every row, [n, 8]
    c = [blk[:, :, k] for k in range(8)]
    dc_only = (c[1] | c[2] | c[3] | c[4] | c[5] | c[6] | c[7]) == 0
    short = _w16(c[0] << 3)
    rows = [torch.where(dc_only, short, _w16(_sra(o, 11)))
            for o in _idct_1d(c, row=True)]
    mid = torch.stack(rows, dim=2)                      # [n, row, col]
    cols = [mid[:, i, :] for i in range(8)]              # row i, all columns
    pixr = [torch.clamp(_sra(o, 20), 0, 255) for o in _idct_1d(cols, row=False)]
    decoded = torch.stack(pixr, dim=1)                   # [n, 8, 8] raster
    pix = _edge_replicate(decoded, geom)

    p1 = _fdct_1d([pix[:, :, k] for k in range(8)], pass1=True)
    m1 = torch.stack(p1, dim=2)
    p2 = _fdct_1d([m1[:, i, :] for i in range(8)], pass1=False)
    coef = torch.stack(p2, dim=1).reshape(n, 64)         # raster

    q = torch.as_tensor(qmat.astype(np.int64), device=dev)
    level = _w32(coef * q)
    neg = -(_w32(-level) >> 22)
    quant = torch.clamp(torch.where(level >= 0, level >> 22, neg),
                        -1023, 1023)
    quant[:, 0] = (coef[:, 0] + 32) >> 6
    lv2 = quant[:, zz].to(torch.int16)
    return lv2, (decoded.reshape(n, 64).to(torch.uint8) if with_pix
                 else None)
