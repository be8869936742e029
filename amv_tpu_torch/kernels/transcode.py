"""Kernel T: the fused block transcode, dequant + IDCT + FDCT + requant.

The port of `amv_tpu/kernels/transcode_layout_pallas.py:
transcode_mcu_layout` (the complete chain's transform),
`amv_tpu/kernels/transcode_pallas.py:transcode_zz` (the host-entropy
route, which also emits pixels), its wrap `transcode_zz_wrap`
(`repeat=`) and `transcode_soa` / `transcode_soa3` (dequantized blocks in,
`transcode_deq`), backed by one CUDA kernel, csrc/transcode.cu, whose
template mode picks the entry.  The layout here is frame-major blocks:
levels int16 [N, 64] in zigzag order with N = frames * MCUs * 6, block n
luma iff n % 6 < 4; the JAX entries' coefficient-major [64, N] is its
transpose.

On a CUDA tensor the wrappers launch the kernel; on a CPU tensor they run
`transcode_blocks_plain`, the plain versions of kernels I and F with the
edge replication between them (the kernel shares csrc/dct.cuh with I and
F the same way).
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch

from ..codecs.jpeg_tables import Q60_CHROMA, Q60_LUMA, ZIGZAG
from . import _build
from .decode_fused import coded_planes
from .encode_fused import mcu_blocks
from .fdct import fdct_quantize_plain
from .idct import dequantize, idct_put_plain

LAUNCHES = 0
WRAP_TILE = 512      # transcode_zz_wrap's default lane tile, for its checks
_ZIGZAG, _WRAP, _DEQ = 0, 1, 2     # csrc/transcode.cu kMode


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
                         qmat: np.ndarray, size=None, repeat: int = 1):
    """Pixel entry (transcode_zz's role): as `transcode_blocks`, plus the
    decoded pixels uint8 [N, 64] in raster order (before any edge
    replication).

    repeat=k (transcode_zz_wrap's role) transcodes the base levels
    [n_base, 64] logically tiled k times without materializing them, in
    JAX's tiling: in the [64, 8, nm] view of the blocks, output block
    s * nm_full + m reads base block s * nm_base + m % nm_base, with
    nm = blocks / 8 and nm_full = k * nm_base.  dc is the full length
    [k * n_base]; as in JAX, nm_base % 6 == 0 and k must be a multiple of
    512 / gcd(nm_base, 512); size must be None."""
    if repeat == 1:
        return _transcode(levels, dc, qmat, size, True)
    n_base = levels.shape[0]
    nm_base = n_base // 8
    if repeat < 1 or n_base % 8 or nm_base % 6:
        raise ValueError(f"repeat={repeat} over {n_base} base blocks needs "
                         "repeat >= 1, 8 | n_base and 6 | n_base/8")
    pf = WRAP_TILE // math.gcd(nm_base, WRAP_TILE)
    if repeat % pf:
        raise ValueError(f"repeat={repeat} must be a multiple of the "
                         f"alignment pretile pf={pf}")
    if size is not None:
        raise ValueError("repeat > 1 takes no picture size")
    if dc.shape != (n_base * repeat,):
        raise ValueError(f"dc must be [{n_base * repeat}] (the full "
                         f"length), got {tuple(dc.shape)}")
    return _transcode(levels, dc, qmat, None, True, repeat)


def transcode_deq(deq: torch.Tensor, qmat: np.ndarray):
    """Dequantized entry (transcode_soa's and transcode_soa3's role, which
    are bit-identical): blocks int16 [N, 64] raster, already dequantized
    with the DC included -> (pixels uint8 [N, 64] raster, levels int16
    [N, 64] raster, slot 0 = absolute DC).  No dequant and no edge
    replication; N is any count."""
    if deq.dim() != 2 or deq.shape[1] != 64 or deq.dtype != torch.int16:
        raise ValueError(f"deq must be int16 [N, 64], got {deq.dtype} "
                         f"{tuple(deq.shape)}")
    qmat = _qmat(qmat)
    if deq.device.type == "cpu":
        return transcode_deq_plain(deq, qmat)
    _build.require_cuda(deq)
    deq = deq.contiguous()
    out, pix = _launch(deq, None, qmat, (1, 1, 16, 16), True, _DEQ)
    return pix, out


def takes_size(size) -> bool:
    """Whether kernel T's edge replication covers frames of `size`: None,
    or an even width and height.  An odd size can leave a chroma pad
    block with no picture pixel in its MCU (h = 16 k + 1 has 8 k chroma
    rows), which the two-stage route (kernels U then V) covers."""
    return size is None or (size[0] % 2 == 0 and size[1] % 2 == 0)


def _geometry(size, n: int):
    """(mb_w, mb_h, width, height) of the frames of n blocks; a geometry
    with no pad pixels for size=None."""
    if size is None:
        return 1, 1, 16, 16
    w, h = size
    if w <= 0 or h <= 0:
        raise ValueError(f"{w}x{h}: not a picture size")
    if not takes_size(size):
        raise NotImplementedError(
            f"{w}x{h}: kernel T takes even sizes only; odd sizes take the "
            "two-stage transform (pipeline.transcode.reencode_planes)")
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    if n % (6 * mb_w * mb_h):
        raise ValueError(f"{n} blocks are not whole {w}x{h} frames")
    return mb_w, mb_h, w, h


def _qmat(qmat):
    qmat = np.ascontiguousarray(qmat, np.int32)
    if qmat.shape != (64,):
        raise ValueError(f"qmat must be [64], got {qmat.shape}")
    return qmat


def _transcode(levels, dc, qmat, size, with_pix, repeat=1):
    if levels.dim() != 2 or levels.shape[1] != 64 or \
            levels.dtype != torch.int16 or levels.shape[0] % 6:
        raise ValueError(f"levels must be int16 [6k, 64], got "
                         f"{levels.dtype} {tuple(levels.shape)}")
    n = levels.shape[0] * repeat
    if dc.shape != (n,) or dc.dtype != torch.int32:
        raise ValueError(f"dc must be int32 [{n}], got "
                         f"{dc.dtype} {tuple(dc.shape)}")
    qmat = _qmat(qmat)
    geom = _geometry(size, n)
    if levels.device.type == "cpu" and dc.device.type == "cpu":
        if repeat > 1:
            levels = levels[wrap_index(levels.shape[0], repeat, levels.device)]
        return transcode_blocks_plain(levels, dc, qmat, geom, with_pix)
    _build.require_cuda(levels, dc)
    return _launch(levels.contiguous(), dc.contiguous(), qmat, geom,
                   with_pix, _WRAP if repeat > 1 else _ZIGZAG, repeat)


def _launch(levels, dc, qmat, geom, with_pix, mode, repeat=1):
    """One launch of kernel T in `mode` over levels [n_base, 64]."""
    if levels.data_ptr() % 16:
        raise ValueError("levels must be 16-byte aligned (vector loads)")
    n_base = levels.shape[0]
    n = n_base * repeat
    if n >= 2 ** 31:
        raise ValueError(f"{n} blocks: kernel T takes fewer than 2^31 "
                         "(32-bit indices)")
    out = torch.empty((n, 64), dtype=torch.int16, device=levels.device)
    pix = (torch.empty((n, 64), dtype=torch.uint8, device=levels.device)
           if with_pix else None)
    tables, geo = kernel_args(qmat, geom, n, n_base)
    with torch.cuda.device(levels.device):
        rc = _build.library().amv_transcode_blocks(
            levels.data_ptr(), dc.data_ptr() if dc is not None else None,
            tables.ctypes.data, geo, out.data_ptr(),
            pix.data_ptr() if with_pix else None, n, mode, _build.stream())
    _build.check(rc, "amv_transcode_blocks")
    global LAUNCHES
    LAUNCHES += 1
    return out, pix


def kernel_args(qmat, geom, n: int, n_base: int):
    """csrc/transcode.cu's Tables (int32 [192]: qmat, Q60 luma, Q60
    chroma) and Geom (7 int32: MCUs a row and a frame, width, height, the
    wrap's nm_full and nm_base, whether the frames have pad pixels) for n
    output blocks over n_base input blocks."""
    tables = np.concatenate([qmat, Q60_LUMA, Q60_CHROMA]).astype(np.int32)
    mb_w, mb_h, w, h = geom
    geo = struct.pack("<7i", mb_w, mb_w * mb_h, w, h, n // 8, n_base // 8,
                      has_pad(geom))
    return tables, geo


def has_pad(geom) -> bool:
    """Whether frames of geometry (mb_w, mb_h, width, height) have pad
    pixels, which take the encoder's edge replication."""
    mb_w, mb_h, w, h = geom
    return w != 16 * mb_w or h != 16 * mb_h


def wrap_index(n_base: int, repeat: int, device=None) -> torch.Tensor:
    """The base block each output block of the repeat-times wrap reads:
    int64 [n_base * repeat] (transcode_zz_wrap's tiling of the [64, 8, nm]
    view along m)."""
    nm_base = n_base // 8
    nm_full = nm_base * repeat
    b = torch.arange(n_base * repeat, device=device)
    return b // nm_full * nm_base + b % nm_full % nm_base


# ---------------------------------------------------------------- plain
# the plain halves of kernels I and F (dct.cuh on the card)

def _edge_replicate(pix, geom):
    """Encoder edge replication of decoded blocks [N, 8, 8] for frames of
    geometry (mb_w, mb_h, width, height): every pad pixel takes the value
    of the nearest picture pixel (extract_blocks' flip + edge pad)."""
    if not has_pad(geom):
        return pix
    mb_w, mb_h, w, h = geom
    planes = []
    for p, ph, pw in zip(coded_planes(pix.reshape(-1, mb_w * mb_h, 6, 8, 8),
                                      mb_w, mb_h),
                         (h, h // 2, h // 2), (w, w // 2, w // 2)):
        rows = torch.arange(p.shape[1], device=p.device).clamp(max=ph - 1)
        cols = torch.arange(p.shape[2], device=p.device).clamp(max=pw - 1)
        planes.append(p[:, rows][:, :, cols])
    return mcu_blocks(*planes, mb_w, mb_h).reshape(-1, 8, 8)


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


def transcode_deq_plain(deq: torch.Tensor, qmat: np.ndarray):
    """Plain torch version of `transcode_deq` on any device: (pixels uint8
    [N, 64] raster, levels int16 [N, 64] raster)."""
    pix = idct_put_plain(deq.long())
    return pix, fdct_quantize_plain(pix, qmat)
