"""Kernel Y: packed and ordered-dithered RGB from YUV420 planes
(libswscale's yuv2rgb output family), the `-pix_fmt` `.rgb`/`.raw` output.

The port of `amv_tpu/kernels/yuv2rgb_dither.py` (XLA ops; no TPU kernel),
with its contracts:

* `yuv420_to_packed(y, cb, cr, fmt, full_range, dither, brightness,
  contrast, saturation)`: the 15 `_FORMATS`, 32-bit XRGB/XBGR
  (yuv2rgb.c:304-328), 24-bit RGB/BGR (:330-381), 16/15-bit 565/555
  undithered (:385-401) or 2x2-dithered (swscale.c:578-607), 8-bit
  R3G3B2/B2G3R3 (yuv2rgb.c:424-455), 4-bit 1-2-1 as nibble pairs (:493-528)
  or a byte a pixel (:550-582), and 1-bit monochrome (:584-615);
* `yuv420_to_yuyv422` / `yuv420_to_uyvy422` (swscale.c:705-711): pure
  data movement, one `torch.stack` of the planes on any device (not an
  entry of kernel Y).

The conversion is table-driven like the reference: one flat table arena a
depth built by the `yuv2rgb_c_init_tables` recipe (yuv2rgb.c:697-902,
`_build_tables`, host numpy, cached), per-U/V index offsets, and per-pixel
gathers `r[Y + off_r(V) + dr] + g[Y + off_g(U, V) + dg] + b[Y + off_b(U) +
db]` with the flat index clamped to the arena (the JAX package's
convention where the C reads out of its tables).  Chroma is replicated
2x2.

Outputs: the JAX package's shapes; its uint32 and uint16 results are int32
and int16 tensors here holding the same bits (the bytes written are the
same).  On a CUDA tensor `yuv420_to_packed` launches kernel Y
(csrc/yuv2rgb_packed.cu) once; on a CPU tensor it runs the plain torch
version, `yuv420_to_packed_plain`, which follows the JAX function step by
step.
"""

from __future__ import annotations

import struct
from functools import lru_cache

import numpy as np
import torch

from . import _build

LAUNCHES = 0

# --- ordered-dither matrices (yuv2rgb.c:52-120) ---

DITHER_2X2_4 = np.array([[1, 3], [2, 0]], np.int32)
DITHER_2X2_8 = np.array([[6, 2], [0, 4]], np.int32)

DITHER_8X8_32 = np.array([
    [17, 9, 23, 15, 16, 8, 22, 14],
    [5, 29, 3, 27, 4, 28, 2, 26],
    [21, 13, 19, 11, 20, 12, 18, 10],
    [0, 24, 6, 30, 1, 25, 7, 31],
    [16, 8, 22, 14, 17, 9, 23, 15],
    [4, 28, 2, 26, 5, 29, 3, 27],
    [20, 12, 18, 10, 21, 13, 19, 11],
    [1, 25, 7, 31, 0, 24, 6, 30]], np.int32)

DITHER_8X8_73 = np.array([
    [0, 55, 14, 68, 3, 58, 17, 72],
    [37, 18, 50, 32, 40, 22, 54, 35],
    [9, 64, 5, 59, 13, 67, 8, 63],
    [46, 27, 41, 23, 49, 31, 44, 26],
    [2, 57, 16, 71, 1, 56, 15, 70],
    [39, 21, 52, 34, 38, 19, 51, 33],
    [11, 66, 7, 62, 10, 65, 6, 60],
    [48, 30, 43, 25, 47, 29, 42, 24]], np.int32)

DITHER_8X8_220 = np.array([
    [117, 62, 158, 103, 113, 58, 155, 100],
    [34, 199, 21, 186, 31, 196, 17, 182],
    [144, 89, 131, 76, 141, 86, 127, 72],
    [0, 165, 41, 206, 10, 175, 52, 217],
    [110, 55, 151, 96, 120, 65, 162, 107],
    [28, 193, 14, 179, 38, 203, 24, 189],
    [138, 83, 124, 69, 148, 93, 134, 79],
    [7, 172, 48, 213, 3, 168, 45, 210]], np.int32)

# Inverse_Table_6_9[2] "unspecified", swscale's default coefficients
# (yuv2rgb.c:205-214)
DEFAULT_INV_TABLE = (104597, 132201, 25675, 53279)

# fmt -> (depth, is_rgb); is_rgb puts R in the high field
_FORMATS = {
    "rgb32": (32, True), "bgr32": (32, False),
    "rgb24": (24, True), "bgr24": (24, False),
    "rgb565": (16, True), "bgr565": (16, False),
    "rgb555": (15, True), "bgr555": (15, False),
    "rgb8": (8, True), "bgr8": (8, False),
    "rgb4": (4, True), "bgr4": (4, False),
    "rgb4_byte": (4, True), "bgr4_byte": (4, False),
    "monoblack": (1, True),
}

# the arena shared by depths 32/16/15/8/4 (yuv2rgb.c:749-869): r at +197
# spanning [-197, 452), b at +882 spanning [-232, 488), g at +1561 spanning
# [-132, 388)
_ARENA_LEN = 197 + 2 * 682 + 256 + 132
_BASE_R, _BASE_B, _BASE_G = 197, 882, 1561

# csrc/yuv2rgb_packed.cu's output kinds
KIND_32, KIND_24, KIND_16, KIND_8, KIND_NIBBLE, KIND_MONO = range(6)


def _tdiv(a: int, b: int) -> int:
    """C integer division (truncate toward zero)."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _div_round(dividend: int, divisor: int) -> int:
    """yuv2rgb.c:689-695 div_round (round half away from zero)."""
    if dividend > 0:
        return (dividend + (divisor >> 1)) // divisor
    return -((-dividend + (divisor >> 1)) // divisor)


def _coefficients(full_range: bool, brightness: int, contrast: int,
                  saturation: int, inv_table: tuple = DEFAULT_INV_TABLE):
    """yuv2rgb_c_init_tables' coefficients (yuv2rgb.c:697-735) -> (cy, oy,
    crv, cgu, cgv, cbu): the luma table is clamp((cy * (((i - 384) << 16)
    - oy) + 2^31) >> 32, 0, 255), the offsets div_round(c * (i - 128),
    76309)."""
    crv, cbu = int(inv_table[0]), int(inv_table[1])
    cgu, cgv = -int(inv_table[2]), -int(inv_table[3])
    cy, oy = 1 << 16, 0
    if not full_range:
        cy = _tdiv(cy * 255, 219)
        oy = 16 << 16
    else:
        crv = _tdiv(crv * 224, 255)
        cbu = _tdiv(cbu * 224, 255)
        cgu = _tdiv(cgu * 224, 255)
        cgv = _tdiv(cgv * 224, 255)
    cy = (cy * contrast) >> 16
    crv = (crv * contrast * saturation) >> 32
    cbu = (cbu * contrast * saturation) >> 32
    cgu = (cgu * contrast * saturation) >> 32
    cgv = (cgv * contrast * saturation) >> 32
    oy -= 256 * brightness
    return cy, oy, crv, cgu, cgv, cbu


@lru_cache(maxsize=None)
def _build_tables(fmt: str, full_range: bool,
                  brightness: int = 0, contrast: int = 65536,
                  saturation: int = 65536,
                  inv_table: tuple = DEFAULT_INV_TABLE):
    """yuv2rgb_c_init_tables (yuv2rgb.c:697-902) -> (arena int32 [L],
    base offsets (r, g, b), offset tables off_r/off_gu/off_gv/off_b
    int32 [256])."""
    depth, is_rgb = _FORMATS[fmt]
    cy, oy, crv, cgu, cgv, cbu = _coefficients(
        full_range, brightness, contrast, saturation, inv_table)

    ty = np.empty(1024, np.int64)
    for i in range(1024):
        j = (cy * (((i - 384) << 16) - oy) + (1 << 31)) >> 32
        ty[i] = min(255, max(0, j))

    if depth == 32:
        arena = np.zeros(_ARENA_LEN, np.int64)
        for i in range(-197, 256 + 197):
            arena[_BASE_R + i] = ty[i + 384] << (16 if is_rgb else 0)
        for i in range(-132, 256 + 132):
            arena[_BASE_G + i] = ty[i + 384] << 8
        for i in range(-232, 256 + 232):
            arena[_BASE_B + i] = ty[i + 384] << (0 if is_rgb else 16)
        bases = (_BASE_R, _BASE_G, _BASE_B)
    elif depth == 24:
        # one shared clip table, all channels at +232 (yuv2rgb.c:764-772)
        arena = np.zeros(256 + 2 * 232, np.int64)
        for i in range(-232, 256 + 232):
            arena[232 + i] = ty[i + 384]
        bases = (232, 232, 232)
    elif depth in (15, 16):
        arena = np.zeros(_ARENA_LEN, np.int64)
        for i in range(-197, 256 + 197):
            j = int(ty[i + 384]) >> 3
            if is_rgb:
                j <<= 11 if depth == 16 else 10
            arena[_BASE_R + i] = j
        for i in range(-132, 256 + 132):
            j = int(ty[i + 384]) >> (2 if depth == 16 else 3)
            arena[_BASE_G + i] = j << 5
        for i in range(-232, 256 + 232):
            j = int(ty[i + 384]) >> 3
            if not is_rgb:
                j <<= 11 if depth == 16 else 10
            arena[_BASE_B + i] = j
        bases = (_BASE_R, _BASE_G, _BASE_B)
    elif depth == 8:
        arena = np.zeros(_ARENA_LEN, np.int64)
        for i in range(-197, 256 + 197):
            j = (int(ty[i + 384 - 16]) + 18) // 36
            if is_rgb:
                j <<= 5
            arena[_BASE_R + i] = j
        for i in range(-132, 256 + 132):
            j = (int(ty[i + 384 - 16]) + 18) // 36
            if not is_rgb:
                j <<= 1
            arena[_BASE_G + i] = j << 2
        for i in range(-232, 256 + 232):
            j = (int(ty[i + 384 - 37]) + 43) // 85
            if not is_rgb:
                j <<= 6
            arena[_BASE_B + i] = j
        bases = (_BASE_R, _BASE_G, _BASE_B)
    elif depth == 4:
        arena = np.zeros(_ARENA_LEN, np.int64)
        for i in range(-197, 256 + 197):
            j = int(ty[i + 384 - 110]) >> 7
            if is_rgb:
                j <<= 3
            arena[_BASE_R + i] = j
        for i in range(-132, 256 + 132):
            j = (int(ty[i + 384 - 37]) + 43) // 85
            arena[_BASE_G + i] = j << 1
        for i in range(-232, 256 + 232):
            j = int(ty[i + 384 - 110]) >> 7
            if not is_rgb:
                j <<= 3
            arena[_BASE_B + i] = j
        bases = (_BASE_R, _BASE_G, _BASE_B)
    elif depth == 1:
        arena = np.zeros(512, np.int64)
        for i in range(512):
            arena[i] = int(ty[i + 384 - 110]) >> 7
        bases = (0, 0, 0)
    else:  # pragma: no cover
        raise ValueError(fmt)

    off_r = np.array([_div_round(crv * (i - 128), 76309)
                      for i in range(256)], np.int32)
    off_gu = np.array([_div_round(cgu * (i - 128), 76309)
                       for i in range(256)], np.int32)
    off_gv = np.array([_div_round(cgv * (i - 128), 76309)
                       for i in range(256)], np.int32)
    off_b = np.array([_div_round(cbu * (i - 128), 76309)
                      for i in range(256)], np.int32)
    return (arena.astype(np.int32), bases, off_r, off_gu, off_gv, off_b)


def _dither_mats(depth: int, dither: bool):
    """(dr, dg, db): the dither matrices of each channel (yuv2rgb.c:52-120,
    swscale.c:578-607), indexed [y % rows][x % cols]; None for none."""
    if depth in (15, 16):
        if not dither:          # the unscaled yuv2rgb_c_16 path
            return None, None, None
        # the scaled path: dr and db from dither_2x2_8 on complementary
        # rows, dg from 2x2_4 (565) or the column-swapped 2x2_8 (555)
        dg = DITHER_2X2_4 if depth == 16 else DITHER_2X2_8[:, ::-1]
        return DITHER_2X2_8, dg, DITHER_2X2_8[::-1]
    if depth == 8:              # r and g share d32, b takes d64
        return DITHER_8X8_32, DITHER_8X8_32, DITHER_8X8_73
    if depth == 4:              # r and b share d128, g takes d64
        return DITHER_8X8_220, DITHER_8X8_73, DITHER_8X8_220
    if depth == 1:              # g's table at U = V = 128
        return None, DITHER_8X8_220, None
    return None, None, None


def _tile(mat, h: int, w: int) -> np.ndarray:
    """The per-pixel dither plane D[y % rows][x % cols] of shape (h, w)."""
    if mat is None:
        return np.zeros((h, w), np.int32)
    rows, cols = mat.shape
    return mat[np.arange(h)[:, None] % rows, np.arange(w)[None, :] % cols]


def _check(y, cb, cr, fmt: str):
    if fmt not in _FORMATS:
        raise ValueError(f"unknown packed format {fmt!r}")
    h, w = y.shape[-2], y.shape[-1]
    if w % 2 or h % 2:
        raise ValueError("packed output needs even dimensions")
    if fmt == "monoblack" and w % 8:
        raise ValueError("monoblack needs width % 8 == 0")
    want = (*y.shape[:-2], h // 2, w // 2)
    for name, c in (("cb", cb), ("cr", cr)):
        if tuple(c.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(c.shape)}")
    for t in (y, cb, cr):
        if t.dtype != torch.uint8:
            raise ValueError(f"planes must be uint8, got {t.dtype}")


def yuv420_to_packed(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                     fmt: str = "rgb565", full_range: bool = True,
                     dither: bool = True, brightness: int = 0,
                     contrast: int = 65536, saturation: int = 65536):
    """uint8 YUV420 planes [..., H, W] / [..., H/2, W/2] -> packed pixels
    on their device.

    By fmt: rgb32/bgr32 -> int32 [..., H, W] holding the uint32 X8R8G8B8 /
    X8B8G8R8; rgb24/bgr24 -> uint8 [..., H, W, 3] in memory order;
    rgb565/bgr565/rgb555/bgr555 -> int16 [..., H, W] holding the uint16
    (`dither` selects the scaled path's 2x2 dither over the undithered
    unscaled converter); rgb8/bgr8 -> uint8 R3G3B2/B2G3R3; rgb4/bgr4 ->
    uint8 [..., H, W/2] nibble pairs (low nibble = even column);
    rgb4_byte/bgr4_byte -> uint8 1-2-1 a byte; monoblack -> uint8
    [..., H, W/8], MSB-first bits."""
    _check(y, cb, cr, fmt)
    args = (fmt, full_range, dither, brightness, contrast, saturation)
    if all(t.device.type == "cpu" for t in (y, cb, cr)):
        return yuv420_to_packed_plain(y, cb, cr, *args)
    return _launch(y, cb, cr, *args)


def _out_shape(fmt: str, lead, h: int, w: int):
    """(shape, dtype, kind) of the packed output."""
    depth, _ = _FORMATS[fmt]
    if depth == 32:
        return (*lead, h, w), torch.int32, KIND_32
    if depth == 24:
        return (*lead, h, w, 3), torch.uint8, KIND_24
    if depth in (15, 16):
        return (*lead, h, w), torch.int16, KIND_16
    if depth == 1:
        return (*lead, h, w // 8), torch.uint8, KIND_MONO
    if fmt in ("rgb4", "bgr4"):
        return (*lead, h, w // 2), torch.uint8, KIND_NIBBLE
    return (*lead, h, w), torch.uint8, KIND_8


@lru_cache(maxsize=None)
def kernel_tables(fmt: str, full_range: bool, dither: bool, brightness: int,
                  contrast: int, saturation: int) -> np.ndarray:
    """Kernel Y's table buffer, int32: off_r, off_gu, off_gv, off_b (256
    each), the dither matrices dr, dg, db tiled to 8x8 (64 each; 8 is a
    multiple of every matrix's rows and columns), then the arena."""
    depth, _ = _FORMATS[fmt]
    arena, _, off_r, off_gu, off_gv, off_b = _build_tables(
        fmt, full_range, brightness, contrast, saturation)
    dith = [_tile(d, 8, 8).reshape(-1) for d in _dither_mats(depth, dither)]
    return np.concatenate([off_r, off_gu, off_gv, off_b, *dith,
                           arena]).astype(np.int32)


# the computed path's channel shifts (rshift, lshift) of r, g, b by depth
# and is_rgb: the arena's clip table (yuv2rgb.c:749-812) shifted and masked
_SHIFTS = {
    (32, True): ((0, 16), (0, 8), (0, 0)),
    (32, False): ((0, 0), (0, 8), (0, 16)),
    (24, True): ((0, 0), (0, 0), (0, 0)),
    (24, False): ((0, 0), (0, 0), (0, 0)),
    (16, True): ((3, 11), (2, 5), (3, 0)),
    (16, False): ((3, 0), (2, 5), (3, 11)),
    (15, True): ((3, 10), (3, 5), (3, 0)),
    (15, False): ((3, 0), (3, 5), (3, 10)),
}
_I32 = 2 ** 31


@lru_cache(maxsize=None)
def register_map(fmt: str, full_range: bool, dither: bool, brightness: int,
                 contrast: int, saturation: int):
    """Kernel Y's computed path for this key, or None where it must read
    the tables: (cy, bh, (crv, cgu, cgv, cbu), rshift, lshift, dith2), each
    channel's value clamp((cy * j + bh) >> 16, 0, 255) >> rshift <<
    lshift at j = Y + off + d.  Given only where it equals the arena
    lookup arena[clamp(j + base, 0, L - 1)] at every j the key's offsets
    and dither can reach, in int32 arithmetic, and the offsets' int32
    div_round equals the tables."""
    depth, is_rgb = _FORMATS[fmt]
    if (depth, is_rgb) not in _SHIFTS:
        return None
    cy, oy, crv, cgu, cgv, cbu = _coefficients(full_range, brightness,
                                               contrast, saturation)
    coefs = (crv, cgu, cgv, cbu)
    # csrc/yuv2rgb_packed.cu's div_round(c * (i - 128), 76309) in int32
    if not all(abs(c) * 128 + 38154 < _I32 for c in coefs):
        return None
    arena, bases, off_r, off_gu, off_gv, off_b = _build_tables(
        fmt, full_range, brightness, contrast, saturation)
    i = np.arange(256, dtype=np.int64)
    for c, tab in zip(coefs, (off_r, off_gu, off_gv, off_b)):
        t = c * (i - 128)
        mine = np.where(t > 0, (t + 38154) // 76309,
                        -((38154 - t) // 76309))
        if not np.array_equal(mine, tab):
            return None
    bh = (2 ** 31 - cy * oy) >> 16
    shifts = _SHIFTS[(depth, is_rgb)]
    mats = _dither_mats(depth, dither)
    dith2 = tuple(tuple(tuple(int(v) for v in row) for row in
                        _tile(mat, 2, 2)) for mat in mats)
    offs = ((int(off_r.min()), int(off_r.max())),
            (int(off_gu.min() + off_gv.min()),
             int(off_gu.max() + off_gv.max())),
            (int(off_b.min()), int(off_b.max())))
    hi = len(arena) - 1
    for (lo_o, hi_o), base, (rs, ls), d in zip(offs, bases, shifts, dith2):
        d_lo, d_hi = min(map(min, d)), max(map(max, d))
        j = np.arange(lo_o + d_lo, 255 + hi_o + d_hi + 1, dtype=np.int64)
        if abs(cy) * max(abs(int(j[0])), abs(int(j[-1]))) + abs(bh) >= _I32:
            return None
        mine = (np.clip((cy * j + bh) >> 16, 0, 255) >> rs) << ls
        if not np.array_equal(mine, arena[np.clip(j + base, 0, hi)]):
            return None
    return (cy, bh, coefs, tuple(s[0] for s in shifts),
            tuple(s[1] for s in shifts), dith2)


def kernel_geometry(key, frames: int, h: int, w: int) -> bytes:
    """csrc/yuv2rgb_packed.cu's struct Packing for `frames` frames of h x w
    in the format of key = (fmt, full_range, dither, brightness, contrast,
    saturation), kernel_tables' arguments: the computed path's parameters
    where `register_map` gives them, else the tables path."""
    fmt, full_range, _, brightness, contrast, saturation = key
    arena, bases = _build_tables(fmt, full_range, brightness, contrast,
                                 saturation)[:2]
    kind = _out_shape(fmt, (), h, w)[2]
    reg = register_map(*key)
    if reg is None:
        computed = (0,) * 25
    else:
        cy, bh, coefs, rshift, lshift, dith2 = reg
        computed = (1, cy, bh, *coefs, *rshift, *lshift,
                    *(cy * v for ch in dith2 for row in ch for v in row))
    return struct.pack("<q8i25ii", frames, h, w, kind,
                       int(_FORMATS[fmt][1]), len(arena), *bases,
                       *computed, 0)


_DEVICE_TABLES: dict = {}


def _device_tables(key, dev: torch.device) -> torch.Tensor:
    """kernel_tables(*key) on dev, copied there once."""
    dev = _build.device_key(dev)
    t = _DEVICE_TABLES.get((key, dev))
    if t is None:
        t = torch.from_numpy(kernel_tables(*key)).to(dev)
        _DEVICE_TABLES[(key, dev)] = t
    return t


def _launch(y, cb, cr, fmt, full_range, dither, brightness, contrast,
            saturation):
    """One launch of kernel Y over every frame."""
    _build.require_cuda(y, cb, cr)
    y, cb, cr = y.contiguous(), cb.contiguous(), cr.contiguous()
    h, w = y.shape[-2], y.shape[-1]
    lead = tuple(y.shape[:-2])
    frames = int(np.prod(lead, dtype=np.int64))
    shape, dtype, _ = _out_shape(fmt, lead, h, w)
    out = torch.empty(shape, dtype=dtype, device=y.device)
    if out.numel() == 0:
        return out
    key = (fmt, full_range, dither, brightness, contrast, saturation)
    tab = _device_tables(key, y.device)
    geo = kernel_geometry(key, frames, h, w)
    with _build.on_device(y, cb, cr) as (lib, stream):
        rc = lib.amv_yuv2rgb_packed(
            y.data_ptr(), cb.data_ptr(), cr.data_ptr(), tab.data_ptr(), geo,
            out.data_ptr(), stream)
    _build.check(rc, "amv_yuv2rgb_packed")
    global LAUNCHES
    LAUNCHES += 1
    return out


# ---------------------------------------------------------------- plain

def _upsample2(c: torch.Tensor) -> torch.Tensor:
    return c.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def yuv420_to_packed_plain(y: torch.Tensor, cb: torch.Tensor,
                           cr: torch.Tensor, fmt: str = "rgb565",
                           full_range: bool = True, dither: bool = True,
                           brightness: int = 0, contrast: int = 65536,
                           saturation: int = 65536):
    """Plain torch version of `yuv420_to_packed` on any device: the JAX
    function's steps (`amv_tpu/kernels/yuv2rgb_dither.py:300-347`)."""
    _check(y, cb, cr, fmt)
    depth, is_rgb = _FORMATS[fmt]
    dev = y.device
    h, w = y.shape[-2], y.shape[-1]
    arena, bases, off_r, off_gu, off_gv, off_b = _build_tables(
        fmt, full_range, brightness, contrast, saturation)
    base_r, base_g, base_b = bases
    arena_t = torch.from_numpy(arena).to(dev)
    hi = arena.shape[0] - 1

    def tab(a):
        return torch.from_numpy(a).to(dev)

    yy = y.to(torch.int32)
    u = _upsample2(cb.to(torch.int64))
    v = _upsample2(cr.to(torch.int64))
    dr, dg, db = (tab(_tile(d, h, w)) for d in _dither_mats(depth, dither))

    def lut(base, off, d):
        idx = torch.clamp(yy + off + base + d, 0, hi)
        return arena_t[idx.long()]

    if depth == 1:
        # g's table only, at U = V = 128 (offsets 0), yuv2rgb.c:584-587
        bit = lut(base_g, 0, dg)
        bits = bit.reshape(*bit.shape[:-1], w // 8, 8)
        weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1],
                               dtype=torch.int32, device=dev)
        return (bits * weights).sum(-1).to(torch.uint8)

    gv = tab(off_gu)[u] + tab(off_gv)[v]
    r = lut(base_r, tab(off_r)[v], dr)
    g = lut(base_g, gv, dg)
    b = lut(base_b, tab(off_b)[u], db)

    if depth == 24:
        first, last = (r, b) if is_rgb else (b, r)
        return torch.stack([first, g, last], dim=-1).to(torch.uint8)
    s = r + g + b
    if depth == 32:
        return s
    if depth in (15, 16):
        return s.to(torch.int16)
    if fmt in ("rgb4", "bgr4"):  # nibble pairs, low = even column
        pairs = s.reshape(*s.shape[:-1], w // 2, 2)
        return (pairs[..., 0] | (pairs[..., 1] << 4)).to(torch.uint8)
    return s.to(torch.uint8)     # rgb8/bgr8 and rgb4_byte/bgr4_byte


# ---------------------------------------------------------------- 4:2:2

def _yuv422(y, cb, cr, order):
    h, w = y.shape[-2], y.shape[-1]
    u = cb.repeat_interleave(2, dim=-2)
    v = cr.repeat_interleave(2, dim=-2)
    parts = {"y0": y[..., 0::2], "u": u, "y1": y[..., 1::2], "v": v}
    out = torch.stack([parts[k] for k in order], dim=-1)
    return out.reshape(*y.shape[:-2], h, 2 * w).to(torch.uint8)


def yuv420_to_yuyv422(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor):
    """uint8 YUV420 planes -> packed YUYV422 bytes [..., H, 2 W] (Y0 U Y1 V
    a pixel pair, swscale.c:705-711; chroma rows replicated), on the
    planes' device."""
    return _yuv422(y, cb, cr, ("y0", "u", "y1", "v"))


def yuv420_to_uyvy422(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor):
    """uint8 YUV420 planes -> packed UYVY422 bytes [..., H, 2 W] (U Y0 V Y1
    a pixel pair), on the planes' device."""
    return _yuv422(y, cb, cr, ("u", "y0", "v", "y1"))
