"""Scalar oracle for the packed/dithered yuv2rgb family: the port's copy
of `amv_tpu/verify/ref_yuv2rgb.py`, over the port's tables.

Transliterates the reference C pixel loops (pointer walk emulated over
the same flat table arena the kernel gathers from):

* unscaled converters yuv2rgb.c:304-615 (32/24 bpp, undithered 16/15,
  ordered-dithered 8/4/4-byte/1 bpp) — two rows per iteration, chroma
  shared 2x2, per-row dither table rows exactly as the C indexes them
  (row y uses dither[y&7], row y+1 reads 8 entries past = dither row
  (y&7)+1);
* the scaled path's 2x2-dithered 16/15 bpp case (swscale.c:578-607).

The equality reference of kernels/yuv2rgb_dither.yuv420_to_packed (kernel
Y and its plain version) in tests/test_torch_yuv2rgb.py and, on a few
frames, chip_smoke.py.  Index clamping at the arena bounds follows the
kernel's documented convention (the C is undefined there; see
kernels/yuv2rgb_dither.py).
"""

from __future__ import annotations

import numpy as np

from ..kernels.yuv2rgb_dither import (
    _FORMATS, _build_tables, DITHER_2X2_4, DITHER_2X2_8,
    DITHER_8X8_32, DITHER_8X8_73, DITHER_8X8_220)


class _Ptr:
    """Emulates the C's `type *p = table + offset; p[i]` with the
    kernel's clamp-at-arena-bounds convention."""

    def __init__(self, arena: np.ndarray, off: int):
        self.arena = arena
        self.off = off

    def __getitem__(self, i: int) -> int:
        idx = min(max(self.off + int(i), 0), len(self.arena) - 1)
        return int(self.arena[idx])


def ref_yuv420_to_packed(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                         fmt: str, full_range: bool = True,
                         dither: bool = True) -> np.ndarray:
    depth, is_rgb = _FORMATS[fmt]
    h, w = y.shape
    assert h % 2 == 0 and w % 2 == 0
    arena, (base_r, base_g, base_b), off_r, off_gu, off_gv, off_b = \
        _build_tables(fmt, full_range)

    def tables(u_val: int, v_val: int):
        r = _Ptr(arena, base_r + int(off_r[v_val]))
        g = _Ptr(arena, base_g + int(off_gu[u_val]) + int(off_gv[v_val]))
        b = _Ptr(arena, base_b + int(off_b[u_val]))
        return r, g, b

    yi = y.astype(np.int64)
    ui = cb.astype(np.int64)
    vi = cr.astype(np.int64)

    if depth in (15, 16) and dither:
        # swscale.c:578-607 (scaled path): per output row y, column x
        out = np.zeros((h, w), np.uint16)
        d8, d4 = DITHER_2X2_8, DITHER_2X2_4
        for yy in range(h):
            for x in range(w):
                u_val, v_val = ui[yy >> 1, x >> 1], vi[yy >> 1, x >> 1]
                r, g, b = tables(u_val, v_val)
                dr = d8[yy & 1][x & 1]
                db = d8[(yy & 1) ^ 1][x & 1]
                if depth == 16:
                    dg = d4[yy & 1][x & 1]
                else:
                    dg = d8[yy & 1][(x & 1) ^ 1]
                py = int(yi[yy, x])
                out[yy, x] = r[py + dr] + g[py + dg] + b[py + db]
        return out

    # unscaled converters: two-row loop (yuv2rgb.c:259-298 PROLOG)
    if depth == 32:
        out = np.zeros((h, w), np.uint32)
    elif depth == 24:
        out = np.zeros((h, w, 3), np.uint8)
    elif depth in (15, 16):
        out = np.zeros((h, w), np.uint16)
    elif fmt in ("rgb4", "bgr4"):
        out = np.zeros((h, w // 2), np.uint8)
    elif depth == 1:
        assert w % 8 == 0
        out = np.zeros((h, w // 8), np.uint8)
    else:
        out = np.zeros((h, w), np.uint8)

    for y0 in range(0, h, 2):
        if depth == 8:
            d32 = DITHER_8X8_32[y0 & 7]
            d64 = DITHER_8X8_73[y0 & 7]
            d32n = DITHER_8X8_32[(y0 & 7) + 1]   # C reads d32[8+o]
            d64n = DITHER_8X8_73[(y0 & 7) + 1]
        elif depth == 4:
            d64 = DITHER_8X8_73[y0 & 7]
            d128 = DITHER_8X8_220[y0 & 7]
            d64n = DITHER_8X8_73[(y0 & 7) + 1]
            d128n = DITHER_8X8_220[(y0 & 7) + 1]
        elif depth == 1:
            d128 = DITHER_8X8_220[y0 & 7]
            d128n = DITHER_8X8_220[(y0 & 7) + 1]

        for row, y1 in ((0, y0), (1, y0 + 1)):
            if depth == 1:
                g = _Ptr(arena, base_g)
                acc, nbit = 0, 0
                dd = d128 if row == 0 else d128n
                for x in range(w):
                    py = int(yi[y1, x])
                    acc = ((acc << 1) | g[py + dd[x & 7]]) & 0xFF
                    nbit += 1
                    if nbit == 8:
                        out[y1, x >> 3] = acc
                        acc, nbit = 0, 0
                continue
            for x in range(w):
                u_val = ui[y0 >> 1, x >> 1]
                v_val = vi[y0 >> 1, x >> 1]
                r, g, b = tables(u_val, v_val)
                py = int(yi[y1, x])
                if depth == 32:
                    out[y1, x] = (r[py] + g[py] + b[py]) & 0xFFFFFFFF
                elif depth == 24:
                    if is_rgb:
                        out[y1, x] = (r[py], g[py], b[py])
                    else:
                        out[y1, x] = (b[py], g[py], r[py])
                elif depth in (15, 16):
                    out[y1, x] = r[py] + g[py] + b[py]
                elif depth == 8:
                    drg = (d32 if row == 0 else d32n)[x & 7]
                    db_ = (d64 if row == 0 else d64n)[x & 7]
                    out[y1, x] = (r[py + drg] + g[py + drg]
                                  + b[py + db_]) & 0xFF
                elif depth == 4:
                    drb = (d128 if row == 0 else d128n)[x & 7]
                    dg_ = (d64 if row == 0 else d64n)[x & 7]
                    val = (r[py + drb] + g[py + dg_] + b[py + drb]) & 0xF
                    if fmt in ("rgb4", "bgr4"):
                        if x & 1:
                            out[y1, x >> 1] |= val << 4
                        else:
                            out[y1, x >> 1] = val
                    else:
                        out[y1, x] = val
    return out
