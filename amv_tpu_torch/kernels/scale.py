"""Image rescaling as torch ops on any device (libswscale's scaling role,
`-s WxH`): the port of `amv_tpu/kernels/scale.py`.

Separable polyphase filtering: per output sample a row of tap indices and
2^14-scaled integer weights, built on the host in numpy float64 from the
same `np.sinc` / `np.i0` / `np.exp2` / `np.cos` calls as the JAX package
(`_build_taps`, so the weights are the same integers), then one gather and
one int32 multiply-accumulate per tap on the device.  The horizontal pass
is rounded back to 14 bits without clipping, then the vertical pass
(swscale's hScale -> vScale order), then the clip to uint8.  Sums stay
int32, as in JAX.

Filters (swscale.c:1065-1161 initFilter): bilinear, bicubic (a = -0.6),
point, area, lanczos (3 lobes), gauss (p = 3), sinc, spline and
experimental; 'bicublin' (bicubic luma, bilinear chroma,
swscale.c:2295-2341) is handled by `resize_yuv420`.  Centre convention
src = (dst + 0.5) * L / Ld - 0.5 with replicated edges.
"""

from __future__ import annotations

import numpy as np
import torch

_SHIFT = 14             # swscale's 14-bit coefficient fixed point
BATCH_PLANES = 1024     # planes resized at a time (bounds the int32 temps)


def _cubic(x: np.ndarray, a: float = -0.6) -> np.ndarray:
    ax = np.abs(x)
    return np.where(
        ax <= 1, (a + 2) * ax**3 - (a + 3) * ax**2 + 1,
        np.where(ax < 2, a * (ax**3 - 5 * ax**2 + 8 * ax - 4), 0.0))


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _box(x: np.ndarray) -> np.ndarray:
    return (np.abs(x) <= 0.5).astype(np.float64)


def _lanczos(x: np.ndarray, a: float = 3.0) -> np.ndarray:
    ax = np.abs(x)
    out = np.sinc(x) * np.sinc(x / a)
    return np.where(ax < a, out, 0.0)


def _gauss(x: np.ndarray, p: float = 3.0) -> np.ndarray:
    return np.exp2(-p * x * x)


def _sinc(x: np.ndarray) -> np.ndarray:
    return np.sinc(x)


def _spline(x: np.ndarray) -> np.ndarray:
    """Natural bicubic spline: getSplineCoeff(1, 0, p, -p-1, d) with
    p = -2.196152422706632 (swscale.c:971-980,1153-1157), the tail
    recursion unrolled over the 10-pixel support."""
    p = -2.196152422706632
    d = np.abs(x).astype(np.float64)
    a = np.ones_like(d)
    b = np.zeros_like(d)
    c = np.full_like(d, p)
    e = np.full_like(d, -p - 1.0)
    for _ in range(10):
        go = d > 1.0
        a, b, c, e = (np.where(go, 0.0, a),
                      np.where(go, b + 2 * c + 3 * e, b),
                      np.where(go, c + 3 * e, c),
                      np.where(go, -b - 3 * c - 6 * e, e))
        d = np.where(go, d - 1.0, d)
    return ((e * d + c) * d + b) * d + a


def _xexp(x: np.ndarray) -> np.ndarray:
    """SWS_X 'experimental': cos window with signed pow A (default 1),
    mapped to [0, 1] (swscale.c:1114-1125) -- zero beyond d = 1."""
    d = np.abs(x)
    c = np.where(d < 1.0, np.cos(d * np.pi), -1.0)
    return c * 0.5 + 0.5


_KERNELS = {                 # filter -> (base radius, function)
    "bilinear": (1.0, _triangle), "bicubic": (2.0, _cubic),
    "area": (0.5, _box), "lanczos": (3.0, _lanczos),
    "gauss": (4.0, _gauss),           # sizeFactor 8, swscale.c:1068
    "sinc": (10.0, _sinc),            # sizeFactor 20, swscale.c:1070
    "spline": (10.0, _spline),        # sizeFactor 20, swscale.c:1071
    "experimental": (4.0, _xexp)}     # sizeFactor 8, swscale.c:1066


def _build_taps(src_l: int, dst_l: int, filt: str):
    """Per-output-sample tap indices and 2^14-scaled int weights: (idx
    int32 [dst_l, T], w int32 [dst_l, T]), each row of w summing to 2^14.
    A downscale stretches the kernel by the scale factor (anti-alias), as
    swscale's filter construction does."""
    scale = src_l / dst_l
    stretch = max(1.0, scale)
    if filt == "point":
        # nearest neighbour: one tap, no anti-alias stretch (SWS_POINT)
        pos = (np.arange(dst_l) + 0.5) * scale - 0.5
        idx = np.clip(np.floor(pos + 0.5).astype(np.int64),
                      0, src_l - 1)[:, None]
        w = np.full((dst_l, 1), 1 << _SHIFT, np.int64)
        return idx.astype(np.int32), w.astype(np.int32)
    if filt not in _KERNELS:
        raise ValueError(f"unknown filter {filt!r}")
    base_r, fn = _KERNELS[filt]
    radius = base_r * stretch
    ntaps = max(2, int(np.ceil(2 * radius)))
    pos = (np.arange(dst_l) + 0.5) * scale - 0.5
    # the ntaps integers placed symmetrically around pos
    i0 = np.ceil(pos - ntaps / 2).astype(np.int64)
    t = np.arange(ntaps)
    idx = i0[:, None] + t[None, :]
    x = (idx - pos[:, None]) / stretch
    w = fn(x)
    s = w.sum(axis=1, keepdims=True)
    s[s == 0] = 1.0
    wq = np.floor(w / s * (1 << _SHIFT) + 0.5).astype(np.int64)
    # force the exact sum 2^14 (the residue onto the largest tap) so flat
    # areas stay flat
    resid = (1 << _SHIFT) - wq.sum(axis=1)
    wq[np.arange(dst_l), np.abs(w).argmax(axis=1)] += resid
    idx = np.clip(idx, 0, src_l - 1)
    return idx.astype(np.int32), wq.astype(np.int32)


def _taps(src_l: int, dst_l: int, filt: str, dev):
    """_build_taps' (idx, w) as int32 tensors [T, dst_l] on dev."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a.T)).to(dev)
                 for a in _build_taps(src_l, dst_l, filt))


def _resize_axis(x: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """int32 sums of x's taps along `axis` (x uint8 or int32; the sums
    unrounded, at 2^14 scale)."""
    idx, w = taps
    wshape = [1] * x.dim()
    wshape[axis] = idx.shape[1]
    acc = None
    for t in range(idx.shape[0]):
        col = x.index_select(axis, idx[t]).to(torch.int32)
        col.mul_(w[t].view(wshape))
        acc = col if acc is None else acc.add_(col)
    return acc


def resize_plane(x: torch.Tensor, dst_h: int, dst_w: int,
                 filt: str = "bicubic") -> torch.Tensor:
    """uint8 [..., H, W] -> uint8 [..., dst_h, dst_w] on x's device, the
    leading dimensions BATCH_PLANES planes at a time."""
    lead, (sh, sw) = x.shape[:-2], x.shape[-2:]
    h_taps = _taps(sw, dst_w, filt, x.device)
    v_taps = _taps(sh, dst_h, filt, x.device)
    flat = x.reshape(-1, sh, sw)
    out = torch.empty((flat.shape[0], dst_h, dst_w), dtype=torch.uint8,
                      device=x.device)
    for a in range(0, flat.shape[0], BATCH_PLANES):
        h = _resize_axis(flat[a:a + BATCH_PLANES], h_taps, 2)
        h = (h + (1 << (_SHIFT - 1))) >> _SHIFT
        v = _resize_axis(h, v_taps, 1)
        v = (v + (1 << (_SHIFT - 1))) >> _SHIFT
        out[a:a + BATCH_PLANES] = v.clamp(0, 255)
    return out.reshape(*lead, dst_h, dst_w)


def resize_yuv420(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                  dst_h: int, dst_w: int, filt: str = "bicubic"):
    """Resize YUV420 planes to dst (luma dst_h x dst_w, chroma half of
    each).  'bicublin' = bicubic luma + bilinear chroma (SWS_BICUBLIN)."""
    if dst_h % 2 or dst_w % 2:
        raise ValueError("YUV420 target dims must be even")
    yf, cf = ("bicubic", "bilinear") if filt == "bicublin" else (filt, filt)
    return (resize_plane(y, dst_h, dst_w, yf),
            resize_plane(cb, dst_h // 2, dst_w // 2, cf),
            resize_plane(cr, dst_h // 2, dst_w // 2, cf))
