"""Synthetic fixture generators (tests/videogen.c, rotozoom.c, audiogen.c
parity): the port's copy of `amv_tpu/verify/fixtures.py`'s video and audio
generators, for the corpus of `chip_smoke.py` and the GPU tests.
"""

from __future__ import annotations

import numpy as np


def videogen(frames: int = 5, height: int = 120, width: int = 160,
             seed: int = 0):
    """Moving-gradient YUV420 clip (videogen.c role)."""
    yy, xx = np.mgrid[0:height, 0:width]
    y = np.stack([
        (128 + 80 * np.sin(xx / 7.0 + f) * np.cos(yy / 9.0)).astype(np.uint8)
        for f in range(frames)])
    cb = np.stack([
        (128 + 50 * np.sin(xx[::2, ::2] / 12.0 - f)).astype(np.uint8)
        for f in range(frames)])
    cr = np.stack([
        (128 + 50 * np.cos(yy[::2, ::2] / 10.0 + f)).astype(np.uint8)
        for f in range(frames)])
    return y, cb, cr


def rotozoom(frames: int = 5, height: int = 120, width: int = 160):
    """Rotating/zooming checker pattern (rotozoom.c role)."""
    yy, xx = np.mgrid[0:height, 0:width]
    cx, cy = width / 2, height / 2
    ys = []
    for f in range(frames):
        a = 0.15 * f
        z = 1.0 + 0.1 * np.sin(f / 2.0)
        u = ((xx - cx) * np.cos(a) - (yy - cy) * np.sin(a)) * z
        v = ((xx - cx) * np.sin(a) + (yy - cy) * np.cos(a)) * z
        ys.append((128 + 127 * np.sign(np.sin(u / 8.0) * np.sin(v / 8.0)))
                  .clip(0, 255).astype(np.uint8))
    y = np.stack(ys)
    cb = np.full((frames, height // 2, width // 2), 128, np.uint8)
    cr = np.full((frames, height // 2, width // 2), 128, np.uint8)
    return y, cb, cr


def audiogen(seconds: float = 1.0, sample_rate: int = 22050,
             fundamental: float = 440.0, seed: int = 0):
    """Harmonic tone + noise (audiogen.c role), int16."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sample_rate))
    sig = (6000 * np.sin(2 * np.pi * fundamental * t / sample_rate)
           + 2000 * np.sin(2 * np.pi * 2.3 * fundamental * t / sample_rate)
           + 500 * rng.standard_normal(len(t)))
    return np.clip(sig, -32768, 32767).astype(np.int16)

