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



def speechgen(n: int = 8000, sample_rate: int = 8000, seed: int = 7):
    """Speech-like AR signal with voiced/unvoiced alternation (for G.729):
    `amv_tpu/verify/fixtures.py:speechgen`, int16 [n]."""
    rng = np.random.default_rng(seed)
    exc = rng.standard_normal(n) * 300
    pt = np.zeros(n)
    pt[::75] = 4000
    voiced = (np.sin(2 * np.pi * np.arange(n) / 3000) > 0)
    exc = np.where(voiced, exc * 0.3 + pt, exc)
    sig = exc.copy()
    for i in range(2, n):
        sig[i] = exc[i] + 1.5 * sig[i - 1] - 0.7 * sig[i - 2]
    return np.clip(sig * 0.5, -20000, 20000).astype(np.int16)


def speech_streams(b: int, n: int, seed: int = 0):
    """b speechgen-like streams of n samples, int16 [b, n]: each its own
    noise, pitch period (60-110 samples) and voicing phase; the AR filter
    runs over the streams at once, one sample a step."""
    rng = np.random.default_rng(seed)
    exc = rng.standard_normal((b, n)) * 300
    period = rng.integers(60, 111, b)[:, None]
    phase = rng.integers(0, 3000, b)[:, None]
    t = np.arange(n)[None, :]
    pulse = np.where(t % period == 0, 4000.0, 0.0)
    voiced = np.sin(2 * np.pi * (t + phase) / 3000) > 0
    exc = np.where(voiced, exc * 0.3 + pulse, exc)
    sig = exc.copy()
    for i in range(2, n):
        sig[:, i] = exc[:, i] + 1.5 * sig[:, i - 1] - 0.7 * sig[:, i - 2]
    return np.clip(sig * 0.5, -20000, 20000).astype(np.int16)


# G.729 frame fields in order of their first bit: (first bit, width)
_G729_FIELDS = ((0, 1), (1, 7), (8, 5), (13, 5), (18, 8), (26, 1), (27, 13),
                (40, 4), (44, 3), (47, 4), (51, 5), (56, 13), (69, 4),
                (73, 3), (76, 4))
# the pitch parity (3.7.2): bit P1 >> 2 of this word
_G729_PARITY = 0x6996966996696996


def g729_frames(rng, t: int, b: int, erasure: float = 0.0,
                bad_parity: float = 0.0, high_pitch: float = 0.0,
                low_pitch: float = 0.0) -> np.ndarray:
    """Random packed G.729 frames uint8 [t, b, 10] with valid pitch parity
    (tests/test_g729.py:make_frame's fields, vectorised): the first pitch
    index P1 in [60, 197), or with the given shares in [197, 256) (high)
    or [0, 20) (low: the least lags); the given shares of frames have
    their parity bit flipped, or are erasures (all ten bytes zero)."""
    shape = (t, b)
    vals = [rng.integers(0, 1 << n, shape, dtype=np.uint64)
            for _, n in _G729_FIELDS]
    u = rng.random(shape)
    p1 = rng.integers(60, 197, shape)
    p1 = np.where(u < high_pitch, rng.integers(197, 256, shape), p1)
    p1 = np.where((u >= high_pitch) & (u < high_pitch + low_pitch),
                  rng.integers(0, 20, shape), p1)
    p0 = ((_G729_PARITY >> (p1 >> 2)) & 1) ^ 1
    p0 ^= (rng.random(shape) < bad_parity).astype(p0.dtype)
    vals[4], vals[5] = p1.astype(np.uint64), p0.astype(np.uint64)
    hi = np.zeros(shape, np.uint64)      # bits 0..63, bit 0 the MSB
    lo = np.zeros(shape, np.uint64)      # bits 64..79 in the top 16
    for (at, n), v in zip(_G729_FIELDS, vals):
        end = at + n
        if end <= 64:
            hi |= v << np.uint64(64 - end)
        elif at >= 64:
            lo |= v << np.uint64(128 - end)
        else:
            hi |= v >> np.uint64(end - 64)
            lo |= (v & np.uint64((1 << (end - 64)) - 1)) << np.uint64(
                128 - end)
    out = np.concatenate([hi.astype(">u8")[..., None].view(np.uint8),
                          lo.astype(">u8")[..., None].view(np.uint8)[..., :2]],
                         axis=-1)
    out[rng.random(shape) < erasure] = 0
    return out


def g729_set_field(frames: np.ndarray, at: int, n: int, value: int) -> None:
    """Set the n-bit field at bit `at` of packed G.729 frames (uint8
    [..., 10], bit j at byte j >> 3 from the MSB) to value, in place."""
    for i in range(n):
        j = at + i
        m = np.uint8(1 << (7 - (j & 7)))
        frames[..., j >> 3] &= ~m
        if (value >> (n - 1 - i)) & 1:
            frames[..., j >> 3] |= m


def g729_loud(frames: np.ndarray) -> None:
    """Every frame's gain codes set to the largest pitch gain (GA 0, GB 5:
    1.36 in Q14), in place: the excitation grows until LP synthesis
    overflows, and the decoder takes its rescale-and-redo path."""
    for at, n, v in ((44, 3, 0), (47, 4, 5), (73, 3, 0), (76, 4, 5)):
        g729_set_field(frames, at, n, v)
