"""Inputs made from the seed: pictures, AMV audio chunks, G.729 frames.

Frozen copies of the recipes of amv_tpu_torch/verify/fixtures.py
(`videogen` and `rotozoom`, after FFmpeg's tests/videogen.c and
tests/rotozoom.c; `g729_frames`) and of chip_smoke.py's `pictures`, so
that the benchmark's inputs never change with the program.  The G.729
frames are drawn on the device with a torch.Generator there, in a few
large calls.
"""

from __future__ import annotations

import struct

import numpy as np
import torch


def videogen(frames: int, height: int, width: int):
    """Moving-gradient YUV 4:2:0 pictures (videogen.c's role)."""
    yy, xx = np.mgrid[0:height, 0:width]
    f = np.arange(frames)[:, None, None]
    y = (128 + 80 * np.sin(xx / 7.0 + f) * np.cos(yy / 9.0)).astype(np.uint8)
    cb = (128 + 50 * np.sin(xx[::2, ::2] / 12.0 - f)).astype(np.uint8)
    cr = (128 + 50 * np.cos(yy[::2, ::2] / 10.0 + f)).astype(np.uint8)
    return y, cb, cr


def rotozoom(frames: int, height: int, width: int):
    """A rotating, zooming checker pattern (rotozoom.c's role), grey."""
    yy, xx = np.mgrid[0:height, 0:width]
    cx, cy = width / 2, height / 2
    f = np.arange(frames)[:, None, None]
    a, z = 0.15 * f, 1.0 + 0.1 * np.sin(f / 2.0)
    u = ((xx - cx) * np.cos(a) - (yy - cy) * np.sin(a)) * z
    v = ((xx - cx) * np.sin(a) + (yy - cy) * np.cos(a)) * z
    y = (128 + 127 * np.sign(np.sin(u / 8.0) * np.sin(v / 8.0))).clip(
        0, 255).astype(np.uint8)
    c = np.full((frames, height // 2, width // 2), 128, np.uint8)
    return y, c, c.copy()


def pictures(n: int, height: int, width: int, seed: int):
    """n pictures: videogen and rotozoom in alternate runs of 16, with
    +-3 of seeded luma noise (chip_smoke.py's corpus)."""
    rng = np.random.default_rng(seed)
    half = n // 2
    vg, rz = videogen(half, height, width), rotozoom(n - half, height, width)
    i = np.arange(n)
    k = i // 32 * 16 + i % 16
    from_vg = (i // 16) % 2 == 0
    y = np.where(from_vg[:, None, None], vg[0][np.minimum(k, half - 1)],
                 rz[0][np.minimum(k, n - half - 1)]).astype(np.int16)
    y = np.clip(y + rng.integers(-3, 4, y.shape), 0, 255).astype(np.uint8)
    cb = np.where(from_vg[:, None, None], vg[1][np.minimum(k, half - 1)],
                  rz[1][np.minimum(k, n - half - 1)])
    cr = np.where(from_vg[:, None, None], vg[2][np.minimum(k, half - 1)],
                  rz[2][np.minimum(k, n - half - 1)])
    return y, cb[:, :height // 2, :width // 2], cr[:, :height // 2, :width // 2]


def adpcm_chunks(n: int, samples: int, seed: int) -> list:
    """n AMV IMA-ADPCM audio chunks of `samples` samples each: the 8-byte
    header (predictor le16, step index le16 in 0..88, sample count le32)
    and seeded nibbles.  The transcode passes audio through untouched."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        head = struct.pack("<hHI", int(rng.integers(-32768, 32768)),
                           int(rng.integers(0, 89)), samples)
        out.append(head + rng.integers(0, 256, (samples + 1) // 2,
                                       dtype=np.uint8).tobytes())
    return out


# G.729 frame fields in the order of their first bit: (first bit, width)
G729_FIELDS = ((0, 1), (1, 7), (8, 5), (13, 5), (18, 8), (26, 1), (27, 13),
               (40, 4), (44, 3), (47, 4), (51, 5), (56, 13), (69, 4),
               (73, 3), (76, 4))
G729_PARITY = 0x6996966996696996     # the pitch parity of P1 >> 2


def g729_frames(t: int, b: int, seed: int, device) -> torch.Tensor:
    """Random packed G.729 frames uint8 [t, b, 10] on `device`, every field
    uniform except the first pitch index P1, in [60, 197), with its parity
    bit valid: a recording as a dictaphone stores it (no erasures)."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    bits = torch.empty((t, b, 80), dtype=torch.uint8, device=dev)
    for at, n in G729_FIELDS:
        if at == 18:
            v = torch.randint(60, 197, (t, b), generator=g, device=dev)
            p1 = v
        elif at == 26:
            v = ((G729_PARITY >> (p1 >> 2)) & 1) ^ 1
        else:
            v = torch.randint(0, 1 << n, (t, b), generator=g, device=dev)
        shifts = torch.arange(n - 1, -1, -1, device=dev)
        bits[..., at:at + n] = ((v[..., None] >> shifts) & 1).to(torch.uint8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=dev)
    return (bits.view(t, b, 10, 8).to(torch.int32) * weights).sum(
        -1).to(torch.uint8)


def g729_defined(frames: np.ndarray, seed: int, device, lengths=None,
                 threads: int = 8) -> np.ndarray:
    """frames uint8 [t, b, 10] with every stream (its first lengths[i]
    frames) one that the reference decoder runs through without an
    undefined step: about one random stream in 1.5 M frames drives the
    Annex A postfilter's gain control to the inverse square root of 0,
    where the ITU code reads before its table.  Such a stream is drawn
    again from a seed of its own until it decodes; in place."""
    from .reference import g729 as ref
    t, b = frames.shape[:2]
    lengths = [t] * b if lengths is None else list(lengths)
    todo = list(range(b))
    for attempt in range(100):
        ok = ref.defined_many([np.ascontiguousarray(frames[:lengths[i], i])
                               for i in todo], threads)
        todo = [i for i, good in zip(todo, ok) if not good]
        if not todo:
            return frames
        for i in todo:
            s = (seed + (i + 1) * 7919 + (attempt + 1) * 104729) % 2**63
            frames[:, i] = g729_frames(t, 1, s, device)[:, 0].cpu().numpy()
    raise RuntimeError(f"streams {todo} keep hitting undefined steps")
