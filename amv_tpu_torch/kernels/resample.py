"""Audio sample-rate conversion as torch ops on any device (`-ar`, the role
of ffmpeg's resample2.c): the port of `amv_tpu/kernels/resample.py`.

A polyphase Kaiser-windowed sinc of 16 taps and 1,024 phases in 14-bit
fixed point.  The filter bank (`_filter_bank`, numpy float64) and every
output sample's exact rational position (numpy int64) are computed on the
host, as in the JAX package; the 16 gathers and int32 multiply-adds run
on the device.  Edge samples are replicated.
"""

from __future__ import annotations

import numpy as np
import torch

from ..pipeline import resolve_device, upload

TAPS = 16
PHASES = 1024
_SHIFT = 14
_KAISER_BETA = 9.0


def _filter_bank(cutoff: float) -> np.ndarray:
    """[PHASES, TAPS] int32 coefficients, each row summing to 2^14."""
    center = TAPS // 2 - 1
    ph = np.arange(PHASES)[:, None] / PHASES
    t = np.arange(TAPS)[None, :]
    x = (t - center - ph) * cutoff
    h = np.sinc(x) * cutoff
    # Kaiser window over the tap span
    u = (t - center - ph) / (TAPS / 2)
    u = np.clip(u, -1.0, 1.0)
    h *= np.i0(_KAISER_BETA * np.sqrt(1 - u * u)) / np.i0(_KAISER_BETA)
    hq = np.floor(h * (1 << _SHIFT) + 0.5).astype(np.int64)
    resid = (1 << _SHIFT) - hq.sum(axis=1)
    hq[np.arange(PHASES), np.abs(h).argmax(axis=1)] += resid
    return hq.astype(np.int32)


def _apply(x: torch.Tensor, i0: torch.Tensor, phase: torch.Tensor,
           bank: torch.Tensor) -> torch.Tensor:
    """int16 [m]: per output sample, bank row `phase` dotted with x's 16
    samples from i0 (clamped into x), rounded from 14 bits and clipped."""
    x = x.to(torch.int32)
    acc = torch.zeros(i0.shape, dtype=torch.int32, device=x.device)
    for t in range(TAPS):
        acc += bank[:, t][phase] * x[(i0 + t).clamp_(0, x.shape[0] - 1)]
    return ((acc + (1 << (_SHIFT - 1))) >> _SHIFT).clamp_(
        -32768, 32767).to(torch.int16)


def resample_pcm(pcm, in_rate: int, out_rate: int, *,
                 device) -> torch.Tensor:
    """int16 [n] PCM (a numpy array or a tensor) at in_rate -> int16 [m]
    tensor at out_rate on `device`, m = n * out_rate // in_rate; equal to
    `amv_tpu.kernels.resample.resample_pcm`."""
    dev = resolve_device(device)
    x = upload(pcm, dev).to(torch.int16)
    n = x.shape[0]
    if in_rate == out_rate or n == 0:
        return x
    m = int(n * out_rate // in_rate)
    bank = _filter_bank(min(1.0, out_rate / in_rate) * 0.97)
    # exact rational positions on the host (int64)
    pos_num = np.arange(m, dtype=np.int64) * in_rate
    ipos = pos_num // out_rate
    phase = (pos_num - ipos * out_rate) * PHASES // out_rate
    i0 = ipos - (TAPS // 2 - 1)
    return _apply(x, *(upload(a.astype(np.int32), dev)
                       for a in (i0, phase, bank)))
