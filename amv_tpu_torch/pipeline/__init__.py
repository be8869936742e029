"""The port's end-to-end entry points: decode, encode and transcode of
complete .amv files, each on an explicit torch device."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device for a user's `device` argument; a CUDA device without a
    usable card raises instead of running elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available to torch")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
