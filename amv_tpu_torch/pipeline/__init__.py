"""The port's end-to-end entry points: decode, encode and transcode of
complete .amv files, each on an explicit torch device."""

from __future__ import annotations

import numpy as np
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


def upload(a, dev: torch.device) -> torch.Tensor:
    """A host array (or a tensor) as a tensor on dev.  A host array bound
    for a CUDA device is staged in a pinned buffer and copied without
    blocking (the caching host allocator keeps the buffer until the copy
    has run); on the CPU it is copied only if numpy holds it read-only."""
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    a = np.asarray(a)
    if dev.type != "cuda":
        return torch.from_numpy(a if a.flags.writeable else a.copy())
    buf = torch.empty(a.shape, pin_memory=True,
                      dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype)
    buf.numpy()[...] = a
    return buf.to(dev, non_blocking=True)
