"""The import guard: the benchmark measures the PyTorch and CUDA port
(`amv_tpu_torch`) and must never load JAX or the JAX package (`amv_tpu`).

Names are compared by their top-level part (before the first dot) as a
whole word: `amv_tpu_torch` begins with `amv_tpu`, so a prefix test would
be wrong.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "amv_tpu")


def forbidden_modules(names=None) -> list[str]:
    """The loaded module names (default: sys.modules) whose top-level name
    is one of FORBIDDEN, sorted."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
