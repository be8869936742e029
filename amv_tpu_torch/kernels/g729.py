"""Kernel G: G.729 Annex A decoding of B streams over T frames in one
launch (csrc/g729_decode.cu).

Not the port of a Pallas kernel: the JAX package decodes with the XLA
program of `amv_tpu/codecs/g729a.py:596 decode_frame_batch` under
`:731 decode_frames_scan` (a lax.scan over frames).  The port's plain
version is `codecs/g729a.py:decode_frame_batch`, torch ops over the
streams and a Python loop over each recurrence's steps, thousands of
launches a frame.  Kernel G gives each stream a warp and keeps its state
in shared memory for all T frames; see the source for the design.

`decode_frames(st, parms)` is `codecs.g729a.decode_frames_scan`'s CUDA
route: the state dict crosses as one int32 [B, STATE_WORDS] buffer in
`codecs.g729a.STATE_FIELDS` order, which the kernel reads before frame 0
and writes after frame T.  `table_header()` is the text of
csrc/g729_tables.cuh, the kernel's copy of `codecs/g729_tables.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codecs import g729_tables as TB
from ..codecs.g729a import GAMMA_POWS_D, GAMMA_POWS_N, STATE_FIELDS
from . import _build

LAUNCHES = 0

STATE_WORDS = sum(int(np.prod(s)) for _, s in STATE_FIELDS)

# name in the header -> the table it holds
_HEADER_TABLES = (
    ("kCbL1", TB.CB_L1), ("kCbL2L3", TB.CB_L2_L3), ("kCbGa", TB.CB_GA),
    ("kCbGb", TB.CB_GB), ("kMaPred", TB.MA_PREDICTOR),
    ("kMaSum", TB.MA_PREDICTOR_SUM), ("kMaSumInv", TB.MA_PREDICTOR_SUM_INV),
    ("kMaCoeff", TB.MA_PREDICTION_COEFF), ("kBaseCos", TB.BASE_COS),
    ("kSlopeCos", TB.SLOPE_COS), ("kTabPow2", TB.TAB_POW2),
    ("kTabLog2", TB.TAB_LOG2), ("kTabInvSqrt", TB.TAB_INV_SQRT),
    ("kInterpFlat", TB.INTERP_FILTER.reshape(-1)),
    ("kGammaPowsN", GAMMA_POWS_N), ("kGammaPowsD", GAMMA_POWS_D))


def table_header() -> str:
    """csrc/g729_tables.cuh: the decoder's tables as __constant__ arrays
    (tests/test_torch_g729.py holds the file to this text)."""
    lines = ["// G.729 Annex A tables for kernel G (csrc/g729_decode.cu): the",
             "// text of amv_tpu_torch/kernels/g729.py:table_header(), from",
             "// amv_tpu_torch/codecs/g729_tables.py.", "#pragma once", "",
             "#include <stdint.h>", ""]
    for name, tab in _HEADER_TABLES:
        a = np.asarray(tab, np.int64)
        dims = "".join(f"[{d}]" for d in a.shape)
        vals = [str(int(v)) for v in a.reshape(-1)]
        body, row = [], "   "
        for v in vals:
            if len(row) + len(v) + 2 > 78:
                body.append(row)
                row = "   "
            row += f" {v},"
        body.append(row)
        lines += [f"__constant__ int32_t {name}{dims} = {{", *body, "};"]
    return "\n".join(lines) + "\n"


def flatten_state(st: dict) -> torch.Tensor:
    """The state dict -> int32 [B, STATE_WORDS], contiguous."""
    b = st["exc"].shape[0]
    return torch.cat([st[k].to(torch.int32).reshape(b, -1)
                      for k, _ in STATE_FIELDS], 1).contiguous()


def unflatten_state(flat: torch.Tensor) -> dict:
    """int32 [B, STATE_WORDS] -> the state dict (views of flat)."""
    b, out, at = flat.shape[0], {}, 0
    for k, shape in STATE_FIELDS:
        n = int(np.prod(shape))
        out[k] = flat[:, at:at + n].reshape((b,) + shape)
        at += n
    return out


def decode_frames(st: dict, parms: torch.Tensor):
    """Kernel G: st (the state dict of `codecs.g729a.init_state`), parms
    int32 [T, B, 16] -> (the state after frame T, pcm int16 [T, B, 80]),
    all on one CUDA device; one launch decodes all T frames."""
    if parms.dim() != 3 or parms.shape[2] != 16:
        raise ValueError(f"parms must be [T, B, 16], got "
                         f"{tuple(parms.shape)}")
    t, b = parms.shape[:2]
    for k, shape in STATE_FIELDS:
        if tuple(st[k].shape) != (b,) + shape:
            raise ValueError(f"state {k} must be {(b,) + shape}, got "
                             f"{tuple(st[k].shape)}")
    _build.require_cuda(parms, *st.values())
    lib = _build.library()
    if lib.amv_g729_state_words() != STATE_WORDS:
        raise RuntimeError("csrc/g729_decode.cu's state layout differs from "
                           "codecs/g729a.py:STATE_FIELDS")
    p = parms.to(torch.int32).contiguous()
    flat = flatten_state(st)
    pcm = torch.empty((t, b, 80), dtype=torch.int16, device=p.device)
    if t == 0 or b == 0:
        return unflatten_state(flat), pcm
    with torch.cuda.device(p.device):
        rc = lib.amv_g729_decode(p.data_ptr(), t, b, flat.data_ptr(),
                                 pcm.data_ptr(), _build.stream())
    _build.check(rc, "amv_g729_decode")
    global LAUNCHES
    LAUNCHES += 1
    return unflatten_state(flat), pcm
