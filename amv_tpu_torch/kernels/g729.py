"""Kernels G and K: G.729 Annex A decoding (csrc/g729_decode.cu) and
encoding (csrc/g729_encode.cu) of B streams over T frames, each in one
launch.

Neither ports a Pallas kernel: the JAX package decodes with the XLA
program of `amv_tpu/codecs/g729a.py:596 decode_frame_batch` under
`:731 decode_frames_scan`, and encodes with `amv_tpu/codecs/
g729a_encoder_tpu.py:437 encode_frame_batch` under `:588
encode_frames_scan` (lax.scans over frames).  The port's plain versions
are `codecs/g729a.py:decode_frame_batch` and `codecs/
g729a_encoder_batch.py:encode_frame_batch`, torch ops over the streams
and Python loops over each recurrence's steps.  Kernel G gives each
stream a CTA of four warps, one a decoder stage, pipelined over frames;
kernel K gives each stream a CTA of two warps (four while the card holds
every stream at that size), which split the encoder's searches while warp
0 runs its chains; both keep the state in shared memory for all T frames
and pick their build from the number of streams inside the C entry.  See
the sources for the designs.

`decode_frames(st, parms)` and `encode_frames(st, hist, frames)` are the
CUDA routes of `codecs.g729a.decode_frames_scan` and
`codecs.g729a_encoder_batch.encode_frames_scan`: the state dict crosses
as one int32 [B, STATE_WORDS] buffer in `codecs.g729a.STATE_FIELDS`
order, which the kernel reads before frame 0 and writes after frame T.
`table_header()` is the text of csrc/g729_tables.cuh, the kernels' copy
of `codecs/g729_tables.py`; `encode_table_header()` that of
csrc/g729_encode_tables.cuh, K's float constants (exact, as hex
literals) from `codecs/g729a_encoder_batch.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codecs import g729_tables as TB
from ..codecs.g729a import GAMMA_POWS_D, GAMMA_POWS_N, STATE_FIELDS
from . import _build

LAUNCHES = 0            # kernel G
ENCODE_LAUNCHES = 0     # kernel K

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
    lines = ["// G.729 Annex A tables for kernels G and K (csrc/g729_*.cu):",
             "// the text of amv_tpu_torch/kernels/g729.py:table_header(), "
             "from",
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
        lines += [f"static __constant__ int32_t {name}{dims} = {{", *body,
                  "};"]
    return "\n".join(lines) + "\n"


def _hex(v) -> str:
    return float(np.float32(v)).hex() + "f"


def encode_table_header() -> str:
    """csrc/g729_encode_tables.cuh: kernel K's float32 constants, each
    written exactly (tests/test_torch_g729_encoder.py holds the file to
    this text)."""
    from ..codecs import g729a_encoder_batch as E
    lines = ["// Kernel K's float constants (csrc/g729_encode.cu): the text "
             "of", "// amv_tpu_torch/kernels/g729.py:encode_table_header(), "
             "from", "// amv_tpu_torch/codecs/g729a_encoder_batch.py.",
             "#pragma once", ""]
    for name, vals in (("kWlp", E.WLP), ("kLagWindow", E.LAG_WINDOW),
                       ("kSinCoef", E.SIN_COEF),
                       ("kUniformLsf", E.UNIFORM_LSF)):
        body, row = [], "   "
        for v in (_hex(x) for x in vals):
            if len(row) + len(v) + 2 > 78:
                body.append(row)
                row = "   "
            row += f" {v},"
        body.append(row)
        lines += [f"static __constant__ float {name}[{len(vals)}] = {{", *body,
                  "};"]
    for name, v in (("kHalfPi", E.HALF_PI), ("kPi511", E.PI_511)):
        lines.append(f"constexpr float {name} = {_hex(v)};")
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
    p = parms.to(torch.int32).contiguous()
    flat = flatten_state(st)
    pcm = torch.empty((t, b, 80), dtype=torch.int16, device=p.device)
    if t == 0 or b == 0:
        return unflatten_state(flat), pcm
    with _build.on_device(p, flat, pcm) as (lib, stream):
        if lib.amv_g729_state_words() != STATE_WORDS:
            raise RuntimeError("csrc/g729_decode.cu's state layout differs "
                               "from codecs/g729a.py:STATE_FIELDS")
        rc = lib.amv_g729_decode(p.data_ptr(), t, b, flat.data_ptr(),
                                 pcm.data_ptr(), stream)
    _build.check(rc, "amv_g729_decode")
    global LAUNCHES
    LAUNCHES += 1
    return unflatten_state(flat), pcm


def encode_frames(st: dict, hist: torch.Tensor, frames: torch.Tensor):
    """Kernel K: st (the shadow state dict of `codecs.g729a.init_state`),
    hist float32 [B, 160] (the past input, scaled), frames [T, B, 80] (the
    int16 samples as float32) -> (the state after frame T, its hist,
    parms int32 [T, B, 16]), all on one CUDA device; one launch encodes
    all T frames."""
    if frames.dim() != 3 or frames.shape[2] != 80:
        raise ValueError(f"frames must be [T, B, 80], got "
                         f"{tuple(frames.shape)}")
    t, b = frames.shape[:2]
    if tuple(hist.shape) != (b, 160):
        raise ValueError(f"hist must be {(b, 160)}, got {tuple(hist.shape)}")
    for k, shape in STATE_FIELDS:
        if tuple(st[k].shape) != (b,) + shape:
            raise ValueError(f"state {k} must be {(b,) + shape}, got "
                             f"{tuple(st[k].shape)}")
    _build.require_cuda(frames, hist, *st.values())
    x = frames.to(torch.float32).contiguous()
    flat = flatten_state(st)
    h = hist.to(torch.float32).contiguous().clone()
    parms = torch.empty((t, b, 16), dtype=torch.int32, device=x.device)
    if t == 0 or b == 0:
        return unflatten_state(flat), h, parms
    with _build.on_device(x, flat, h, parms) as (lib, stream):
        if lib.amv_g729_state_words() != STATE_WORDS:
            raise RuntimeError("csrc/g729_common.cuh's state layout differs "
                               "from codecs/g729a.py:STATE_FIELDS")
        rc = lib.amv_g729_encode(x.data_ptr(), t, b, flat.data_ptr(),
                                 h.data_ptr(), parms.data_ptr(), stream)
    _build.check(rc, "amv_g729_encode")
    global ENCODE_LAUNCHES
    ENCODE_LAUNCHES += 1
    return unflatten_state(flat), h, parms
