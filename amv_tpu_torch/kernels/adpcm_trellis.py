"""Kernel L: the Viterbi IMA-ADPCM (AMV) quantizer of `-trellis`.

Not a Pallas kernel in the JAX package, which runs this quantizer on the
host (`amv_tpu/codecs/adpcm_trellis.py:trellis_encode_fast`); backed by
csrc/adpcm_trellis.cu, a warp per chunk (three states a lane, records
handed on by warp shuffles, 4-bit back-pointers).  Plain version: `codecs.
adpcm_trellis.trellis_lanes`, the same Viterbi in torch, vectorised over
chunks.

* `trellis_chunks`: one launch over chunks of a padded stream, each from
  its given start state and predictor -> the packed bytes (high nibble
  first) and each chunk's final state;
* `encode_chain`: the encoder's chain (the predictor restarts at each
  chunk's first sample, but chunk k + 1 starts from chunk k's final step
  index), resolved by speculation: every chunk runs from a guessed start
  in round 1 (chunk 0's is exact); each later round re-runs the chunks
  whose start differs from their predecessor's final, until none does.
  By induction over the chunks, that is the sequential definition.

On a CUDA tensor the wrappers launch the kernel; on a CPU tensor they run
the plain version.
"""

from __future__ import annotations

import torch

from ..codecs.adpcm_trellis import trellis_lanes
from . import _build

LAUNCHES = 0
MAX_LEN = 1 << 17      # kernel L's longest chunk (its int64 keys' room)


def _check(x, starts, pairs, step0, pred0, out) -> int:
    """Raise on a malformed call; -> the longest chunk's samples (one host
    sync for both)."""
    if x.dim() != 1 or x.dtype != torch.int16 or x.numel() % 2:
        raise ValueError(f"x must be int16 [even n], got {x.dtype} "
                         f"{tuple(x.shape)}")
    a = starts.shape[0]
    for name, t, dt in (("starts", starts, torch.int64),
                        ("pairs", pairs, torch.int32),
                        ("step0", step0, torch.int32),
                        ("pred0", pred0, torch.int32)):
        if t.shape != (a,) or t.dtype != dt:
            raise ValueError(f"{name} must be {dt} [{a}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if out.shape != (x.numel() // 2,) or out.dtype != torch.uint8:
        raise ValueError(f"out must be uint8 [{x.numel() // 2}], got "
                         f"{out.dtype} {tuple(out.shape)}")
    if not a:
        return 0
    bad = ((starts < 0) | (starts % 2 != 0) | (pairs < 0) |
           (starts + 2 * pairs.long() > x.numel()) |
           (step0 < 0) | (step0 > 88)).any()
    bad, len_max = torch.stack([bad.long(), 2 * pairs.max().long()]).tolist()
    if bad:
        raise ValueError("each chunk must start at an even sample, lie "
                         "within x, and start from a step index in 0..88")
    return len_max


def trellis_chunks(x: torch.Tensor, starts: torch.Tensor,
                   pairs: torch.Tensor, step0: torch.Tensor,
                   pred0: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """x int16 [total] (total even), starts int64 [A] (even; chunk a is
    the 2 * pairs[a] samples from starts[a]), pairs int32 [A], step0 int32
    [A] in 0..88, pred0 int32 [A]; writes chunk a's bytes into out uint8
    [total / 2] at starts[a] / 2 and returns its final step index, int32
    [A]."""
    len_max = _check(x, starts, pairs, step0, pred0, out)
    a = starts.shape[0]
    if all(t.device.type == "cpu"
           for t in (x, starts, pairs, step0, pred0, out)):
        return trellis_chunks_plain(x, starts, pairs, step0, pred0, out)
    _build.require_cuda(x, starts, pairs, step0, pred0, out)
    final = torch.empty(a, dtype=torch.int32, device=x.device)
    if a == 0:
        return final
    if len_max > MAX_LEN:
        raise ValueError(f"kernel L takes chunks of at most {MAX_LEN} "
                         f"samples, got {len_max}")
    x, starts, pairs, step0, pred0 = (t.contiguous() for t in (
        x, starts, pairs, step0, pred0))
    with _build.on_device(x, starts, pairs, step0, pred0, out) as (lib,
                                                                   stream):
        back = torch.empty(lib.amv_trellis_scratch(a, len_max) // 4,
                           dtype=torch.int32, device=x.device)
        rc = lib.amv_trellis(
            x.data_ptr(), starts.data_ptr(), pairs.data_ptr(),
            step0.data_ptr(), pred0.data_ptr(), a, len_max, back.data_ptr(),
            out.data_ptr(), final.data_ptr(), stream)
    _build.check(rc, "amv_trellis")
    global LAUNCHES
    LAUNCHES += 1
    return final


def trellis_chunks_plain(x, starts, pairs, step0, pred0, out):
    """Plain torch version of kernel L on any device (same outputs)."""
    dev = x.device
    a = starts.shape[0]
    if a == 0:
        return torch.empty(0, dtype=torch.int32, device=dev)
    lens = 2 * pairs.long()
    t = torch.arange(int(lens.max()), device=dev)
    idx = (starts[:, None] + t[None, :]).clamp(max=x.numel() - 1)
    nib, final = trellis_lanes(x[idx], lens, step0, pred0)
    packed = (nib[:, 0::2] << 4) | nib[:, 1::2]          # [A, max pairs]
    j = torch.arange(packed.shape[1], device=dev)
    mine = j[None, :] < pairs[:, None]
    out[(starts[:, None] // 2 + j[None, :])[mine]] = packed[mine]
    return final.to(torch.int32)


def encode_chain(x: torch.Tensor, starts: torch.Tensor, pairs: torch.Tensor,
                 init_step: int, guess: torch.Tensor, rounds: bool = False):
    """The trellis encode of a stream's chunks: x int16 [total], starts
    int64 [C], pairs int32 [C] as for `trellis_chunks`; init_step (0..88)
    starts chunk 0, and guess int32 [C] is the other chunks' round-1 start
    (clamped to 0..88).  -> (bytes uint8 [total / 2], step int32 [C] each
    chunk's start, the header's step index, final int32 [C][, the number
    of rounds])."""
    if not 0 <= init_step <= 88:
        raise ValueError(f"init_step must be in 0..88, got {init_step}")
    dev = x.device
    c = starts.shape[0]
    out = torch.zeros(x.numel() // 2, dtype=torch.uint8, device=dev)
    step = guess.to(torch.int32).clamp(0, 88).clone()
    final = torch.empty(c, dtype=torch.int32, device=dev)
    n_rounds = 0
    if c:
        step[0] = init_step
        pred0 = x[starts].to(torch.int32)
        active = torch.arange(c, device=dev)
        while active.numel():
            n_rounds += 1
            final[active] = trellis_chunks(
                x, starts[active], pairs[active], step[active],
                pred0[active], out)
            active = torch.nonzero(step[1:] != final[:-1]).flatten() + 1
            step[active] = final[active - 1]
    return (out, step, final, n_rounds) if rounds else (out, step, final)
