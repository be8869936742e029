"""Kernels A and Q: IMA-ADPCM (AMV flavour) decode and encode.

* A, `decode_chunks`: the port of `amv_tpu/kernels/adpcm_pallas.py:
  decode_layout` and `decode_layout_wrap`, backed by csrc/adpcm_decode.cu
  (a warp per chunk: the step-index and the predictor recurrences are
  clipped additions, decoded as two warp scans of clipped-add maps).  Plain version: `decode_chunks_plain`, the
  `amv_tpu.kernels.adpcm.decode_nibbles_scan` form, a loop over samples
  vectorised over chunks.
* Q, `encode_streams`: the port of `amv_tpu/kernels/adpcm_encode_pallas.py:
  encode_layout` and `encode_layout_wrap` (`encode_streams_pallas`'s
  contract), backed by csrc/adpcm_encode.cu.  The predictor restarts at
  every reset, so only the step index (0..88) carries from one reset
  segment to the next: the kernel cuts each stream into windows of 512
  samples (a window's segment runs from its first even reset to the next
  window's), finds every segment's end step index for each of
  the 89 possible starts (recording each start's state every 256
  samples), chains the segments (in groups of 64 windows), and
  encodes every run of 256 samples from its true start or checkpoint.
  Plain version: `encode_streams_plain`, the same three passes in torch
  over the reset segments of `segments`.

`repeat=R` is the wrap entries' contract: output row i reads input row
i % C, as over an input tiled R times, without the tiled copy.

`decode_ms_nibbles` is the MS-ADPCM decode of WAV input, torch ops over
lanes on any device (no kernel: no Pallas kernel carries it in JAX).

On a CUDA tensor the wrappers launch the kernel; on a CPU tensor they run
the plain version.  Arithmetic: adpcm.c:716-740 (expand) and :219-227
(compress), as `amv_tpu/verify/ref_adpcm.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..verify.ref_adpcm import STEP_TABLE
from ..verify.ref_wav_audio import MS_ADAPTATION_TABLE
from . import _build

DECODE_LAUNCHES = 0   # kernel A
ENCODE_LAUNCHES = 0   # kernel Q


def _steps(dev) -> torch.Tensor:
    return torch.as_tensor(STEP_TABLE, device=dev).long()


def _index_step(d):
    """The index table for the magnitude d = nibble & 7: d < 4 ? -1 :
    2d - 6."""
    return torch.where(d < 4, -1, 2 * d - 6)


# ------------------------------------------------------------- decode (A)

def decode_chunks(payload: torch.Tensor, pred: torch.Tensor,
                  sidx: torch.Tensor, repeat: int = 1) -> torch.Tensor:
    """payload uint8 [C, nbytes] nibble bytes, pred int32 [C], sidx int32
    [C] (clamped to 0..88 here) -> pcm int16 [C * repeat, 2 * nbytes],
    the high nibble of each byte first; row i decodes chunk i % C."""
    if payload.dim() != 2 or payload.dtype != torch.uint8:
        raise ValueError(f"payload must be uint8 [C, nbytes], got "
                         f"{payload.dtype} {tuple(payload.shape)}")
    c, nbytes = payload.shape
    for name, t in (("pred", pred), ("sidx", sidx)):
        if t.shape != (c,) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 [{c}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if repeat < 1:
        raise ValueError(f"repeat must be >= 1, got {repeat}")
    if all(t.device.type == "cpu" for t in (payload, pred, sidx)):
        return decode_chunks_plain(payload, pred, sidx, repeat)
    if c * repeat >= 2 ** 31 or nbytes >= 2 ** 31:
        raise ValueError(f"{c * repeat} rows of {nbytes} bytes: kernel A "
                         "takes fewer than 2^31 of each (32-bit indices)")
    _build.require_cuda(payload, pred, sidx)
    payload, pred, sidx = (t.contiguous() for t in (payload, pred, sidx))
    out = torch.empty((c * repeat, 2 * nbytes), dtype=torch.int16,
                      device=payload.device)
    with torch.cuda.device(payload.device):
        rc = _build.library().amv_adpcm_decode(
            payload.data_ptr(), nbytes, pred.data_ptr(), sidx.data_ptr(), c,
            c * repeat, out.data_ptr(), _build.stream())
    _build.check(rc, "amv_adpcm_decode")
    global DECODE_LAUNCHES
    DECODE_LAUNCHES += 1
    return out


def decode_chunks_plain(payload: torch.Tensor, pred: torch.Tensor,
                        sidx: torch.Tensor, repeat: int = 1) -> torch.Tensor:
    """Plain torch version of kernel A on any device (same output)."""
    dev = payload.device
    steps = _steps(dev)
    d8 = payload.long()
    nib = torch.stack([d8 >> 4, d8 & 15], dim=2).reshape(d8.shape[0], -1)
    p = pred.long()
    s = sidx.long().clamp(0, 88)
    out = torch.empty(nib.shape, dtype=torch.int16, device=dev)
    for t in range(nib.shape[1]):
        nt = nib[:, t]
        d = nt & 7
        diff = ((2 * d + 1) * steps[s]) >> 3
        p = torch.clamp(torch.where(nt >= 8, p - diff, p + diff),
                        -32768, 32767)
        s = torch.clamp(s + _index_step(d), 0, 88)
        out[:, t] = p.to(torch.int16)
    return out.repeat(repeat, 1)


# ------------------------------------------------------------- encode (Q)

def segments(reset: torch.Tensor):
    """Reset segments of streams reset bool [B, n] (n even): a segment
    starts at sample 0 and at every even sample with a reset, and ends
    where the next one starts.  Returns (stream int64 [S], start int64
    [S], end int64 [S], off int64 [B + 1]), segments in stream order, those
    of stream b at off[b]:off[b + 1]."""
    b, n = reset.shape
    head = reset.clone()
    head[:, 1::2] = False
    head[:, 0] = True
    stream, start = torch.nonzero(head, as_tuple=True)
    same = torch.zeros_like(stream, dtype=torch.bool)
    same[:-1] = stream[1:] == stream[:-1]
    nxt = torch.full_like(start, n)
    nxt[:-1] = start[1:]
    end = torch.where(same, nxt, n)
    off = torch.zeros(b + 1, dtype=torch.int64, device=reset.device)
    off[1:] = torch.cumsum(torch.bincount(stream, minlength=b), 0)
    return stream, start, end, off


def _check_encode(samples, reset, sidx0, repeat):
    if samples.dim() != 2 or samples.dtype not in (torch.int16, torch.int32):
        raise ValueError(f"samples must be int16 [B, n], got "
                         f"{samples.dtype} {tuple(samples.shape)}")
    b, n = samples.shape
    if n % 2:
        raise ValueError(f"samples per stream must be even, got {n}")
    if reset.shape != samples.shape or reset.dtype != torch.bool:
        raise ValueError(f"reset must be bool {tuple(samples.shape)}, got "
                         f"{reset.dtype} {tuple(reset.shape)}")
    if sidx0.shape != (b,) or sidx0.dtype != torch.int32:
        raise ValueError(f"sidx0 must be int32 [{b}], got {sidx0.dtype} "
                         f"{tuple(sidx0.shape)}")
    if repeat < 1:
        raise ValueError(f"repeat must be >= 1, got {repeat}")


def encode_streams(samples: torch.Tensor, reset: torch.Tensor,
                   sidx0: torch.Tensor, repeat: int = 1):
    """samples int16 [B, n] (n even), reset bool [B, n] (the predictor
    takes the sample there, adpcm.c:464), sidx0 int32 [B] (clamped to
    0..88) -> (bytes uint8 [B * repeat, n / 2], sidx_even uint8
    [B * repeat, n / 2]): nibble pairs, first nibble high, and the step
    index before sample 2t.  Row i encodes stream i % B."""
    _check_encode(samples, reset, sidx0, repeat)
    b, n = samples.shape
    if b == 0 or n == 0:
        out = torch.zeros((b * repeat, n // 2), dtype=torch.uint8,
                          device=samples.device)
        return out, out.clone()
    if all(t.device.type == "cpu" for t in (samples, reset, sidx0)):
        return encode_streams_plain(samples, reset, sidx0, repeat)
    _build.require_cuda(samples, reset, sidx0)
    dev = samples.device
    x = samples.to(torch.int16).contiguous()
    r = reset.contiguous()          # bool: one byte a flag
    # pass 3 copies both by 4-byte cp.async: a view that starts off a
    # 4-byte boundary is copied
    x, r = (t if t.data_ptr() % 4 == 0 else t.clone() for t in (x, r))
    sidx0 = sidx0.contiguous()
    lib = _build.library()
    scratch = torch.empty(lib.amv_adpcm_encode_scratch(b, n, repeat),
                          dtype=torch.uint8, device=dev)
    out = torch.empty((2, b * repeat, n // 2), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        rc = lib.amv_adpcm_encode(
            x.data_ptr(), r.data_ptr(), sidx0.data_ptr(), b, n, repeat,
            scratch.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            _build.stream())
    _build.check(rc, "amv_adpcm_encode")
    global ENCODE_LAUNCHES
    ENCODE_LAUNCHES += 1
    return out[0], out[1]


def _compress(p, s, x, steps):
    """One adpcm_ima_compress_sample step on tensors -> (p, s, nibble)."""
    step = steps[s]
    delta = x - p
    neg = delta < 0
    mag = torch.clamp(delta.abs() * 4 // step, max=7)
    recon = (step * (2 * mag + 1)) >> 3
    p = torch.clamp(torch.where(neg, p - recon, p + recon), -32768, 32767)
    s = torch.clamp(s + _index_step(mag), 0, 88)
    return p, s, mag + torch.where(neg, 8, 0)


def encode_streams_plain(samples: torch.Tensor, reset: torch.Tensor,
                         sidx0: torch.Tensor, repeat: int = 1):
    """Plain torch version of kernel Q on any device (same outputs): the
    kernel's three passes, each a loop over the longest segment's samples
    vectorised over segments."""
    dev = samples.device
    steps = _steps(dev)
    b, n = samples.shape
    stream, start, end, off = segments(reset)
    seg_len = end - start
    t = torch.arange(int(seg_len.max()), device=dev)
    valid = t[None, :] < seg_len[:, None]                     # [S, L]
    idx = torch.where(valid, start[:, None] + t[None, :], 0)
    x = samples.to(torch.int16).long()[stream[:, None], idx]
    r = reset[stream[:, None], idx] & valid

    def run(p, s, k, col):
        """One sample step of every segment; col shapes a [S] column."""
        xk, vk = col(x[:, k]), col(valid[:, k])
        p = torch.where(col(r[:, k]), xk, p)
        p2, s2, nib = _compress(p, s, xk, steps)
        return torch.where(vk, p2, p), torch.where(vk, s2, s), nib

    # pass 1: the end step index of every segment from each start 0..88
    s = torch.arange(89, device=dev).repeat(len(start), 1)
    p = torch.zeros_like(s)
    for k in range(t.shape[0]):
        p, s, _ = run(p, s, k, lambda v: v[:, None])
    ends = s.cpu().numpy()
    # pass 2: chain the segments of each stream from its sidx0
    first = np.zeros(len(start), np.int64)
    off_h, s0_h = off.cpu().numpy(), sidx0.cpu().numpy()
    for bi in range(b):
        si = min(max(int(s0_h[bi]), 0), 88)
        for k in range(off_h[bi], off_h[bi + 1]):
            first[k] = si
            si = int(ends[k, si])
    # pass 3: encode every segment once from its true start
    s = torch.from_numpy(first).to(dev)
    p = torch.zeros_like(s)
    nibs, before = torch.empty_like(x), torch.empty_like(x)
    for k in range(t.shape[0]):
        before[:, k] = s
        p, s, nibs[:, k] = run(p, s, k, lambda v: v)
    packed = ((nibs[:, 0::2] << 4) | nibs[:, 1::2]).to(torch.uint8)
    out = torch.zeros((b, n // 2), dtype=torch.uint8, device=dev)
    sidx_even = torch.zeros_like(out)
    half = valid[:, 0::2]
    rows = stream[:, None].expand_as(half)[half]
    cols = (idx[:, 0::2] // 2)[half]
    out[rows, cols] = packed[half]
    sidx_even[rows, cols] = before[:, 0::2].to(torch.uint8)[half]
    return out.repeat(repeat, 1), sidx_even.repeat(repeat, 1)


# --------------------------------------------------- MS-ADPCM decode (WAV)

def decode_ms_nibbles(nibbles: torch.Tensor, coeff1: torch.Tensor,
                      coeff2: torch.Tensor, idelta: torch.Tensor,
                      sample1: torch.Tensor, sample2: torch.Tensor
                      ) -> torch.Tensor:
    """MS-ADPCM expand (adpcm.c:743-756) of nibble streams int32 [B, n] in
    emit order, lane-parallel on their device: a loop over the n samples,
    each step torch ops over the B lanes, as `amv_tpu.kernels.adpcm.
    decode_ms_nibbles`' lax.scan.  The state vectors (int32 [B], from the
    block headers) stay int32, so idelta's growth wraps as C's `int` does;
    C's `/ 256` truncates toward zero.  -> int16 [B, n] (the header's two
    samples are the caller's)."""
    dev = nibbles.device
    adapt = torch.as_tensor(MS_ADAPTATION_TABLE, dtype=torch.int32,
                            device=dev)
    c1, c2 = coeff1.to(torch.int32), coeff2.to(torch.int32)
    s1, s2 = sample1.to(torch.int32), sample2.to(torch.int32)
    idl = idelta.to(torch.int32)
    nib = nibbles.to(torch.int32)
    signed = torch.where(nib >= 8, nib - 16, nib)
    scale = adapt[nib]
    out = torch.empty(nib.shape, dtype=torch.int16, device=dev)
    for t in range(nib.shape[1]):
        pred = s1 * c1 + s2 * c2
        pred = (pred + ((pred >> 31) & 255)) >> 8
        s1, s2 = (pred + signed[:, t] * idl).clamp(-32768, 32767), s1
        idl = torch.clamp((scale[:, t] * idl) >> 8, min=16)
        out[:, t] = s1
    return out
