"""Kernel P: pack Huffman records into unescaped scan words.

The port of `amv_tpu/kernels/entropy_encode_async_pallas.py:_pack_records`,
the packer of the record encoder (`entropy_records.encode_layout_async`)
and the splice of the rechunk encoder (`entropy_parallel.
encode_layout_rechunk`), backed by one CUDA kernel, csrc/record_pack.cu
(one thread per lane, kernel E's bit writer).  A record is
`code << 5 | len`: `len` (0..31) bits of `code` (< 2^len, at most 27 bits),
appended MSB-first.  The output is what `native.escape_frames` takes:
big-endian words int32 [L, w_out], the tail zero-filled, and bits int32
[L] = the sum of the lengths, which still counts past w_out words (the
words there are dropped; callers test bits against w_out).

On a CUDA tensor `pack_records` launches the kernel; on a CPU tensor it
runs `pack_records_plain`: a prefix sum of the lengths and a scatter-add of
each record's one or two words (records own disjoint bits, so add is or).
"""

from __future__ import annotations

import torch

from . import _build

LAUNCHES = 0
M32 = 0xFFFFFFFF


def word_parts(code: torch.Tensor, ln: torch.Tensor, start: torch.Tensor):
    """int64 codes of ln (<= 32) bits at bit offset start -> (head, tail):
    the bits that land in word start >> 5, and those that spill into the
    next (0 where none do), each as a 32-bit word value; as JAX's uint32
    shifts (entropy_encode_parallel.py:214-223)."""
    end = (start & 31) + ln
    fits = end <= 32
    head = torch.where(fits, code << (32 - end).clamp(0, 31),
                       code >> (end - 32).clamp(min=0)) & M32
    tail = torch.where(fits, 0, code << (64 - end).clamp(max=63)) & M32
    return head, tail


def _check(records, totals, w_out):
    if records.dim() != 2 or records.dtype != torch.int32:
        raise ValueError(f"records must be int32 [L, T], got "
                         f"{records.dtype} {tuple(records.shape)}")
    if totals.shape != records.shape[:1] or totals.dtype != torch.int32:
        raise ValueError(f"totals must be int32 [{records.shape[0]}], got "
                         f"{totals.dtype} {tuple(totals.shape)}")
    if w_out <= 0:
        raise ValueError(f"w_out must be positive, got {w_out}")


def pack_records(records: torch.Tensor, totals: torch.Tensor, w_out: int):
    """records int32 [L, T] (code << 5 | len), totals int32 [L] (records
    used per lane, at most T) -> (words int32 [L, w_out], bits int32 [L])."""
    _check(records, totals, w_out)
    if records.device.type == "cpu" and totals.device.type == "cpu":
        return pack_records_plain(records, totals, w_out)
    _build.require_cuda(records, totals)
    records, totals = records.contiguous(), totals.contiguous()
    n = records.shape[0]
    words = torch.zeros((n, w_out), dtype=torch.int32, device=records.device)
    bits = torch.empty(n, dtype=torch.int32, device=records.device)
    with torch.cuda.device(records.device):
        rc = _build.library().amv_pack_records(
            records.data_ptr(), records.shape[1], totals.data_ptr(), n, w_out,
            words.data_ptr(), bits.data_ptr(), _build.stream())
    _build.check(rc, "amv_pack_records")
    global LAUNCHES
    LAUNCHES += 1
    return words, bits


def pack_records_plain(records: torch.Tensor, totals: torch.Tensor,
                       w_out: int):
    """Plain torch version of kernel P on any device (same outputs)."""
    dev = records.device
    n, t = records.shape
    rec = records.long() & M32
    used = torch.arange(t, device=dev)[None, :] < totals.long()[:, None]
    ln = torch.where(used, rec & 31, 0)
    code = ((rec >> 5) & 0x7FFFFFF) & ((1 << ln) - 1)
    ends = torch.cumsum(ln, dim=1)
    bits = ends[:, -1] if t else torch.zeros(n, dtype=torch.int64,
                                                 device=dev)
    off = ends - ln
    o32 = off >> 5
    acc = torch.zeros((n, w_out + 1), dtype=torch.int64, device=dev)
    live = ln > 0
    for k, wk in enumerate(word_parts(code, ln, off)):
        idx = torch.where(live, (o32 + k).clamp(max=w_out), w_out)
        acc.scatter_add_(1, idx, torch.where(live, wk, 0))
    words = (((acc[:, :w_out] + 0x80000000) & M32) - 0x80000000)
    return words.to(torch.int32), bits.to(torch.int32)
