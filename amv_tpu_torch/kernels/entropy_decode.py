"""Kernel D: Huffman decode of unescaped AMV scans into zigzag levels.

The port of `amv_tpu/kernels/entropy_async_pallas.py:
decode_scans_async_dense` and its lockstep twin
`amv_tpu/kernels/entropy_decode_pallas.py:_decode_layout`, backed by one
CUDA kernel, csrc/entropy_decode.cu (a thread block per frame that splits
the scan into subsequences, decodes them speculatively in parallel and
brings them into step: speculate, sync, scan, write).  Its input is
the row matrix of `amv_tpu.native.entropy_native.unescape_frames` as
tensors; the TPU's big-endian word layout (`scan_words_layout`) is not
needed.  Semantics are the C decoder's (`native/entropy.c:
decode_scan_levels`), including where `ok` is 0.  A frame also fails
when it spends its token budget (`token_budget`, which no scan the C
decoder accepts reaches; the keyword `budget` sets another, to test that
path).

On a CUDA tensor `decode_scans` launches the kernel; on a CPU tensor it
runs `decode_scans_plain`, a lockstep decoder that takes one token of
every frame per step (the shape of `amv_tpu/kernels/entropy_decode.py`).
"""

from __future__ import annotations

import torch

from ..codecs.jpeg_tables import device_table
from . import _build

LAUNCHES = 0


def _check(rows, lens, n_blocks):
    if rows.dim() != 2 or rows.dtype != torch.uint8:
        raise ValueError(f"rows must be uint8 [F, stride], got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    if lens.shape != rows.shape[:1] or lens.dtype != torch.int64:
        raise ValueError(f"lens must be int64 [{rows.shape[0]}], got "
                         f"{lens.dtype} {tuple(lens.shape)}")
    if n_blocks <= 0 or n_blocks % 6:
        raise ValueError(f"n_blocks must be a positive multiple of 6, "
                         f"got {n_blocks}")


def token_budget(lens: torch.Tensor, n_blocks: int,
                 stride: int) -> torch.Tensor:
    """The tokens a frame may decode, int64 [F]: n_blocks * 65 + 4 * lens
    + 64 (every code is at least 2 bits, and the zero fill finishes a block
    within 64 tokens, so no scan reaches it)."""
    return n_blocks * 65 + 4 * lens.clamp(0, stride) + 64


def decode_scans(rows: torch.Tensor, lens: torch.Tensor, n_blocks: int, *,
                 budget: torch.Tensor | None = None, rounds: bool = False):
    """rows uint8 [F, stride] unescaped scans, lens int64 [F] valid bytes
    per row -> (levels int16 [F, n_blocks, 64] zigzag with slot 0 = DC
    difference, ok uint8 [F]).  budget int64 [F] replaces
    `token_budget`.  rounds=True appends this launch's sync rounds per
    frame, int32 [F] (None from the plain version, which has none)."""
    _check(rows, lens, n_blocks)
    if rows.device.type == "cpu" and lens.device.type == "cpu":
        out = decode_scans_plain(rows, lens, n_blocks, budget=budget)
        return (*out, None) if rounds else out
    _build.require_cuda(rows, lens)
    rows, lens = rows.contiguous(), lens.contiguous()
    f, stride = rows.shape
    if budget is None:
        budget = token_budget(lens, n_blocks, stride)
    _build.require_cuda(rows, budget)
    budget = budget.to(torch.int64).contiguous()
    levels = torch.zeros((f, n_blocks, 64), dtype=torch.int16,
                         device=rows.device)
    ok = torch.empty(f, dtype=torch.uint8, device=rows.device)
    n_rounds = torch.empty(f, dtype=torch.int32, device=rows.device)
    tables = device_table("DEC_FAST", rows.device)
    # the longest scans first: they take the most sync rounds
    order = torch.argsort(lens, descending=True, stable=True).to(torch.int32)
    with _build.on_device(rows, lens, budget) as (lib, stream):
        rc = lib.amv_decode_scans(
            rows.data_ptr(), stride, lens.data_ptr(), order.data_ptr(), f,
            n_blocks, tables.data_ptr(), budget.data_ptr(), levels.data_ptr(),
            ok.data_ptr(), n_rounds.data_ptr(), stream)
    _build.check(rc, "amv_decode_scans")
    global LAUNCHES
    LAUNCHES += 1
    return (levels, ok, n_rounds) if rounds else (levels, ok)


def decode_scans_plain(rows: torch.Tensor, lens: torch.Tensor,
                       n_blocks: int, *, budget: torch.Tensor | None = None):
    """Plain torch version of kernel D on any device (same outputs)."""
    dev = rows.device
    f, stride = rows.shape
    lut = device_table("DEC_LUT", dev).long().reshape(-1)
    if budget is None:
        budget = token_budget(lens, n_blocks, stride)
    budget = budget.to(device=dev, dtype=torch.int64)
    lens = lens.clamp(0, stride)
    # zero past lens, plus 4 zero bytes so a 5-byte peek never leaves a row
    col = torch.arange(stride + 5, device=dev)
    data = torch.zeros((f, stride + 5), dtype=torch.int64, device=dev)
    data[:, :stride] = rows.long()
    data = torch.where(col[None, :] < lens[:, None], data, 0)
    last = stride + 4
    out = torch.zeros(f * n_blocks * 64 + 1, dtype=torch.int16, device=dev)
    trash = f * n_blocks * 64
    fr = torch.arange(f, device=dev)

    bitpos = torch.zeros(f, dtype=torch.int64, device=dev)
    block = torch.zeros(f, dtype=torch.int64, device=dev)
    pos = torch.full((f,), -1, dtype=torch.int64, device=dev)  # -1: DC next
    good = torch.ones(f, dtype=torch.bool, device=dev)
    tokens = torch.zeros(f, dtype=torch.int64, device=dev)

    def step():
        nonlocal bitpos, block, pos, good, tokens
        active = good & (block < n_blocks)
        byte = (bitpos >> 3).clamp(max=last - 4)
        v40 = torch.zeros(f, dtype=torch.int64, device=dev)
        for k in range(5):
            v40 = (v40 << 8) | data[fr, byte + k]
        peek32 = (v40 >> (8 - (bitpos & 7))) & 0xFFFFFFFF
        is_dc = pos < 0
        luma = block % 6 < 4
        tab = torch.where(is_dc, 0, 2) + torch.where(luma, 0, 1)
        ent = lut[tab * 65536 + (peek32 >> 16)]
        ln = ent & 31
        sym = ent >> 5
        run, size = sym >> 4, sym & 15
        eob = ~is_dc & (sym == 0)
        zrl = ~is_dc & (size == 0) & (run == 15)
        coef = ~is_dc & (size > 0)
        nb = torch.where(is_dc, sym, torch.where(coef, size, 0))
        sh = (32 - ln - nb).clamp(min=0)
        v = (peek32 >> sh) & ((1 << nb) - 1)
        neg = ((v >> (nb - 1).clamp(min=0)) & 1) == 0
        level = torch.where((nb > 0) & neg, v - ((1 << nb) - 1), v)
        newpos = pos + run + 1
        tokens = tokens + active.long()
        bad = active & ((ln == 0) | (tokens > budget) |
                        (~is_dc & (size == 0) & (run != 15) & (sym != 0)) |
                        (coef & (newpos > 63)))
        live = active & ~bad
        write = live & (is_dc | coef)
        dst = block * 64 + torch.where(is_dc, 0, newpos).clamp(0, 63)
        idx = torch.where(write, fr * (n_blocks * 64) + dst, trash)
        out.index_put_((idx,), level.to(torch.int16))
        end = eob | (coef & (newpos == 63))
        bitpos = torch.where(live, bitpos + ln + nb, bitpos)
        pos = torch.where(live, torch.where(
            is_dc, 0, torch.where(zrl, pos + 16, torch.where(
                end, -1, newpos))), pos)
        block = torch.where(live & end, block + 1, block)
        good = good & ~bad

    while bool((good & (block < n_blocks)).any()):
        for _ in range(32):          # steps between host syncs
            step()
    levels = out[:trash].reshape(f, n_blocks, 64)
    return levels, good.to(torch.uint8)
