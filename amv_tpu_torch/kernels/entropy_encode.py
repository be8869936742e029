"""Kernel E: Huffman pack of zigzag levels into unescaped scan words.

The port of `amv_tpu/kernels/entropy_encode_async_pallas.py:
encode_layout_async_dense` and its lockstep twin
`amv_tpu/kernels/entropy_encode_pallas.py:_encode_layout`, backed by one
CUDA kernel, csrc/entropy_encode.cu (a thread block per frame, a warp per
8x8 block, the block offsets handed from warp to warp).  The output is what
`amv_tpu.native.entropy_native.escape_frames` takes: big-endian words
int32 [F, w_out] and exact bit counts int32 [F].  `ok` is 0 for a frame
whose bits exceed w_out words; its bits still count.  `count_bits` is the
kernel's count alone: each frame's exact bits, no words.

On a CUDA tensor `encode_levels` and `count_bits` launch the kernel; on a
CPU tensor they run `encode_levels_plain` and `count_bits_plain`, the
vectorized token / prefix-sum / scatter packer of
`amv_tpu/kernels/entropy_encode.py`, stopping at words and bits.
"""

from __future__ import annotations

import torch

from ..codecs.jpeg_tables import device_table
from . import _build

# kernel E's launches through either entry, and through count_bits alone
LAUNCHES = 0
COUNT_LAUNCHES = 0


def _check(levels: torch.Tensor) -> None:
    if levels.dim() != 3 or levels.shape[2] != 64 or \
            levels.dtype != torch.int16 or levels.shape[1] % 6:
        raise ValueError(f"levels must be int16 [F, 6k, 64], got "
                         f"{levels.dtype} {tuple(levels.shape)}")


def _on_card(levels: torch.Tensor) -> torch.Tensor:
    """levels as the kernel reads them: contiguous, 4-byte aligned (a lane
    loads two slots as one word)."""
    _build.require_cuda(levels)
    levels = levels.contiguous()
    return levels if levels.data_ptr() % 4 == 0 else levels.clone()


def encode_levels(levels: torch.Tensor, w_out: int):
    """levels int16 [F, n_blocks, 64] zigzag, slot 0 = absolute DC ->
    (words int32 [F, w_out], bits int32 [F], ok uint8 [F])."""
    _check(levels)
    if w_out <= 0:
        raise ValueError(f"w_out must be positive, got {w_out}")
    if levels.device.type == "cpu":
        return encode_levels_plain(levels, w_out)
    levels = _on_card(levels)
    f, nb = levels.shape[:2]
    # the kernel writes every word of every row
    words = torch.empty((f, w_out), dtype=torch.int32, device=levels.device)
    bits = torch.empty(f, dtype=torch.int32, device=levels.device)
    ok = torch.empty(f, dtype=torch.uint8, device=levels.device)
    tables = device_table("ENC_TABLES", levels.device)
    with torch.cuda.device(levels.device):
        rc = _build.library().amv_encode_levels(
            levels.data_ptr(), f, nb, tables.data_ptr(), w_out,
            words.data_ptr(), bits.data_ptr(), ok.data_ptr(),
            _build.stream())
    _build.check(rc, "amv_encode_levels")
    global LAUNCHES
    LAUNCHES += 1
    return words, bits, ok


def count_bits(levels: torch.Tensor) -> torch.Tensor:
    """levels int16 [F, n_blocks, 64] as `encode_levels` takes them ->
    bits int32 [F], the exact scan bits of each frame (kernel E's count and
    scan, no words)."""
    _check(levels)
    if levels.device.type == "cpu":
        return count_bits_plain(levels)
    levels = _on_card(levels)
    f, nb = levels.shape[:2]
    bits = torch.empty(f, dtype=torch.int32, device=levels.device)
    tables = device_table("ENC_TABLES", levels.device)
    with torch.cuda.device(levels.device):
        rc = _build.library().amv_count_bits(
            levels.data_ptr(), f, nb, tables.data_ptr(), bits.data_ptr(),
            _build.stream())
    _build.check(rc, "amv_count_bits")
    global LAUNCHES, COUNT_LAUNCHES
    LAUNCHES += 1
    COUNT_LAUNCHES += 1
    return bits


def bitlen(v):
    """bit length of non-negative int64 values below 2^32."""
    r = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        m = v >= (1 << s)
        r = r + torch.where(m, s, 0)
        v = torch.where(m, v >> s, v)
    return r + (v > 0).long()


def dc_differences(lv: torch.Tensor) -> torch.Tensor:
    """Levels [F, NB, 64] (slot 0 = absolute DC) -> int64 [F, NB] DC
    differences against per-component predictors starting at 128 (Y over
    blocks 0-3 of each MCU, Cb block 4, Cr block 5)."""
    dc = lv[:, :, 0].long()
    t6 = torch.arange(lv.shape[1], device=lv.device) % 6
    diff = torch.zeros_like(dc)
    for sel in (t6 < 4, t6 == 4, t6 == 5):
        c = dc[:, sel]
        prev = torch.cat([torch.full_like(c[:, :1], 128), c[:, :-1]], dim=1)
        diff[:, sel] = c - prev
    return diff


def _append(val, ln, code, size):
    """(val, ln) <<= size; |= code masked to size bits."""
    return (val << size) | (code & ((1 << size) - 1)), ln + size


def _tokens(levels: torch.Tensor):
    """Every block of levels [F, NB, 64] as 128 token slots: its DC (code +
    mantissa), then per AC slot i a ZRL token (the ZRLs before slot i) and
    a code + mantissa token, then the EOB -> (values, lengths) int64
    [F, NB * 128], a value in the low `length` (<= 33) bits."""
    dev = levels.device
    f, nb = levels.shape[:2]
    tab = device_table("ENC_TABLES", dev).long()
    code, size = tab[0].reshape(-1), tab[1].reshape(-1)
    lv = levels.long()
    t6 = torch.arange(nb, device=dev) % 6
    luma = t6 < 4
    dct = torch.where(luma, 0, 256)[None, :]
    act = torch.where(luma, 512, 768)[None, :, None]

    diff = dc_differences(lv)
    n = bitlen(diff.abs())
    dv, dl = _append(code[dct + n], size[dct + n], torch.where(
        diff < 0, diff - 1, diff), n)

    # AC: run of zeros before each nonzero slot i >= 1
    ac = lv[:, :, 1:]
    idx = torch.arange(1, 64, device=dev)
    nz = ac != 0
    prev_nz = torch.cummax(torch.where(nz, idx, 0), dim=2).values
    prev_excl = torch.cat([torch.zeros_like(prev_nz[..., :1]),
                           prev_nz[..., :-1]], dim=2)
    run = idx - prev_excl - 1
    mag = ac.abs()
    n = bitlen(mag)
    sym = (((run & 15) << 4) | n) & 255
    cv, cl = _append(code[act + sym], size[act + sym],
                     torch.where(ac < 0, ac - 1, ac), n)
    cv, cl = torch.where(nz, cv, 0), torch.where(nz, cl, 0)
    n_zrl = torch.where(nz, run >> 4, 0)
    zc, zs = code[act + 0xF0], size[act + 0xF0]
    zv, zl = torch.zeros_like(cv), torch.zeros_like(cl)
    for k in range(3):
        v2, l2 = _append(zv, zl, zc, zs)
        zv, zl = torch.where(n_zrl > k, v2, zv), torch.where(n_zrl > k, l2, zl)
    eob = lv[:, :, 63] == 0
    ev = torch.where(eob, code[act[:, :, 0]], 0)
    el = torch.where(eob, size[act[:, :, 0]], 0)

    tv = torch.cat([dv[..., None], torch.stack([zv, cv], dim=3).reshape(
        f, nb, 126), ev[..., None]], dim=2).reshape(f, nb * 128)
    tl = torch.cat([dl[..., None], torch.stack([zl, cl], dim=3).reshape(
        f, nb, 126), el[..., None]], dim=2).reshape(f, nb * 128)
    return tv, tl


def count_bits_plain(levels: torch.Tensor) -> torch.Tensor:
    """Plain torch version of `count_bits` on any device: the bits of
    `encode_levels_plain`, without the words."""
    return _tokens(levels)[1].sum(dim=1).to(torch.int32)


def encode_levels_plain(levels: torch.Tensor, w_out: int):
    """Plain torch version of kernel E on any device (same outputs).

    The tokens of `_tokens` get their bit offsets by a prefix sum; each
    token, MSB-aligned in 64 bits, is added into the <= 3 words it spans
    (tokens never overlap, so add is or)."""
    dev = levels.device
    f = levels.shape[0]
    tv, tl = _tokens(levels)
    ends = torch.cumsum(tl, dim=1)
    bits = ends[:, -1]
    off = ends - tl

    # token (<= 33 bits) MSB-aligned in a 64-bit (hi, lo) pair
    big = tl > 32
    hi = torch.where(big, tv >> (tl - 32).clamp(min=0),
                     tv << (32 - tl).clamp(min=0))
    lo = torch.where(big, (tv & ((1 << (tl - 32).clamp(min=0)) - 1))
                     << (64 - tl).clamp(max=32), 0)
    sh = off & 31
    m32 = 0xFFFFFFFF
    w0 = hi >> sh
    w1 = ((hi << (32 - sh)) & m32) | (lo >> sh)
    w2 = (lo << (32 - sh)) & m32
    o32 = off >> 5
    acc = torch.zeros((f, w_out + 3), dtype=torch.int64, device=dev)
    for k, wk in enumerate((w0, w1, w2)):
        acc.scatter_add_(1, (o32 + k).clamp(max=w_out + 2),
                         torch.where(tl > 0, wk, 0))
    words = acc[:, :w_out]
    words = (((words + 0x80000000) & m32) - 0x80000000).to(torch.int32)
    ok = (bits <= 32 * w_out).to(torch.uint8)
    return words, bits.to(torch.int32), ok
