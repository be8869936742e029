"""Kernels R and X, and the record encoder: the record-IR Huffman routes.

The port of the record IR of `amv_tpu/kernels/entropy_async_pallas.py`
(decode) and `amv_tpu/kernels/entropy_encode_async_pallas.py` (encode):

* kernel R, `decode_records` (`_decode_records`): kernel D's body
  (csrc/entropy_decode.cu: a thread block per frame decodes subsequences
  of the scan speculatively, brings them into step in sync rounds and
  writes) in its record mode, one int32 record a token,
  `level << 16 | is_dc << 7 | write << 6 | wpos`, with JAX's semantics
  (`ok` is blocks done == n_blocks, not the C decoder's), in a budget of
  T = t_max rounded up to 256 records a frame;
* kernel X, `expand_records` (`_expand_records` and the XLA glue of
  `decode_scans_async_layout`), csrc/record_expand.cu: a CTA a frame
  counts the is_dc records before each record (its block) with ballots
  and a scan over its warps, assembles the levels in a window of blocks
  in shared memory and stores every block once;
* `decode_scans_async`: R then X, the drop-in for kernel D with JAX's
  `decode_scans_async` semantics (no pad lanes: nothing here runs in
  1,024-frame tiles);
* `tokenize_levels` (`tokenize_levels_layout`, XLA in JAX, plain torch
  here): the per-slot records of `entropy_parallel.slot_records`
  compacted into a per-frame stream by a cumsum and a scatter, not JAX's
  binary search;
* `encode_layout_async` and `encode_scans_async`: the tokenizer then
  kernel P (`record_pack.pack_records`).

Layouts are frame-major: records [F, T], levels [F, n_blocks, 64].  On a
CUDA tensor the wrappers launch their kernels; on a CPU tensor they run
the plain versions in this module: R's is a lockstep decoder (one token of
every frame a step), X's an index_put.
"""

from __future__ import annotations

import torch

from ..codecs.jpeg_tables import device_table
from . import _build
from .entropy_parallel import frame_chunks, slot_records
from .record_pack import M32, pack_records

RECORD_LAUNCHES = 0      # kernel R
EXPAND_LAUNCHES = 0      # kernel X
TROW = 256               # JAX's record rows a grid step: T's granule
WIN_O = 128              # JAX's word-window rows: encode_scans_async's w_out


def _pad(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def record_rows(t_max: int) -> int:
    """The records a frame may emit for a budget t_max: t_max rounded up
    to TROW, as `_decode_records` runs whole grid steps."""
    return _pad(t_max, TROW)


def default_t_max(n_blocks: int, max_bytes: int) -> int:
    """Record budget of `decode_scans_async` (entropy_async_pallas.py:549):
    at most 64 records a block, and 2 bits or more a record."""
    return int(min(n_blocks * 64 + 8, 16 * n_blocks + 512,
                   max(max_bytes * 4, 1024)))


def default_t_max_enc(n_blocks: int) -> int:
    """Record budget of the record encoder (entropy_encode_async_pallas.py:
    437)."""
    return int(min(n_blocks * 64, 16 * n_blocks + 512))


# ---------------------------------------------------------------- decode

def _check_rows(rows, lens, n_blocks):
    if rows.dim() != 2 or rows.dtype != torch.uint8:
        raise ValueError(f"rows must be uint8 [F, stride], got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    if lens.shape != rows.shape[:1] or lens.dtype != torch.int64:
        raise ValueError(f"lens must be int64 [{rows.shape[0]}], got "
                         f"{lens.dtype} {tuple(lens.shape)}")
    if n_blocks <= 0 or n_blocks % 6:
        raise ValueError(f"n_blocks must be a positive multiple of 6, "
                         f"got {n_blocks}")


def decode_records(rows: torch.Tensor, lens: torch.Tensor, n_blocks: int,
                   t_max: int, *, rounds: bool = False):
    """rows uint8 [F, stride] unescaped scans, lens int64 [F] -> (records
    int32 [F, T], status int32 [F, 2] = (blocks done, records)), T =
    record_rows(t_max).  Records past a frame's last token are 0; a frame
    with blocks done < n_blocks ran out of records (or of a sane stream).
    rounds=True appends this launch's sync rounds per frame, int32 [F]
    (None from the plain version, which has none)."""
    _check_rows(rows, lens, n_blocks)
    if t_max <= 0:
        raise ValueError(f"t_max must be positive, got {t_max}")
    if rows.device.type == "cpu" and lens.device.type == "cpu":
        out = decode_records_plain(rows, lens, n_blocks, t_max)
        return (*out, None) if rounds else out
    _build.require_cuda(rows, lens)
    rows, lens = rows.contiguous(), lens.contiguous()
    f, t = rows.shape[0], record_rows(t_max)
    recs = torch.empty((f, t), dtype=torch.int32, device=rows.device)
    status = torch.empty((f, 2), dtype=torch.int32, device=rows.device)
    n_rounds = torch.empty(f, dtype=torch.int32, device=rows.device)
    tables = device_table("REC_FAST", rows.device)
    # the longest scans first: they take the most sync rounds
    order = torch.argsort(lens, descending=True, stable=True).to(torch.int32)
    with _build.on_device(rows, lens) as (lib, stream):
        rc = lib.amv_decode_records(
            rows.data_ptr(), rows.shape[1], lens.data_ptr(), order.data_ptr(),
            f, n_blocks, tables.data_ptr(), t, recs.data_ptr(),
            status.data_ptr(), n_rounds.data_ptr(), stream)
    _build.check(rc, "amv_decode_records")
    global RECORD_LAUNCHES
    RECORD_LAUNCHES += 1
    return (recs, status, n_rounds) if rounds else (recs, status)


def decode_records_plain(rows: torch.Tensor, lens: torch.Tensor,
                         n_blocks: int, t_max: int):
    """Plain torch version of kernel R on any device (same outputs): a
    lockstep decoder, one token of every live frame a step."""
    dev = rows.device
    f, stride = rows.shape
    t_rows = record_rows(t_max)
    lut = device_table("RECORD_LUT", dev).long().reshape(-1)
    lens = lens.clamp(0, stride)
    col = torch.arange(stride + 5, device=dev)
    data = torch.zeros((f, stride + 5), dtype=torch.int64, device=dev)
    data[:, :stride] = rows.long()
    data = torch.where(col[None, :] < lens[:, None], data, 0)
    last = stride + 4
    recs = torch.zeros(t_rows * f + 1, dtype=torch.int32, device=dev)
    trash = t_rows * f
    fr = torch.arange(f, device=dev)
    bitpos = torch.zeros(f, dtype=torch.int64, device=dev)
    blk = torch.zeros(f, dtype=torch.int64, device=dev)
    pos = torch.zeros(f, dtype=torch.int64, device=dev)
    nrec = torch.zeros(f, dtype=torch.int64, device=dev)

    def step(t):
        nonlocal bitpos, blk, pos, nrec
        alive = blk < n_blocks
        byte = (bitpos >> 3).clamp(max=last - 4)
        v40 = torch.zeros(f, dtype=torch.int64, device=dev)
        for k in range(5):
            v40 = (v40 << 8) | data[fr, byte + k]
        peek32 = (v40 >> (8 - (bitpos & 7))) & M32
        is_dc = pos == 0
        luma = blk % 6 < 4
        tab = torch.where(is_dc, 0, 2) + torch.where(luma, 0, 1)
        ent = lut[tab * 65536 + (peek32 >> 16)]
        ln, sym = ent & 31, ent >> 5
        size = torch.where(is_dc, sym, sym & 15)
        v = (peek32 >> (32 - ln - size)) & ((1 << size) - 1)
        neg = v < (1 << (size - 1).clamp(min=0))
        level = torch.where(size == 0, 0, torch.where(neg, v - (1 << size) + 1,
                                                      v))
        eob, zrl = sym == 0, sym == 0xF0
        wpos = torch.where(is_dc, 0, pos + (sym >> 4))
        write = is_dc | (~eob & ~zrl & (wpos <= 63))
        newpos = torch.where(is_dc, 1, torch.where(
            eob, 64, torch.where(zrl, pos + 16, wpos + 1)))
        rec = (((level << 16) | (is_dc.long() << 7) | (write.long() << 6)
                | wpos.clamp(max=63)) + 0x80000000) & M32
        recs[torch.where(alive, t * f + fr, trash)] = \
            (rec - 0x80000000).to(torch.int32)
        bitpos = torch.where(alive, bitpos + ln + size, bitpos)
        end = alive & ~is_dc & (newpos >= 64)
        blk = blk + end.long()
        pos = torch.where(end, 0, torch.where(alive, newpos, pos))
        nrec = nrec + alive.long()

    t = 0
    while t < t_rows and bool((blk < n_blocks).any()):
        for _ in range(min(32, t_rows - t)):     # steps between host syncs
            step(t)
            t += 1
    status = torch.stack([blk, nrec], dim=1).to(torch.int32)
    return recs[:trash].view(t_rows, f).t(), status


def expand_records(records: torch.Tensor, counts: torch.Tensor,
                   n_blocks: int) -> torch.Tensor:
    """records int32 [F, T] (kernel R's), counts int32 [F] (the records of
    each frame, R's status[:, 1]) -> levels int16 [F, n_blocks, 64] zigzag,
    slot 0 = DC difference: every record with its write bit set stores its
    level at its block (the is_dc records up to it, minus 1) and slot; the
    rest are 0 (the kernel writes every slot, so the levels start
    uninitialized)."""
    if records.dim() != 2 or records.dtype != torch.int32:
        raise ValueError(f"records must be int32 [F, T], got "
                         f"{records.dtype} {tuple(records.shape)}")
    if counts.shape != records.shape[:1] or counts.dtype != torch.int32:
        raise ValueError(f"counts must be int32 [{records.shape[0]}], got "
                         f"{counts.dtype} {tuple(counts.shape)}")
    if n_blocks <= 0:
        raise ValueError(f"n_blocks must be positive, got {n_blocks}")
    if records.device.type == "cpu" and counts.device.type == "cpu":
        return expand_records_plain(records, counts, n_blocks)
    _build.require_cuda(records, counts)
    f, t = records.shape
    records, counts = records.contiguous(), counts.contiguous()
    levels = torch.empty((f, n_blocks, 64), dtype=torch.int16,
                         device=records.device)
    with _build.on_device(records, counts) as (lib, stream):
        rc = lib.amv_expand_records(
            records.data_ptr(), t, counts.data_ptr(), f, n_blocks,
            levels.data_ptr(), stream)
    _build.check(rc, "amv_expand_records")
    global EXPAND_LAUNCHES
    EXPAND_LAUNCHES += 1
    return levels


def expand_records_plain(records: torch.Tensor, counts: torch.Tensor,
                         n_blocks: int):
    """Plain torch version of kernel X on any device: the block of each
    record is a cumsum of is_dc along its frame (entropy_async_pallas.py:
    518-519), then an index_put."""
    dev = records.device
    f, t = records.shape
    used = torch.arange(t, device=dev)[None, :] < counts.long()[:, None]
    rec = torch.where(used, records.long(), 0)
    bid = torch.cumsum((rec >> 7) & 1, dim=1) - 1
    write = (((rec >> 6) & 1) == 1) & (bid >= 0) & (bid < n_blocks)
    trash = f * n_blocks * 64
    fr = torch.arange(f, device=dev)[:, None]
    idx = torch.where(write, (fr * n_blocks + bid) * 64 + (rec & 63), trash)
    out = torch.zeros(trash + 1, dtype=torch.int16, device=dev)
    out[idx.reshape(-1)] = (rec >> 16).to(torch.int16).reshape(-1)
    return out[:trash].view(f, n_blocks, 64)


def decode_scans_async(rows: torch.Tensor, lens: torch.Tensor,
                       n_blocks: int, t_max: int = 0):
    """rows uint8 [F, stride] unescaped scans, lens int64 [F] -> (levels
    int16 [F, n_blocks, 64] zigzag with slot 0 = DC difference, ok uint8
    [F]) through kernels R and X: JAX's `decode_scans_async` with ok per
    frame (blocks done == n_blocks within record_rows(t_max) records;
    t_max 0 = `default_t_max`).  Levels of a frame that is not ok are
    those its records reached."""
    if t_max == 0:
        t_max = default_t_max(n_blocks, rows.shape[1])
    recs, status = decode_records(rows, lens, n_blocks, t_max)
    levels = expand_records(recs, status[:, 1].contiguous(), n_blocks)
    return levels, (status[:, 0] == n_blocks).to(torch.uint8)


# ---------------------------------------------------------------- encode

def tokenize_levels(lv2: torch.Tensor, t_max: int):
    """lv2 int16 [F, NB, 64] zigzag (slot 0 = absolute DC) -> (records
    int32 [F, t_max] of code << 5 | len, totals int32 [F], block_off int32
    [F, NB + 1], ok bool [F] = totals <= t_max): `tokenize_levels_layout`
    per frame.  Records past a frame's total are 0; a frame over t_max
    keeps its first t_max records."""
    dev = lv2.device
    f, nb = lv2.shape[:2]
    flat = torch.zeros(f * t_max + 1, dtype=torch.int32, device=dev)
    trash = f * t_max
    block_off = torch.zeros((f, nb + 1), dtype=torch.int32, device=dev)
    for a, b in frame_chunks(f, nb):
        code, ln = slot_records(lv2[a:b], wrap_dc16=True)
        site = ln > 0
        rec = (((code << 5) | ln) + 0x80000000) & M32
        del code, ln
        cnt = torch.cumsum(site, dim=2)
        block_off[a:b, 1:] = torch.cumsum(cnt[:, :, 63], dim=1)
        pos = block_off[a:b, :nb, None].long() + cnt - 1
        fr = torch.arange(a, b, device=dev)[:, None, None]
        dst = torch.where(site & (pos < t_max), fr * t_max + pos, trash)
        flat[dst.reshape(-1)] = (rec - 0x80000000).to(torch.int32).reshape(-1)
    totals = block_off[:, nb].contiguous()
    return flat[:trash].view(f, t_max), totals, block_off, totals <= t_max


def _check_levels(lv2):
    if lv2.dim() != 3 or lv2.shape[2] != 64 or lv2.dtype != torch.int16 or \
            lv2.shape[1] % 6:
        raise ValueError(f"levels must be int16 [F, 6k, 64], got "
                         f"{lv2.dtype} {tuple(lv2.shape)}")


def encode_layout_async(lv2: torch.Tensor, w_out: int, t_max: int):
    """lv2 int16 [F, NB, 64] zigzag (slot 0 = absolute DC) -> (words int32
    [F, w_out], bits int32 [F], ok bool [F]): the tokenizer, then kernel P.
    JAX's `encode_layout_async` at segs=1 with ok per frame: ok is the
    record budget alone (totals <= t_max); words past w_out are dropped and
    bits still count them."""
    _check_levels(lv2)
    recs, totals, _, ok = tokenize_levels(lv2, t_max)
    words, bits = pack_records(recs, totals, w_out)
    return words, bits, ok


def encode_scans_async(levels_zz: torch.Tensor, w_out: int = 1024,
                       t_max: int = 0):
    """levels int16 [F, n_mcu, 6, 64] zigzag (slot 0 = absolute DC) ->
    (words int32 [F, w_out'], bits int32 [F], ok bool [F]): JAX's
    `encode_scans_async`, w_out' = w_out rounded up to 128 words, t_max 0 =
    `default_t_max_enc`."""
    f, n_mcu = levels_zz.shape[:2]
    nb = n_mcu * 6
    w_out = max(WIN_O, _pad(w_out, WIN_O))
    if t_max == 0:
        t_max = default_t_max_enc(nb)
    return encode_layout_async(levels_zz.reshape(f, nb, 64), w_out, t_max)
