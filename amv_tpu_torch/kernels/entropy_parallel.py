"""The data-parallel entropy encoders over per-slot Huffman records.

The port of `amv_tpu/kernels/entropy_encode_parallel.py`: `slot_records`
(`_slot_records`), `encode_layout_parallel` and `encode_layout_rechunk`.
Both encoders take re-quantized zigzag levels int16 [F, NB, 64] (slot 0 =
absolute DC, block b luma iff b % 6 < 4) and return (words int32
[F, w_out], bits int32 [F], ok bool [F]) for `native.escape_frames`, ok
per frame where JAX's is one flag for the batch.

* Every block owns 64 token sites: its DC at slot 0, each nonzero AC at
  its own slot, a ZRL at the zero slot 16/32/48 past the previous nonzero,
  the EOB at last_nonzero + 1.  A site's record is a Huffman code with
  its mantissa appended and its length (0 = no token).
* `encode_layout_parallel`: bit offsets are prefix sums of the lengths;
  every record adds its head and tail into the one or two words it spans
  (disjoint bits, so add is or) by a scatter-add.  JAX reduced them
  through three levels of bounded windows (per block `wl` words, per
  group of `grp` blocks `wg` words, per supergroup of `grp2` groups `ws`
  words) because its target has no fast scatter; a record that falls
  outside a window is dropped there and ok is False.  The port keeps the
  windows' results, not their tensors: it drops the same records and
  tests the same windows from the bases arithmetically, so that `ok` and
  the words are JAX's; the `[..., 64, wl]` where-reduce tensors (9 GB at
  4,800 frames) are never made.
* `encode_layout_rechunk`: a block-local pack into `wl` words, re-chunked
  into R = ceil(32 wl / 26) records of 26 bits a block, spliced by kernel
  P (`record_pack.pack_records`).

The TPU tuning parameters that only schedule work (unroll, win_rows, sb)
are not carried; wl, grp, wg, grp2 and ws decide `ok`, so they are.  The
segment wiring (`dc0`, `segs`) is not: one thread per frame has no VMEM
cap.  The slot grid is 64 sites a block (147M at 4,800 frames of 480
blocks), so every function works through the frames in chunks of about
4M sites and keeps its int64 temporaries to tens of MB.
"""

from __future__ import annotations

import torch

from ..codecs.jpeg_tables import device_table
from .entropy_encode import bitlen, dc_differences
from .record_pack import M32, pack_records, word_parts

SITES_PER_CHUNK = 1 << 22
RBITS = 26      # the rechunk records' payload: kernel P appends <= 26 bits
# The words a block can span: a DC token of at most 11 + 16 bits and 63 AC
# tokens of at most 16 + 16 (any int16 levels), from any bit of a word:
# ceil((31 + 2043) / 32).  Windows of this size never overflow.
WL_MAX = 65
# encode_layout_parallel's windows for any input at JAX's group sizes: a
# block WL_MAX words, a group 8 blocks of them, a supergroup 6 groups (a
# block starts at most one word past the sum of the words before it)
FITTING_WINDOWS = {"wl": WL_MAX, "grp": 8, "wg": 8 * WL_MAX, "grp2": 6,
                   "ws": 48 * WL_MAX}


def frame_chunks(n_frames: int, n_blocks: int):
    """(start, stop) frame ranges of about SITES_PER_CHUNK slot sites."""
    step = max(1, SITES_PER_CHUNK // (64 * n_blocks))
    return [(a, min(a + step, n_frames)) for a in range(0, n_frames, step)]


def slot_records(lv: torch.Tensor, wrap_dc16: bool = False):
    """Levels int16 [F, NB, 64] zigzag (slot 0 = absolute DC) -> per-slot
    (code int64, ln int64), both [F, NB, 64]; ln 0 = no token at the slot.

    code is the Huffman code with the mantissa appended, as the 32 bits
    JAX's int32 arithmetic leaves (masked with 0xFFFFFFFF).  wrap_dc16
    wraps the DC differences to int16 first, as the record tokenizer
    (`tokenize_levels_layout`) stores them in 16 bits."""
    dev = lv.device
    f, nb = lv.shape[:2]
    tab = device_table("ENC_TABLES", dev).long()
    code_t, size_t = tab[0].reshape(-1), tab[1].reshape(-1)
    v = lv.long()
    dcd = dc_differences(lv)
    if wrap_dc16:
        dcd = ((dcd + 0x8000) & 0xFFFF) - 0x8000
    k = torch.arange(64, device=dev)
    nz = (v != 0) & (k > 0)
    pn_inc = torch.cummax(torch.where(nz, k, 0), dim=2).values
    lastnz = pn_inc[:, :, 63:]
    d = k - torch.cat([torch.zeros_like(pn_inc[:, :, :1]),
                       pn_inc[:, :, :-1]], dim=2) - 1     # zeros before k
    del pn_inc
    is_dc = k == 0
    is_zrl = ~nz & (k > 0) & (((d + 1) & 15) == 0) & (k < lastnz)
    is_eob = k == lastnz + 1
    val = torch.where(is_dc, dcd[:, :, None], torch.where(nz, v, 0))
    del v, dcd
    nbv = bitlen(val.abs())
    mant = torch.where(val < 0, val - 1, val) & ((1 << nbv) - 1)
    del val
    luma = (torch.arange(nb, device=dev) % 6 < 4)[None, :, None]
    dct = torch.where(luma, 0, 256)             # ENC_TABLES row: DC-L, DC-C
    act = torch.where(luma, 512, 768)           #                 AC-L, AC-C
    sym = torch.where(is_dc, dct + nbv.clamp(max=11),
                      act + (((d & 15) << 4) | nbv.clamp(max=10)))
    code = torch.where(nz | is_dc, (code_t[sym] << nbv) | mant, 0)
    ln = torch.where(nz | is_dc, size_t[sym] + nbv, 0)
    del sym, mant, nbv
    for marker, s in ((is_zrl, 0xF0), (is_eob, 0)):
        code = torch.where(marker, code_t[act + s], code)
        ln = torch.where(marker, size_t[act + s], ln)
    return code & M32, ln


def encode_layout_parallel(lv: torch.Tensor, w_out: int, wl: int = 16,
                           grp: int = 8, wg: int = 64, grp2: int = 6,
                           ws: int = 256):
    """lv int16 [F, NB, 64] zigzag (slot 0 = absolute DC) -> (words int32
    [F, w_out], bits int32 [F], ok bool [F]), JAX's
    `encode_layout_parallel` per frame: ok False where a block overflows
    its wl-word window, a group its wg, a supergroup its ws, or the frame
    w_out words; the records outside a window are dropped, as in JAX."""
    dev = lv.device
    f, nb = lv.shape[:2]
    words = torch.empty((f, w_out), dtype=torch.int32, device=dev)
    bits = torch.empty(f, dtype=torch.int32, device=dev)
    ok = torch.empty(f, dtype=torch.bool, device=dev)
    blk = torch.arange(nb, device=dev)
    ng = -(-nb // grp)
    for a, b in frame_chunks(f, nb):
        c = b - a
        code, ln = slot_records(lv[a:b])
        cum = torch.cumsum(ln, dim=2)
        bbits = cum[:, :, 63]
        base = torch.cumsum(bbits, dim=1) - bbits        # exclusive, bits
        total = base[:, -1] + bbits[:, -1]
        base_w = base >> 5
        gbase_w = base_w[:, ::grp]                       # [c, NG]
        db = base_w - gbase_w[:, blk // grp]             # words into group
        sbase_w = gbase_w[:, ::grp2]
        dg = gbase_w - sbase_w[:, torch.arange(ng, device=dev) // grp2]
        ok[a:b] = (((base & 31) + bbits <= 32 * wl).all(1)
                   & (db + wl <= wg).all(1) & (dg + wg <= ws).all(1)
                   & ((total + 31) >> 5 <= w_out))
        start = base[:, :, None] + cum - ln              # global bit offset
        del cum
        c0, c1 = word_parts(code, ln, start)
        del code
        li = (start >> 5) - base_w[:, :, None]           # word in block
        # a word reaches the frame through the block, group and supergroup
        # windows: li < wl, db + li < wg, dg + db + li < ws, base_w + li <
        # w_out
        sg = (db + dg[:, blk // grp])[:, :, None]
        acc = torch.zeros((c, w_out + 1), dtype=torch.int64, device=dev)
        for j, ck in ((li, c0), (li + 1, c1)):
            keep = ((ln > 0) & (j < wl) & (db[:, :, None] + j < wg)
                    & (sg + j < ws) & (base_w[:, :, None] + j < w_out))
            idx = torch.where(keep, base_w[:, :, None] + j, w_out)
            acc.scatter_add_(1, idx.reshape(c, -1),
                             torch.where(keep, ck, 0).reshape(c, -1))
        words[a:b] = (((acc[:, :w_out] + 0x80000000) & M32)
                      - 0x80000000).to(torch.int32)
        bits[a:b] = total.to(torch.int32)
    return words, bits, ok


def rechunk_records(lv: torch.Tensor, wl: int | None = 16):
    """lv int16 [F, NB, 64] -> (records int32 [F, NB * R] of 26-bit pieces
    of each block's bitstream, R = ceil(32 wl / 26) a block, zero-length
    pads after a block's last piece; ok bool [F]: every block fits wl
    words).  A block that overflows keeps its first wl words, as in JAX.
    wl=None takes the batch's longest block, so that none overflows."""
    dev = lv.device
    f, nb = lv.shape[:2]
    width = max(wl or 0, WL_MAX) + 1
    bw = torch.empty((f, nb, width), dtype=torch.int32, device=dev)
    bbits = torch.empty((f, nb), dtype=torch.int64, device=dev)
    for a, b in frame_chunks(f, nb):
        code, ln = slot_records(lv[a:b])
        cum = torch.cumsum(ln, dim=2)
        bbits[a:b] = cum[:, :, 63]
        start = cum - ln                                 # bit in block
        del cum
        c0, c1 = word_parts(code, ln, start)
        del code
        li = start >> 5
        acc = torch.zeros(((b - a) * nb, width), dtype=torch.int64,
                          device=dev)
        for j, ck in ((li, c0), (li + 1, c1)):
            keep = (ln > 0) & (j < width)
            acc.scatter_add_(1, torch.where(keep, j, 0).reshape(-1, 64),
                             torch.where(keep, ck, 0).reshape(-1, 64))
        bw[a:b] = (((acc + 0x80000000) & M32) - 0x80000000).to(
            torch.int32).view(b - a, nb, width)
    if wl is None:
        wl = max(1, (int(bbits.max()) + 31) // 32) if bbits.numel() else 1
    ok = (bbits <= 32 * wl).all(1)
    r = -(-(32 * wl) // RBITS)
    o = RBITS * torch.arange(r, device=dev)
    i, sh = o >> 5, o & 31
    recs = torch.empty((f, nb * r), dtype=torch.int32, device=dev)
    for a, b in frame_chunks(f, nb):
        # the block-local words; a block's words past wl are dropped, as
        # JAX's window drops them, and the word after the last reads 0
        w = bw[a:b, :, :wl + 1].long() & M32
        w[:, :, wl] = 0
        field = (((w[:, :, i] << sh) & M32) | (w[:, :, i + 1] >> (32 - sh))) \
            >> (32 - RBITS)                              # [c, nb, r]
        n = (bbits[a:b, :, None] - o).clamp(0, RBITS)
        val = torch.where(n > 0, field >> (RBITS - n.clamp(min=1)), 0)
        recs[a:b] = ((val << 5) | n).reshape(b - a, nb * r).to(torch.int32)
    return recs, ok


def encode_layout_rechunk(lv: torch.Tensor, w_out: int,
                          wl: int | None = 16):
    """lv int16 [F, NB, 64] zigzag (slot 0 = absolute DC) -> (words int32
    [F, w_out], bits int32 [F], ok bool [F]), JAX's
    `encode_layout_rechunk` per frame: a block-local pack, 26-bit records
    and kernel P; ok False where a block overflows wl words or the frame
    w_out words.  wl=None: the batch's longest block (`rechunk_records`)."""
    recs, ok = rechunk_records(lv, wl)
    totals = torch.full((lv.shape[0],), recs.shape[1], dtype=torch.int32,
                        device=lv.device)
    words, bits = pack_records(recs, totals, w_out)
    return words, bits, ok & ((bits.long() + 31) >> 5 <= w_out)
