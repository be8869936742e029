"""Progressive JPEG (SOF2) coefficient codec: the port's copy of
`amv_tpu/bitstream/jpeg_progressive.py`.

The full progressive-DCT Huffman mode per ITU T.81 G.1.2 / G.2 and
libjpeg's jdphuff.c semantics: multi-scan spectral selection (Ss..Se)
with successive approximation (Ah/Al), DC-interleaved and
AC-non-interleaved scans, EOBn run codes, and refinement correction bits
(the vendored reference's `mjpegdec.c:432 decode_block_progressive`
covers only the first-scan, Ah == 0, subset).  The scans decode on the
host: `native.progressive_frame` (`native/entropy.c:
amv_progressive_frame`) runs every scan of a frame in one ctypes call,
which drops the GIL, against a plan prepacked once a header
(`_PLAN_CACHE`); when it fails, the Python scan loop below restarts from
clean state and reports the precise position.  `decode_progressive(data,
native=False)` runs the Python loop alone: the plain version.  The
levels feed the device dequant (absolute DC) and kernel I, as the
baseline frames' do (`codecs/mjpeg.py`).

`encode_progressive` is the matching minimal encoder: the reference never
encodes progressive, and decode(encode(levels)) == levels exactly (the
format reorganizes the quantized coefficients losslessly).  Its bytes are
the JAX package's.
"""

from __future__ import annotations

import struct
import threading

import numpy as np

from ..codecs import jpeg_tables as T
from ..native import ProgressivePlan, progressive_frame
from ..verify import ref_jpeg as R
from .jpeg_parse import JpegFrame

# progressive AC tables must hold the EOBn symbols (r << 4 for r = 1..14),
# which the baseline K.3 tables lack: encode_progressive uses a flat 8-bit
# canonical table over every symbol a progressive AC scan can emit
AC_VALS = np.array([(r << 4) | s for r in range(16) for s in range(1, 11)] +
                   [r << 4 for r in range(15)] + [0xF0], np.int32)
AC_BITS = np.zeros(17, np.int32)
AC_BITS[8] = len(AC_VALS)

_CACHE_LOCK = threading.Lock()   # frames decode on several host threads


def _comp_grids(frame):
    """Per component: (blocks_wide, blocks_high) of the NON-interleaved
    block grid (ceil of the scaled component size / 8 — T.81 A.1.1;
    unlike the MCU-interleaved grid, no MCU padding)."""
    hmax = max(c[1] for c in frame.components)
    vmax = max(c[2] for c in frame.components)
    grids = []
    for (_, h, v, _) in frame.components:
        cw = (frame.width * h + hmax - 1) // hmax
        ch = (frame.height * v + vmax - 1) // vmax
        grids.append(((cw + 7) // 8, (ch + 7) // 8))
    return grids


def _mcu_grid(frame):
    hmax = max(c[1] for c in frame.components)
    vmax = max(c[2] for c in frame.components)
    mb_w = (frame.width + 8 * hmax - 1) // (8 * hmax)
    mb_h = (frame.height + 8 * vmax - 1) // (8 * vmax)
    return mb_w, mb_h, hmax, vmax


_MAPS_CACHE = {}


def _block_index_maps(frame):
    """For each component: array mapping component-raster block index ->
    (mcu_index, slot) in the interleaved [M, nb, 64] layout used by the
    rest of the pipeline (slot order: comp0's h*v blocks, comp1's, ...).
    Component blocks beyond the component grid exist only in the MCU
    layout (padding) and are never coded by non-interleaved scans.
    Cached by geometry: batch ingest decodes many same-shaped frames."""
    key = (frame.width, frame.height, tuple(frame.components))
    hit = _MAPS_CACHE.get(key)
    if hit is not None:
        return hit
    mb_w, mb_h, _, _ = _mcu_grid(frame)
    maps = []
    slot0 = 0
    for ci, (_, h, v, _) in enumerate(frame.components):
        bw, bh = _comp_grids(frame)[ci]
        m = np.full((bh, bw, 2), -1, np.int64)
        for by in range(bh):
            for bx in range(bw):
                mx, sx = bx // h, bx % h
                my, sy = by // v, by % v
                if mx >= mb_w or my >= mb_h:
                    continue
                m[by, bx, 0] = my * mb_w + mx
                m[by, bx, 1] = slot0 + sy * h + sx
        maps.append(m)
        slot0 += h * v
    with _CACHE_LOCK:
        if len(_MAPS_CACHE) > 64:
            _MAPS_CACHE.clear()
        _MAPS_CACHE[key] = maps
    return maps


class _Scans:
    """Parse all scans of a progressive JPEG (the baseline parser in
    jpeg_parse.py stops at the first SOS).

    Each scan tuple carries a SNAPSHOT of the Huffman table set and
    restart interval in effect at its SOS: libjpeg/mozjpeg optimized
    output redefines table ids 0/1 before each scan, so applying the
    final definitions to every scan (the obvious single-dict parse)
    decodes earlier scans with the wrong tables."""

    def __init__(self, data: bytes):
        f = JpegFrame()
        if data[0:2] != b"\xFF\xD8":
            raise ValueError("missing SOI")
        pos, n = 2, len(data)
        # (scan_components, Ss, Se, Ah, Al, scan_bytes, huff_snapshot,
        #  restart_interval)
        self.scans = []
        # concatenated header segments (DQT/DHT/SOF/DRI/SOS params, in
        # order, scan data excluded): same key == same decode plan
        key_parts = []
        while pos + 4 <= n:
            if data[pos] != 0xFF:
                pos += 1
                continue
            marker = data[pos + 1]
            if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
                pos += 2
                continue
            if marker == 0xD9:
                break
            seglen = struct.unpack_from(">H", data, pos + 2)[0]
            body = data[pos + 4:pos + 2 + seglen]
            if marker in (0xDB, 0xC4, 0xC2, 0xDD, 0xDA):
                key_parts.append(data[pos:pos + 2 + seglen])
            if marker == 0xDB:
                b = 0
                while b < len(body):
                    pq, tq = body[b] >> 4, body[b] & 0xF
                    b += 1
                    if pq:
                        f.quant[tq] = np.frombuffer(
                            body[b:b + 128], ">u2").astype(np.int32)
                        b += 128
                    else:
                        f.quant[tq] = np.frombuffer(
                            body[b:b + 64], np.uint8).astype(np.int32)
                        b += 64
            elif marker == 0xC4:
                b = 0
                while b < len(body):
                    tc, th = body[b] >> 4, body[b] & 0xF
                    bits = np.zeros(17, np.int32)
                    bits[1:] = np.frombuffer(body[b + 1:b + 17], np.uint8)
                    nv = int(bits.sum())
                    vals = np.frombuffer(body[b + 17:b + 17 + nv],
                                         np.uint8).astype(np.int32)
                    f.huff[(tc, th)] = (bits, vals)
                    b += 17 + nv
            elif marker == 0xC2:  # SOF2 progressive
                f.height, f.width = struct.unpack_from(">HH", body, 1)
                nc = body[5]
                for c in range(nc):
                    cid, hv, tq = body[6 + 3 * c:9 + 3 * c]
                    f.components.append((cid, hv >> 4, hv & 0xF, tq))
            elif marker == 0xC0:
                raise ValueError("baseline SOF0 in progressive parser")
            elif marker == 0xDD:
                f.restart_interval = struct.unpack_from(">H", body, 0)[0]
            elif marker == 0xDA:
                ns = body[0]
                comps = []
                for c in range(ns):
                    cs, tt = body[1 + 2 * c:3 + 2 * c]
                    idx = next(i for i, comp in enumerate(f.components)
                               if comp[0] == cs)
                    comps.append((idx, tt >> 4, tt & 0xF))
                ss, se, ahal = body[1 + 2 * ns:4 + 2 * ns]
                ah, al = ahal >> 4, ahal & 0xF
                # T.81 B.2.3: Ss/Se index the 64-entry zigzag block,
                # Ah/Al are successive-approximation bit positions
                # <= 13; AC scans are single-component.  (Fuzz-found:
                # Ss=246 walked the C decoder past the block.)
                if not (0 <= ss <= 63 and ss <= se <= 63
                        and ah <= 13 and al <= 13):
                    raise ValueError(
                        f"invalid SOS spectral params Ss={ss} Se={se} "
                        f"Ah={ah} Al={al}")
                if ss > 0 and ns != 1:
                    raise ValueError("progressive AC scan with ns != 1")
                # scan data runs to the next non-RST marker (find()
                # jumps FF to FF instead of walking every byte)
                sp = pos + 2 + seglen
                ep = sp
                while True:
                    idx = data.find(b"\xFF", ep)
                    if idx < 0 or idx + 1 >= n:
                        ep = max(n - 1, sp)
                        break
                    if data[idx + 1] != 0 and not \
                            (0xD0 <= data[idx + 1] <= 0xD7):
                        ep = idx
                        break
                    ep = idx + 1
                self.scans.append((comps, ss, se, ahal >> 4, ahal & 0xF,
                                   data[sp:ep], dict(f.huff),
                                   f.restart_interval))
                pos = ep
                continue
            pos += 2 + seglen
        self.frame = f
        self.plan_key = b"".join(key_parts)
        if not f.components or not self.scans:
            raise ValueError("no progressive scans found")


def _scan_arrays(f, maps, grids, slot_base, M, nb,
                 comps, ss, se, huff):
    """Flatten one scan's block visit order (and per-block table /
    predictor slots) into the index arrays the C entropy pass consumes
    (blk, tabsel, cisel, bpu, htabs).  Semantics are the Python scan
    loop's, 1:1."""
    slots = []

    def slot_of(tc, tid):
        key = (tc, tid)
        if key not in slots:
            slots.append(key)
        return slots.index(key)

    if ss == 0:
        interleaved = len(comps) > 1 or len(f.components) == 1
        if interleaved:
            offs, tsel, csel = [], [], []
            for j, (ci, dc_id, _) in enumerate(comps):
                _, h, v, _ = f.components[ci]
                for k in range(h * v):
                    offs.append(slot_base[ci] + k)
                    tsel.append(slot_of(0, dc_id))
                    csel.append(j)
            bpu = len(offs)
            blk = (np.arange(M, dtype=np.int64)[:, None] * nb +
                   np.asarray(offs, np.int64)[None, :]).reshape(-1)
        else:
            ci, dc_id, _ = comps[0]
            bw, bh = grids[ci]
            m = maps[ci].reshape(-1, 2)
            blk = np.where(m[:, 0] >= 0, m[:, 0] * nb + m[:, 1], -1)
            tsel, csel, bpu = [slot_of(0, dc_id)], [0], 1
    else:
        assert len(comps) == 1, "AC scans are non-interleaved (T.81)"
        ci, _, ac_id = comps[0]
        m = maps[ci].reshape(-1, 2)
        blk = np.where(m[:, 0] >= 0, m[:, 0] * nb + m[:, 1], -1)
        tsel, csel, bpu = [slot_of(1, ac_id)], [0], 1
    htabs = np.zeros((4, 273), np.uint8)
    for i, key in enumerate(slots):
        bits, vals = huff[key]
        htabs[i, :17] = bits.astype(np.uint8)
        htabs[i, 17:17 + len(vals)] = vals.astype(np.uint8)
    return (np.asarray(blk, np.int64), np.asarray(tsel, np.uint8),
            np.asarray(csel, np.uint8), bpu, htabs)


# prepacked decode plans keyed by the frame's header bytes: a stream of
# same-header frames (the normal MJPEG case) packs its block maps /
# table snapshots once (small LRU-ish cap; keys are ~1 KB)
_PLAN_CACHE = {}
_PLAN_CACHE_MAX = 16


def _frame_plan(f, M, nb, scans):
    """Build the prepacked amv_progressive_frame plan for one header
    (block visit orders, table selectors, Huffman snapshots, scan
    parameter rows) — everything except the scan bytes themselves."""
    maps = _block_index_maps(f)
    grids = _comp_grids(f)
    slot_base = np.cumsum([0] + [h * v for (_, h, v, _) in f.components])
    blks, tsels, csels, htabs_l, metas = [], [], [], [], []
    for comps, ss, se, ah, al, scan, huff, ri in scans:
        blk, tsel, csel, bpu, htabs = _scan_arrays(
            f, maps, grids, slot_base, M, nb, comps, ss, se, huff)
        blks.append(blk)
        tsels.append(tsel)
        csels.append(csel)
        htabs_l.append(htabs)
        metas.append((ss, se, ah, al, ri, bpu))
    return ProgressivePlan(blks, tsels, csels, htabs_l, metas)


def _frame_native(coef_flat, f, M, nb, scans, plan_key):
    """Decode every scan of one frame in a single C call
    (native/entropy.c:amv_progressive_frame) — the per-scan ctypes
    crossing was ~0.15 ms against ~10 us of C entropy work."""
    plan = _PLAN_CACHE.get(plan_key)
    if plan is None or plan.n != len(scans):
        plan = _frame_plan(f, M, nb, scans)
        with _CACHE_LOCK:
            if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
                _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
            _PLAN_CACHE[plan_key] = plan
    progressive_frame([bytes(s[5]) for s in scans], coef_flat, plan)


def decode_progressive(data: bytes, native: bool = True):
    """Decode a progressive JPEG to (levels int16 [M, nb, 64] zigzag with
    slot 0 the absolute quantized DC, frame), `amv_tpu.bitstream.
    jpeg_progressive.decode_progressive`'s.  The C pass runs first unless
    native=False; when it fails, the Python scan loop restarts from clean
    state (and raises where the frame is malformed)."""
    return decode_scans(_Scans(data), native)


def parse_scans(data: bytes) -> _Scans:
    """The frame header and every scan of a progressive JPEG (raises on a
    malformed header), for `decode_scans`."""
    return _Scans(data)


def decode_scans(ps: _Scans, native: bool = True):
    """`decode_progressive` of a frame `parse_scans` has parsed."""
    f = ps.frame
    mb_w, mb_h, _, _ = _mcu_grid(f)
    nb = sum(h * v for (_, h, v, _) in f.components)
    M = mb_w * mb_h
    coef = np.zeros((M, nb, 64), np.int32)
    table_cache = {}  # keyed by table CONTENT: redefinitions miss
    coef_flat = coef.reshape(M * nb, 64)
    if native:
        # the whole frame's scan loop in one C call, the plan cached per
        # header; a header the plan cannot pack (a missing table, more
        # than 4 tables or 16 blocks a unit) or a scan the C rejects goes
        # to the Python loop, which decodes it or raises at the precise
        # position
        try:
            _frame_native(coef_flat, f, M, nb, ps.scans, ps.plan_key)
            return coef.astype(np.int16), f
        except (KeyError, IndexError, ValueError):
            coef[...] = 0

    maps = _block_index_maps(f)
    grids = _comp_grids(f)
    slot_base = np.cumsum([0] + [h * v for (_, h, v, _) in f.components])
    for comps, ss, se, ah, al, scan, huff, ri in ps.scans:
        def lut(tc, tid, _huff=huff):
            bits, vals = _huff[(tc, tid)]
            key = (bits.tobytes(), vals.tobytes())
            if key not in table_cache:
                table_cache[key] = T.build_decode_table(bits, vals)
            return table_cache[key]

        br = R.BitReader(R.unescape_scan(scan))
        if ss == 0:
            # ---- DC scan (interleaved over `comps` or single) -------
            pred = {ci: 0 for ci, _, _ in comps}
            if len(comps) > 1 or len(f.components) == 1:
                units = M  # MCU-interleaved
            else:
                ci = comps[0][0]
                units = grids[ci][0] * grids[ci][1]
            cnt = 0
            for u in range(units):
                if ri and u and u % ri == 0:
                    br.pos = (br.pos + 7) & ~7
                    mk = br.get_bits(16)
                    if mk & 0xFFF8 != 0xFFD0:
                        raise ValueError("bad RST in DC scan")
                    pred = {ci: 0 for ci, _, _ in comps}
                for ci, dc_id, _ in comps:
                    _, h, v, _ = f.components[ci]
                    blocks = ([(u, k) for k in range(h * v)]
                              if len(comps) > 1 or len(f.components) == 1
                              else None)
                    if blocks is None:
                        bw = grids[ci][0]
                        by, bx = divmod(u, bw)
                        tgt = maps[ci][by, bx]
                        blocks = [None]
                    for k, blk in enumerate(blocks):
                        if ah == 0:
                            sym = R._read_vlc(br, lut(0, dc_id))
                            diff = br.get_xbits(sym) if sym else 0
                            pred[ci] += diff
                            val = pred[ci] << al
                        else:
                            val = br.get_bits(1) << al
                        if blk is not None:
                            m, s = u, slot_base[ci] + k
                        else:
                            m, s = int(tgt[0]), int(tgt[1])
                            if m < 0:
                                continue
                        if ah == 0:
                            coef[m, s, 0] = val
                        else:
                            coef[m, s, 0] |= val
                cnt += 1
        else:
            # ---- AC scan: single component, component raster order --
            assert len(comps) == 1, "AC scans are non-interleaved (T.81)"
            ci, _, ac_id = comps[0]
            bw, bh = grids[ci]
            tab = lut(1, ac_id)
            eobrun = 0
            for u in range(bw * bh):
                if ri and u and u % ri == 0:
                    br.pos = (br.pos + 7) & ~7
                    mk = br.get_bits(16)
                    if mk & 0xFFF8 != 0xFFD0:
                        raise ValueError("bad RST in AC scan")
                    eobrun = 0
                by, bx = divmod(u, bw)
                m, s = int(maps[ci][by, bx, 0]), int(maps[ci][by, bx, 1])
                blk = coef[m, s] if m >= 0 else np.zeros(64, np.int32)
                if ah == 0:
                    # first AC scan for this band
                    if eobrun > 0:
                        eobrun -= 1
                    else:
                        k = ss
                        while k <= se:
                            rs = R._read_vlc(br, tab)
                            r, sz = rs >> 4, rs & 0xF
                            if sz == 0:
                                if r == 15:
                                    k += 16
                                    continue
                                eobrun = (1 << r) - 1
                                if r:
                                    eobrun += br.get_bits(r)
                                break
                            k += r
                            if k > se:
                                raise ValueError("AC index overflow")
                            blk[k] = br.get_xbits(sz) << al
                            k += 1
                else:
                    # AC refinement (T.81 G.2 / mjpegdec's
                    # decode_block_refinement semantics)
                    p1 = 1 << al
                    m1 = -1 << al
                    k = ss

                    def refine_tail(k):
                        # consume correction bits of the remaining
                        # nonzero-history coefficients in this block
                        while k <= se:
                            if blk[k] != 0:
                                if br.get_bits(1):
                                    if (blk[k] & p1) == 0:
                                        blk[k] += (p1 if blk[k] > 0 else m1)
                            k += 1

                    if eobrun > 0:
                        # a block fully inside a pending EOB run: its
                        # nonzero-history bits ride with the run
                        eobrun -= 1
                        refine_tail(ss)
                        continue
                    hit_eob = False
                    while k <= se:
                        rs = R._read_vlc(br, tab)
                        r, sz = rs >> 4, rs & 0xF
                        insert = 0
                        if sz == 0:
                            if r < 15:
                                eobrun = (1 << r) - 1
                                if r:
                                    eobrun += br.get_bits(r)
                                hit_eob = True
                                break
                            # r == 15: skip 16 zero-history coeffs
                        else:
                            if sz != 1:
                                raise ValueError("bad refinement size")
                            insert = p1 if br.get_bits(1) else m1
                        # advance over r zero-history coeffs,
                        # refining nonzero-history ones en route
                        while k <= se:
                            if blk[k] != 0:
                                if br.get_bits(1):
                                    if (blk[k] & p1) == 0:
                                        blk[k] += (p1 if blk[k] > 0
                                                   else m1)
                            else:
                                if r == 0:
                                    if insert:
                                        blk[k] = insert
                                    k += 1
                                    break
                                r -= 1
                            k += 1
                    if hit_eob:
                        # the EOB covers the rest of THIS block too: its
                        # remaining nonzero-history bits follow the run
                        # length (the run count excludes this block)
                        refine_tail(k)
    return coef.astype(np.int16), f


# ---------------------------------------------------------------------------
# Minimal progressive encoder (round-trip gate for the decoder)
# ---------------------------------------------------------------------------

def _put_vlc(bw, table, sym):
    sizes, codes = table
    bw.put_bits(int(sizes[sym]), int(codes[sym]))


def encode_progressive(levels_zz: np.ndarray, frame_wh, layout: str = "420",
                       al_dc: int = 1, al_ac: int = 1) -> bytes:
    """Encode zigzag levels [M, nb, 64] (slot 0 = ABSOLUTE quantized DC)
    as a progressive JPEG with the K.3 tables and the AMV quant matrix:
    DC-first (Al=al_dc) + DC-refine scans, then per component AC-first
    (1..5 and 6..63 bands, Al=al_ac) + AC-refine scans.  Exercises
    spectral selection, successive approximation, EOBn runs and
    refinement bits — everything decode_progressive handles."""
    from ..codecs.mjpeg import COMP_OF_BLOCK

    W, H = frame_wh
    comp_of = COMP_OF_BLOCK[layout]
    nb = len(comp_of)
    M = levels_zz.shape[0]
    qm_zz = T.encoder_quant_matrix(2)[T.ZIGZAG]
    dc_l = T.build_huffman_codes(T.BITS_DC_LUMA, T.VALS_DC_LUMA)
    dc_c = T.build_huffman_codes(T.BITS_DC_CHROMA, T.VALS_DC_CHROMA)
    ac_l = ac_c = T.build_huffman_codes(AC_BITS, AC_VALS)

    out = bytearray(b"\xFF\xD8")
    out += b"\xFF\xDB" + (67).to_bytes(2, "big") + b"\x00"
    out += bytes(np.clip(qm_zz, 1, 255).astype(np.uint8))
    dht = bytearray()
    for tclass, tid, bits, vals in (
            (0, 0, T.BITS_DC_LUMA, T.VALS_DC_LUMA),
            (0, 1, T.BITS_DC_CHROMA, T.VALS_DC_CHROMA),
            (1, 0, AC_BITS, AC_VALS),
            (1, 1, AC_BITS, AC_VALS)):
        dht.append((tclass << 4) | tid)
        dht += bytes(np.asarray(bits)[1:].astype(np.uint8))
        dht += bytes(np.asarray(vals).astype(np.uint8))
    out += b"\xFF\xC4" + (len(dht) + 2).to_bytes(2, "big") + dht
    samp = {"420": 0x22, "422": 0x21, "444": 0x11, "gray": 0x11}[layout]
    ncomp = 1 if layout == "gray" else 3
    out += b"\xFF\xC2" + (8 + 3 * ncomp).to_bytes(2, "big") + b"\x08"
    out += int(H).to_bytes(2, "big") + int(W).to_bytes(2, "big")
    out += bytes([ncomp, 1, samp, 0])
    if ncomp == 3:
        out += bytes([2, 0x11, 0, 3, 0x11, 0])

    # fake a frame object for the grid helpers
    class _F:
        pass
    f = _F()
    f.width, f.height = W, H
    f.components = [(1, samp >> 4, samp & 0xF, 0)] + \
        ([(2, 1, 1, 0), (3, 1, 1, 0)] if ncomp == 3 else [])
    grids = _comp_grids(f)
    maps = _block_index_maps(f)
    slot_base = np.cumsum([0] + [h * v for (_, h, v, _) in f.components])
    lv = levels_zz.astype(np.int32)

    def sos(comps, ss, se, ah, al, scan_bytes):
        o = bytearray(b"\xFF\xDA")
        body = bytes([len(comps)])
        for ci, dc_id, ac_id in comps:
            body += bytes([f.components[ci][0], (dc_id << 4) | ac_id])
        body += bytes([ss, se, (ah << 4) | al])
        o += (2 + len(body)).to_bytes(2, "big") + body
        o += R.escape_ff(scan_bytes)
        return o

    def flushed(bw):
        pad = (-bw.bit_count()) & 7
        if pad:
            bw.put_bits(pad, (1 << pad) - 1)
        return bw.flush()

    # ---- DC first scan (interleaved), Al = al_dc -----------------------
    bw = R.BitWriter()
    pred = [0] * ncomp
    for m in range(M):
        for s in range(nb):
            ci = comp_of[s]
            v = int(lv[m, s, 0]) >> al_dc
            diff = v - pred[ci]
            pred[ci] = v
            t = dc_l if ci == 0 else dc_c
            mag = abs(diff)
            nbits = mag.bit_length()
            _put_vlc(bw, t, nbits)
            if nbits:
                mant = diff if diff > 0 else diff - 1
                bw.put_bits(nbits, mant & ((1 << nbits) - 1))
    out += sos([(ci, 0 if ci == 0 else 1, 0) for ci in range(ncomp)],
               0, 0, 0, al_dc, flushed(bw))

    # ---- DC refinement scans down to Al = 0 -----------------------------
    for al in range(al_dc - 1, -1, -1):
        bw = R.BitWriter()
        for m in range(M):
            for s in range(nb):
                bw.put_bits(1, (int(lv[m, s, 0]) >> al) & 1)
        out += sos([(ci, 0 if ci == 0 else 1, 0) for ci in range(ncomp)],
                   0, 0, al + 1, al, flushed(bw))

    # ---- AC scans per component: bands (1..5), (6..63) ------------------
    def comp_blocks(ci):
        bw_, bh_ = grids[ci]
        for u in range(bw_ * bh_):
            by, bx = divmod(u, bw_)
            m, s = int(maps[ci][by, bx, 0]), int(maps[ci][by, bx, 1])
            yield (lv[m, s] if m >= 0 else np.zeros(64, np.int32))

    for ci in range(ncomp):
        act = ac_l if ci == 0 else ac_c
        for (ss, se) in ((1, 5), (6, 63)):
            # first scan at Al = al_ac
            bw = R.BitWriter()
            eobrun = 0
            pend = []

            def flush_eob():
                nonlocal eobrun
                while eobrun > 0:
                    r = min(14, eobrun.bit_length() - 1)
                    take = min(eobrun, (1 << (r + 1)) - 1)
                    r = take.bit_length() - 1
                    _put_vlc(bw, act, r << 4)
                    if r:
                        bw.put_bits(r, take - (1 << r))
                    eobrun -= take

            def pt(v, a):
                # AC point transform is a signed-magnitude shift
                # (T.81 G.1.2.2; libjpeg jcphuff), unlike DC's
                # arithmetic shift
                return -((-v) >> a) if v < 0 else v >> a

            for blk in comp_blocks(ci):
                band = [pt(int(blk[k]), al_ac) for k in range(ss, se + 1)]
                if not any(band):
                    eobrun += 1
                    if eobrun == 0x7FFF:
                        flush_eob()
                    continue
                flush_eob()
                run = 0
                last_nz = max(i for i, v in enumerate(band) if v)
                for i, v in enumerate(band):
                    if i > last_nz:
                        break
                    if v == 0:
                        run += 1
                        continue
                    while run >= 16:
                        _put_vlc(bw, act, 0xF0)
                        run -= 16
                    mag = abs(v)
                    nbits = mag.bit_length()
                    _put_vlc(bw, act, (run << 4) | nbits)
                    mant = v if v > 0 else v - 1
                    bw.put_bits(nbits, mant & ((1 << nbits) - 1))
                    run = 0
                if last_nz < len(band) - 1:
                    eobrun += 1
            flush_eob()
            out += sos([(ci, 0, 0 if ci == 0 else 1)], ss, se, 0, al_ac,
                       flushed(bw))

        # refinement scans down to Al = 0
        for al in range(al_ac - 1, -1, -1):
            for (ss, se) in ((1, 5), (6, 63)):
                bw = R.BitWriter()
                eobrun = 0
                eob_refine = []  # correction bits owed with the EOB run

                def flush_eob_r():
                    nonlocal eobrun, eob_refine
                    while eobrun > 0:
                        r = eobrun.bit_length() - 1
                        take = min(eobrun, (1 << (r + 1)) - 1)
                        r = take.bit_length() - 1
                        _put_vlc(bw, act, r << 4)
                        if r:
                            bw.put_bits(r, take - (1 << r))
                        eobrun -= take
                        for b in eob_refine:
                            bw.put_bits(1, b)
                        eob_refine = []

                for blk in comp_blocks(ci):
                    mag = [abs(int(blk[k])) for k in range(ss, se + 1)]
                    sgn = [int(blk[k]) > 0 for k in range(ss, se + 1)]
                    hist = [m >> (al + 1) for m in mag]
                    now = [m >> al for m in mag]
                    newly = [i for i in range(len(now))
                             if hist[i] == 0 and now[i] != 0]
                    if not newly:
                        # EOB block: its nonzero-history correction bits
                        # ride with the EOB run
                        eobrun += 1
                        eob_refine.extend(now[i] & 1 for i in range(len(now))
                                          if hist[i] != 0)
                        if eobrun == 0x7FFF:
                            flush_eob_r()
                        continue
                    flush_eob_r()
                    run = 0
                    pend_bits = []
                    i = 0
                    last_new = max(newly)
                    while i <= last_new:
                        if hist[i] != 0:
                            pend_bits.append(now[i] & 1)
                            i += 1
                            continue
                        if now[i] == 0:
                            run += 1
                            if run == 16:
                                _put_vlc(bw, act, 0xF0)
                                for b in pend_bits:
                                    bw.put_bits(1, b)
                                pend_bits = []
                                run = 0
                            i += 1
                            continue
                        # newly nonzero: magnitude 1 by construction
                        _put_vlc(bw, act, (run << 4) | 1)
                        bw.put_bits(1, 1 if sgn[i] else 0)
                        for b in pend_bits:
                            bw.put_bits(1, b)
                        pend_bits = []
                        run = 0
                        i += 1
                    # positions after the last insertion (zeros or old
                    # coefficients) close via the next EOB run with their
                    # correction bits (T.81 G.2.2); if the last insertion
                    # sat exactly at the band end the decoder finishes the
                    # block without an EOB, so this block must not count
                    if last_new < len(now) - 1:
                        eobrun += 1
                        eob_refine.extend(pend_bits)
                        eob_refine.extend(now[j] & 1
                                          for j in range(i, len(now))
                                          if hist[j] != 0)
                flush_eob_r()
                out += sos([(ci, 0, 0 if ci == 0 else 1)], ss, se,
                           al + 1, al, flushed(bw))

    out += b"\xFF\xD9"
    return bytes(out)
