"""ctypes bindings of the port's host C library (native/entropy.c).

The same Python signatures as `amv_tpu.native.entropy_native` for what the
port uses: the host byte passes of the video paths (`unescape_frames`,
`escape_frames`), the baseline MJPEG scan decode with a frame's own tables
(`decode_scans_custom`) and its K.3 scan pack (`pack_scans_generic`), the
progressive frame decode (`ProgressivePlan`, `progressive_frame`), and
the single-core C reference oracles (`ref_decode_frame`,
`ref_encode_frame`, `ref_adpcm_decode`).  `lossless_frame` is the port's
own: the lossless (SOF3) walk the JAX package runs in Python; so are
`riff_walk` and `riff_file`, the AMV container's movi walked and written
through offset and size tables, and `unescape_into`'s table form, which
reads the payloads in place in the file's bytes.  Each call drops the
GIL (a plain ctypes call), so frames decode on several threads.

At first use gcc compiles entropy.c into build/amv_tpu_torch/ at the
repository root (beside the CUDA library); the library is rebuilt when
the source is newer.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

# absolute: tools/time_serving.py loads this file alone, from another tree
from amv_tpu_torch.utils.profiling import span

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "entropy.c")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "amv_tpu_torch")
_SO = os.path.join(BUILD_DIR, "libamv_host.so")
CFLAGS = ["-O3", "-fPIC", "-shared"]

_P8 = ctypes.POINTER(ctypes.c_uint8)
_P16 = ctypes.POINTER(ctypes.c_int16)
_P32 = ctypes.POINTER(ctypes.c_int32)
_P64 = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {   # name -> (restype, argtypes)
    "amv_unescape_frames": (ctypes.c_int64, [
        ctypes.c_void_p, _P64, _P64, ctypes.c_int, _P8, ctypes.c_int64,
        _P64]),
    "amv_escape_packed": (ctypes.c_int64, [
        _P32, ctypes.c_int64, _P32, ctypes.c_int, _P8, _P64, _P64]),
    "amv_ref_decode_frame": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, _P8,
        _P8, _P8]),
    "amv_ref_encode_frame": (ctypes.c_int64, [
        _P8, _P8, _P8, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P8,
        ctypes.c_int64]),
    "adpcm_ref_decode": (ctypes.c_int64, [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, _P16]),
    "amv_decode_scans_custom": (ctypes.c_int, [
        ctypes.c_char_p, _P64, _P64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _P8, _P8, _P8, _P16]),
    "amv_pack_scans_generic": (ctypes.c_int64, [
        _P16, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P8, ctypes.c_int,
        _P8, ctypes.c_int64, _P64, _P64]),
    "amv_progressive_frame": (ctypes.c_int, [
        ctypes.c_char_p, _P64, _P64, ctypes.c_int, _P32, _P64, _P64, _P8,
        _P8, _P8, _P32]),
    "amv_lossless_frame": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.c_int64, _P32, _P32, _P64, _P8, _P8, _P64]),
    "amv_riff_walk": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, _P64, _P64, _P64,
        _P64, _P64]),
    "amv_riff_write": (ctypes.c_int64, [
        ctypes.c_void_p, ctypes.c_int64, _P64, ctypes.c_void_p, _P64, _P64,
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, _P64, _P64,
        ctypes.c_int64]),
}

# a new bytes object of n bytes that C fills before any Python code sees
# it, and the address of its bytes (CPython's own calls, as a C
# extension makes a bytes result)
_new_bytes = ctypes.PYFUNCTYPE(ctypes.py_object, ctypes.c_void_p,
                               ctypes.c_ssize_t)(
    ("PyBytes_FromStringAndSize", ctypes.pythonapi))
_bytes_addr = ctypes.PYFUNCTYPE(ctypes.c_void_p, ctypes.py_object)(
    ("PyBytes_AsString", ctypes.pythonapi))

_lib = None
_lib_lock = threading.Lock()    # one thread builds and loads the library


def build() -> str:
    """Compile entropy.c if the library is missing or older than it;
    return the library's path.  Raises on a failed build."""
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["gcc", *CFLAGS, "-o", tmp, _SRC]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"gcc failed ({res.returncode}):\n{' '.join(cmd)}"
                           f"\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, _SO)
    return _SO


def library() -> ctypes.CDLL:
    """The loaded host library (built on first use, by one thread)."""
    global _lib
    if _lib is None:
        with _lib_lock, span("native.build"):
            if _lib is None:
                lib = ctypes.CDLL(build())
                for name, (restype, argtypes) in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.restype, fn.argtypes = restype, argtypes
                _lib = lib
    return _lib


def tables(payloads):
    """A list of bytes-like payloads -> the table form: (blob bytes,
    offsets int64 [n], sizes int64 [n]), payload i being
    blob[offsets[i]:offsets[i] + sizes[i]].  Copies every payload once."""
    blob = b"".join(payloads)
    offsets = np.zeros(len(payloads), dtype=np.int64)
    sizes = np.array([len(p) for p in payloads], dtype=np.int64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    return blob, offsets, sizes


def _table(src, offsets, sizes):
    """(src as uint8 [n] over its own memory, offsets, sizes as
    C-contiguous int64 [k]) after checking that every entry lies inside
    src; src is any contiguous bytes-like buffer."""
    buf = np.frombuffer(src, np.uint8)
    offsets = np.ascontiguousarray(offsets, np.int64)
    sizes = np.ascontiguousarray(sizes, np.int64)
    if offsets.shape != sizes.shape or offsets.ndim != 1:
        raise ValueError(f"offsets {offsets.shape} and sizes {sizes.shape} "
                         "must be one table")
    if len(offsets) and (offsets.min() < 0 or sizes.min() < 0 or
                         int((offsets + sizes).max()) > buf.size):
        raise ValueError(f"a table entry lies outside its {buf.size}-byte "
                         "buffer")
    return buf, offsets, sizes


def unescape_frames(payloads: list[bytes]):
    """Batch SOI/EOI strip + 0xFF00 unescape into a zero-padded row
    matrix (kernel D's input).

    Returns (rows uint8 [F, stride], lens int64 [F]); stride is the max
    unescaped length rounded up to a multiple of 4 (rows [0, 0] for no
    payloads)."""
    if not payloads:
        return np.zeros((0, 0), np.uint8), np.zeros(0, np.int64)
    blob, offsets, sizes = tables(payloads)
    rows = np.zeros(len(payloads) * row_stride(sizes), np.uint8)
    rows, lens = unescape_into(blob, offsets, sizes, rows,
                               np.zeros(len(payloads), np.int64))
    return rows[:, :(int(lens.max()) + 3) & ~3], lens


def row_stride(sizes) -> int:
    """The row stride `unescape_into` lays payloads of these sizes out
    with: the longest rounded up to a multiple of 4 bytes."""
    return (int(np.max(sizes, initial=0)) + 3) & ~3


def unescape_into(src, offsets, sizes, rows: np.ndarray, lens: np.ndarray):
    """`unescape_frames` of the payloads src[offsets[i]:offsets[i] +
    sizes[i]] (src any contiguous bytes-like buffer, such as a whole .amv
    file read in place) into the caller's buffers (pinned host memory,
    say): rows uint8 with room for F x row_stride(sizes) bytes, lens int64
    with room for F.  Returns (rows as a C-contiguous view [F,
    row_stride], lens [F]).  Bytes of a row past its scan keep what the
    buffer held (kernel D reads nothing past lens)."""
    buf, offsets, sizes = _table(src, offsets, sizes)
    f, stride = len(sizes), row_stride(sizes)
    if rows.dtype != np.uint8 or not rows.flags.c_contiguous or \
            rows.size < f * stride or lens.dtype != np.int64 or \
            not lens.flags.c_contiguous or lens.size < f:
        raise ValueError(f"unescape_into needs C-contiguous uint8 rows of "
                         f">= {f * stride} bytes and int64 lens of >= {f}")
    rows, lens = rows.reshape(-1)[:f * stride].reshape(f, stride), lens[:f]
    if not f:
        return rows, lens
    rc = library().amv_unescape_frames(
        buf.ctypes.data, offsets.ctypes.data_as(_P64),
        sizes.ctypes.data_as(_P64), f, rows.ctypes.data_as(_P8), stride,
        lens.ctypes.data_as(_P64))
    if rc < 0:
        raise ValueError(f"native unescape failed (rc={rc})")
    return rows, lens


def riff_walk(data, pos: int):
    """The movi chunk walk of an AMV file's bytes `data` from offset pos
    (amv_riff_walk) -> (video offsets, video sizes, audio offsets, audio
    sizes), int64 tables into data: each '00dc' and '01wb' chunk's
    payload, a size cut at the end of data, up to "AMV_" or fewer than 8
    bytes left.  Another tag raises ValueError naming it and its
    position."""
    buf = np.frombuffer(data, np.uint8)
    st = np.zeros(3, np.int64)     # end position, video count, audio count
    lib = library()

    def walk(*tabs):
        return lib.amv_riff_walk(buf.ctypes.data, buf.size, pos, *tabs,
                                 st.ctypes.data_as(_P64))

    if walk(None, None, None, None) < 0:   # a first pass counts the chunks
        at = int(st[0])
        raise ValueError(f"unexpected chunk tag {bytes(buf[at:at + 4])!r} "
                         f"at 0x{at:x}")
    v_off, v_size = np.empty((2, int(st[1])), np.int64)
    a_off, a_size = np.empty((2, int(st[2])), np.int64)
    walk(*(t.ctypes.data_as(_P64) for t in (v_off, v_size, a_off, a_size)))
    return v_off, v_size, a_off, a_size


def riff_file(head: bytes, video, audio, tail: bytes) -> bytes:
    """A new bytes object: head, the movi chunks, then tail, each byte
    written once (amv_riff_write).  video is a list of (buf, offsets,
    sizes) tables, one a served batch in stream order, such as
    `escape_packed` returns; audio one table over the whole stream.  The
    chunks interleave as amv_interleave_packet orders them."""
    audio = _table(*audio)
    video = [_table(*t) for t in video] or [_table(b"", [], [])]
    total = len(head) + len(tail) + sum(
        8 * len(s) + int(s.sum()) for _, _, s in video + [audio])
    out = _new_bytes(None, total)
    addr = _bytes_addr(out)
    lib = library()
    ctypes.memmove(addr, head, len(head))
    st = np.array([len(head), 0, 1], np.int64)
    a_buf, a_off, a_size = audio
    for k, (v_buf, v_off, v_size) in enumerate(video):
        rc = lib.amv_riff_write(
            addr, total - len(tail), st.ctypes.data_as(_P64),
            v_buf.ctypes.data, v_off.ctypes.data_as(_P64),
            v_size.ctypes.data_as(_P64), len(v_off), k + 1 < len(video),
            a_buf.ctypes.data, a_off.ctypes.data_as(_P64),
            a_size.ctypes.data_as(_P64), len(a_off))
        if rc < 0:
            raise ValueError(f"native movi write overflowed (rc={rc})")
    if st[0] != total - len(tail) or st[1] != len(a_off):
        raise RuntimeError(f"movi written to {int(st[0])} of "
                           f"{total - len(tail)} bytes")
    ctypes.memmove(addr + total - len(tail), tail, len(tail))
    return out


def escape_packed(words: np.ndarray, bits: np.ndarray):
    """(words int32 [F, w_out] big-endian scan words, bits [F]) -> framed
    '00dc' payloads (1-pad + 0xFF00 escape + SOI/EOI) back to back in one
    buffer: (buf uint8 [n], offsets int64 [F], lens int64 [F]), frame f
    being buf[offsets[f]:offsets[f] + lens[f]]."""
    words = np.ascontiguousarray(words, np.int32)
    bits32 = np.ascontiguousarray(bits, np.int32)
    f, w_out = words.shape
    if bits32.shape != (f,):
        raise ValueError(f"bits must be [{f}], got {bits32.shape}")
    # a frame escapes to at most 2 bytes a scan byte + SOI and EOI
    buf = np.empty(2 * int(((bits32.astype(np.int64) + 7) >> 3).sum())
                   + 4 * f, np.uint8)
    offsets = np.empty(f, np.int64)
    lens = np.empty(f, np.int64)
    rc = library().amv_escape_packed(
        words.ctypes.data_as(_P32), w_out, bits32.ctypes.data_as(_P32), f,
        buf.ctypes.data_as(_P8), offsets.ctypes.data_as(_P64),
        lens.ctypes.data_as(_P64))
    if rc < 0:
        raise ValueError(f"native escape failed (rc={rc})")
    return buf[:rc], offsets, lens


def escape_frames(words: np.ndarray, bits: np.ndarray) -> list[bytes]:
    """(words int32 [F, w_out] big-endian scan words, bits [F]) -> framed
    '00dc' payload bytes per frame (1-pad + 0xFF00 escape + SOI/EOI)."""
    buf, offsets, lens = escape_packed(words, bits)
    return [buf[o:o + n].tobytes() for o, n in zip(offsets.tolist(),
                                                   lens.tolist())]


def decode_scans_custom(scans: list[bytes], n_mcu: int, huff: dict,
                        tab_pairs: list, restart_interval: int = 0,
                        out: np.ndarray | None = None) -> np.ndarray:
    """Baseline-MJPEG scan decode with arbitrary parsed tables, any
    interleaved sampling (blocks/MCU from len(tab_pairs)) and optional
    restart markers (mjpegdec.c:533-548 RSTn resync).

    scans: raw escaped scan byte strings (no SOI/EOI);
    huff: {(class, id): (bits[17], vals[...])} as parsed from DHT;
    tab_pairs: per MCU block b, (dc_id, ac_id) table ids — 6 entries
        for 4:2:0, 4 for 4:2:2, 3 for 4:4:4, 1 for grayscale;
    restart_interval: MCUs between RSTn markers (0 = none).  DC levels
        stay raw differences; the caller's cumsum must reset per
        restart segment.
    Returns int16 [F, n_mcu, n_blk, 64] zigzag levels (slot 0 = DC diff),
    into `out` when given (C-contiguous, that shape; pinned host memory,
    say): the decoder writes every element.  A malformed table or scan
    raises ValueError.
    """
    n_blk = len(tab_pairs)
    bits8 = np.zeros((8, 17), np.uint8)
    vals8 = np.zeros((8, 256), np.uint8)
    for (cls, tid), (bits, vals) in huff.items():
        # untrusted DHT data: bound-check before the C table build (which
        # also validates the canonical Kraft bound itself)
        if cls not in (0, 1) or not 0 <= tid <= 3:
            raise ValueError(f"bad Huffman table id ({cls},{tid})")
        if len(bits) != 17 or len(vals) > 256 or \
                int(np.sum(bits[1:])) != len(vals):
            raise ValueError(f"inconsistent DHT ({cls},{tid}): "
                             f"{int(np.sum(bits[1:]))} codes, "
                             f"{len(vals)} values")
        slot = cls * 4 + tid
        bits8[slot, :len(bits)] = bits
        vals8[slot, :len(vals)] = vals
    tab_ids = np.zeros((n_blk, 2), np.uint8)
    for b, (dc_id, ac_id) in enumerate(tab_pairs):
        if not (0 <= dc_id <= 3 and 0 <= ac_id <= 3):
            raise ValueError(f"bad scan table selector ({dc_id},{ac_id})")
        tab_ids[b] = (dc_id, 4 + ac_id)
    blob, offsets, sizes = tables(scans)
    shape = (len(scans), n_mcu, n_blk, 64)
    if out is None:
        out = np.empty(shape, dtype=np.int16)
    elif out.shape != shape or out.dtype != np.int16 or \
            not out.flags.c_contiguous:
        raise ValueError(f"out must be C-contiguous int16 {shape}")
    rc = library().amv_decode_scans_custom(
        blob, offsets.ctypes.data_as(_P64), sizes.ctypes.data_as(_P64),
        len(scans), n_mcu, n_blk, restart_interval,
        bits8.ctypes.data_as(_P8), vals8.ctypes.data_as(_P8),
        tab_ids.ctypes.data_as(_P8), out.ctypes.data_as(_P16))
    if rc != 0:
        raise ValueError(f"native custom-table decode failed (rc={rc})")
    return out


def pack_scans_generic(levels: np.ndarray, comp_of,
                       restart_interval: int = 0) -> list[bytes]:
    """K.3 Huffman pack of zigzag levels int16 [F, n_mcu, n_blk, 64] (slot
    0 the absolute DC; block b of component comp_of[b], luma tables for 0)
    with RSTn markers and DC resets every restart_interval MCUs -> each
    frame's escaped scan (no SOI/EOI), `amv_tpu.codecs.mjpeg.
    _pack_scan_generic`'s bytes."""
    lv = np.ascontiguousarray(levels, np.int16)
    f, n_mcu, n_blk, _ = lv.shape
    comp = np.ascontiguousarray(comp_of, np.uint8)
    if comp.shape != (n_blk,):
        raise ValueError(f"comp_of must have {n_blk} entries")
    # a token takes at most 32 bits before escaping, escaping at most
    # doubles the bytes, and each MCU may add a pad byte and a marker
    cap = 2 * (4 * lv.size + 3 * f * n_mcu) + 16
    buf = np.empty(cap, np.uint8)
    offsets, lens = np.empty(f, np.int64), np.empty(f, np.int64)
    rc = library().amv_pack_scans_generic(
        lv.ctypes.data_as(_P16), f, n_mcu, n_blk, comp.ctypes.data_as(_P8),
        restart_interval, buf.ctypes.data_as(_P8), cap,
        offsets.ctypes.data_as(_P64), lens.ctypes.data_as(_P64))
    if rc < 0:
        raise ValueError(f"native scan pack overflowed (rc={rc})")
    return [buf[o:o + n].tobytes() for o, n in zip(offsets.tolist(),
                                                   lens.tolist())]


class ProgressivePlan:
    """Prepacked per-header arrays for amv_progressive_frame.  All of this
    depends only on the frame's header (tables, SOF, SOS parameters), so a
    stream of same-header frames packs once."""
    __slots__ = ("n", "blk_all", "blk_off", "tab16", "cis16", "ht", "meta")

    def __init__(self, blks, tabsels, cisels, htabs_list, metas):
        n = self.n = len(metas)
        blks = [np.ascontiguousarray(b, np.int64) for b in blks]
        self.blk_off = np.zeros(n + 1, np.int64)
        np.cumsum([len(b) for b in blks], out=self.blk_off[1:])
        self.blk_all = (np.concatenate(blks) if blks else
                        np.zeros(0, np.int64))
        self.tab16 = np.zeros((n, 16), np.uint8)
        self.cis16 = np.zeros((n, 16), np.uint8)
        for s in range(n):
            self.tab16[s, :len(tabsels[s])] = tabsels[s]
            self.cis16[s, :len(cisels[s])] = cisels[s]
        self.ht = np.ascontiguousarray(np.stack(htabs_list), np.uint8)
        if self.ht.shape != (n, 4, 273):
            raise ValueError(f"Huffman snapshots {self.ht.shape}, "
                             f"not ({n}, 4, 273)")
        self.meta = np.ascontiguousarray(
            np.asarray(metas, np.int32).reshape(n, 6))


def progressive_frame(scans: list, coef: np.ndarray,
                      plan: ProgressivePlan) -> None:
    """All progressive scans of one frame in a single C call
    (amv_progressive_frame).  scans[s] = that scan's escaped bytes; plan
    carries the prepacked header-derived arrays (block maps, table
    selectors, Huffman snapshots, (ss, se, ah, al, ri, bpu) rows).  coef
    int32 [NB_total, 64], C-contiguous, is modified in place; a malformed
    scan raises ValueError (the caller restarts with the Python scan
    decoder)."""
    if coef.dtype != np.int32 or not coef.flags.c_contiguous or \
            coef.ndim != 2 or coef.shape[1] != 64 or len(scans) != plan.n:
        raise ValueError("progressive_frame needs C-contiguous int32 "
                         f"[NB, 64] coefficients and {plan.n} scans")
    # every block index of the plan must land inside coef
    if plan.blk_all.size and int(plan.blk_all.max()) >= coef.shape[0]:
        raise ValueError("progressive plan indexes past the coefficients")
    blob, off, lens = tables(scans)
    rc = library().amv_progressive_frame(
        blob, off.ctypes.data_as(_P64), lens.ctypes.data_as(_P64), plan.n,
        plan.meta.ctypes.data_as(_P32), plan.blk_all.ctypes.data_as(_P64),
        plan.blk_off.ctypes.data_as(_P64), plan.tab16.ctypes.data_as(_P8),
        plan.cis16.ctypes.data_as(_P8), plan.ht.ctypes.data_as(_P8),
        coef.ctypes.data_as(_P32))
    if rc != 0:
        raise ValueError(f"progressive frame decode failed (rc={rc})")


_LOSSLESS_ERRORS = {-1: "out of memory", -2: "expected RSTn",
                    -3: "invalid Huffman code", -4: "bad geometry"}


def lossless_frame(scan: bytes, geom, samp, crop, luts: np.ndarray,
                   out: np.ndarray, out_off) -> None:
    """One lossless (SOF3) frame's Huffman walk and prediction
    (amv_lossless_frame), `bitstream.jpeg_lossless.decode_lossless`'s
    samples: scan the escaped scan bytes; geom (rgb, mb_w, mb_h, n_planes,
    predictor, pt, bits, xform, restart interval); samp [n_planes, 2] each
    plane's h, v; crop [n_planes, 2] each output plane's rows and columns;
    luts uint8 [n_planes, 2, 65536] each plane's decode table (symbols,
    lengths); plane i written to the C-contiguous uint8 out at out_off[i],
    rows back to back.  A malformed scan raises ValueError."""
    geom = np.ascontiguousarray(geom, np.int32)
    n = int(geom[3])
    samp = np.ascontiguousarray(samp, np.int32).reshape(-1, 2)
    crop = np.ascontiguousarray(crop, np.int64).reshape(-1, 2)
    out_off = np.ascontiguousarray(out_off, np.int64)
    if geom.shape != (9,) or samp.shape[0] != n or crop.shape[0] != n or \
            out_off.shape != (n,) or luts.dtype != np.uint8 or \
            luts.shape != (n, 2, 65536) or not luts.flags.c_contiguous or \
            out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError("lossless_frame: inconsistent plane arguments")
    ends = out_off + crop[:, 0] * crop[:, 1]
    if n and (out_off.min() < 0 or int(ends.max()) > out.size):
        raise ValueError("lossless_frame: planes past the output buffer")
    rc = library().amv_lossless_frame(
        scan, len(scan), geom.ctypes.data_as(_P32),
        samp.ctypes.data_as(_P32), crop.ctypes.data_as(_P64),
        luts.ctypes.data_as(_P8), out.ctypes.data_as(_P8),
        out_off.ctypes.data_as(_P64))
    if rc != 0:
        raise ValueError(f"lossless frame decode failed: "
                         f"{_LOSSLESS_ERRORS.get(rc, rc)}")


def ref_decode_frame(payload: bytes, width: int, height: int):
    """Full single-core C decode of one '00dc' payload -> (y, cb, cr)."""
    y = np.zeros((height, width), dtype=np.uint8)
    cb = np.zeros((height // 2, width // 2), dtype=np.uint8)
    cr = np.zeros_like(cb)
    rc = library().amv_ref_decode_frame(
        payload, len(payload), width, height, y.ctypes.data_as(_P8),
        cb.ctypes.data_as(_P8), cr.ctypes.data_as(_P8))
    if rc != 0:
        raise ValueError(f"native ref decode failed (rc={rc})")
    return y, cb, cr


def ref_encode_frame(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                     qscale: int = 2) -> bytes:
    """Full single-core C encode of one frame -> '00dc' payload."""
    h, w = y.shape
    cap = w * h * 4 + 65536
    out = np.zeros(cap, dtype=np.uint8)
    y, cb, cr = (np.ascontiguousarray(p, np.uint8) for p in (y, cb, cr))
    n = library().amv_ref_encode_frame(
        y.ctypes.data_as(_P8), cb.ctypes.data_as(_P8), cr.ctypes.data_as(_P8),
        w, h, qscale, out.ctypes.data_as(_P8), cap)
    if n < 0:
        raise ValueError(f"native ref encode failed (rc={n})")
    return out[:n].tobytes()


def ref_adpcm_decode(data: bytes, predictor: int,
                     step_index: int) -> np.ndarray:
    """Scalar C IMA-ADPCM (AMV) decode of one chunk's nibble bytes."""
    out = np.zeros(2 * len(data), dtype=np.int16)
    n = library().adpcm_ref_decode(data, len(data), predictor, step_index,
                                   out.ctypes.data_as(_P16))
    return out[:n]
