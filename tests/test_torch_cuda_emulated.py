"""The port's CUDA kernel sources run on the CPU, against their plain torch
versions.

Each source (amv_tpu_torch/csrc/*.cu) is compiled with g++ against the
stand-in runtime of tests/cuda_emu/cuda_runtime.h, which runs every CTA's
threads as std::threads with barriers for __syncthreads/__syncwarp and a
shared buffer for the warp shuffles; its launches `k<<<g, b, s, st>>>(...)`
are rewritten into that header's launch helper.  The library is loaded
with ctypes under the C signatures of `kernels._build`, and the kernel's
output is held bit-exact against its plain version at small sizes
(kernels A, T, F, D, R, X, P, L, M, G, K, Y and W).  This
checks a kernel's logic (indices, tiles, scans, barriers) where there is no
card; what nvcc makes of it is checked on the card
(tests/test_torch_cuda.py, chip_smoke.py).  Skipped where g++ is absent.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from amv_tpu_torch import native
from amv_tpu_torch.codecs import amvlib_video as AV
from amv_tpu_torch.codecs.amv_video import encoder_qmat
from amv_tpu_torch.codecs.jpeg_tables import DEC_FAST, REC_FAST
from amv_tpu_torch.kernels import _build
from amv_tpu_torch.kernels import adpcm as AQ
from amv_tpu_torch.kernels import adpcm_trellis as TL
from amv_tpu_torch.kernels import entropy_decode as D
from amv_tpu_torch.kernels import entropy_parallel as EP
from amv_tpu_torch.kernels import entropy_records as ER
from amv_tpu_torch.kernels import fdct as F
from amv_tpu_torch.kernels import record_pack as RP
from amv_tpu_torch.kernels import transcode as T
from amv_tpu_torch.kernels import yuv2rgb_dither as Y
from amv_tpu_torch.verify import fixtures, ref_adpcm
from test_torch_record_sync import boundaries, cut, zrl_scan

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "amv_tpu_torch", "csrc")
_LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\(", re.S)


def emulated(source: str, out_dir, text=None) -> ctypes.CDLL:
    """csrc/<source> (or `text`, an edit of it) built with g++ against
    tests/cuda_emu, loaded."""
    if text is None:
        text = open(os.path.join(CSRC, source)).read()
    text = _LAUNCH.sub(lambda m: f"amv_emu::launch({m.group(1)}, "
                                 f"{m.group(2)}, ", text)
    cpp = os.path.join(out_dir, source + ".cpp")
    so = os.path.join(out_dir, source + ".so")
    with open(cpp, "w") as f:
        f.write(text)
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared",
                    "-fPIC", "-w", "-I", os.path.join(HERE, "cuda_emu"),
                    "-I", CSRC, "-o", so, cpp], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    for name, argtypes in _build._SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = _build._RESTYPES.get(name,
                                                              ctypes.c_int)
    return lib


@pytest.fixture(scope="module")
def adpcm_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    return emulated("adpcm_decode.cu", str(tmp_path_factory.mktemp("emu")))


def _decode(lib, pay, pred, sidx, repeat, skip=0):
    """Kernel A's C entry on numpy arrays; the payload starts `skip` bytes
    into its buffer (an offset view)."""
    c, nb = pay.shape
    buf = np.zeros(c * nb + skip + 16, np.uint8)
    base = (-buf.ctypes.data) % 16 + skip
    buf[base:base + c * nb] = pay.reshape(-1)
    out = np.zeros((c * repeat, 2 * nb), np.int16)
    rc = lib.amv_adpcm_decode(buf.ctypes.data + base, nb, pred.ctypes.data,
                              sidx.ctypes.data, c, c * repeat,
                              out.ctypes.data, None)
    assert rc == 0
    return out


@pytest.mark.parametrize("nbytes,fill,repeat,skip", [
    (1, None, 1, 0), (16, None, 1, 3), (31, None, 3, 1), (32, None, 1, 0),
    (33, None, 1, 7), (689, None, 1, 5), (689, 0x77, 1, 0),
    (689, 0xFF, 1, 0), (689, 0x88, 2, 0), (2100, None, 1, 9)])
def test_adpcm_decode_source_matches_plain(adpcm_lib, nbytes, fill, repeat,
                                           skip):
    """Kernel A's warp scans on the CPU: runs shorter than a lane, a tile
    of 689 bytes, two tiles and a part (2,100 bytes), the clamp rails, the
    wrap, and payloads that start off a 16-byte boundary."""
    rng = np.random.default_rng(nbytes + repeat)
    c = 6
    pay = rng.integers(0, 256, (c, nbytes)).astype(np.uint8)
    if fill is not None:
        pay[:] = fill
    pred = np.array([0, 32767, -32768, 1000, 70000, -2 ** 31], np.int32)
    sidx = np.array([0, 88, 200, -5, 40, 88], np.int32)
    if fill == 0x77:
        pred[:] = 32767
    got = _decode(adpcm_lib, pay, pred, sidx, repeat, skip)
    want = AQ.decode_chunks_plain(*(torch.from_numpy(a) for a in
                                    (pay, pred, sidx)), repeat=repeat)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.fixture(scope="module")
def transcode_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    return emulated("transcode.cu", str(tmp_path_factory.mktemp("emu")))


def _transcode(lib, lv, dc, qmat, geom, mode, with_pix, repeat=1):
    """Kernel T's C entry on numpy arrays -> (levels, pixels or None)."""
    n = lv.shape[0] * repeat
    tables, geo = T.kernel_args(qmat, geom, n, lv.shape[0])
    out = np.zeros((n, 64), np.int16)
    pix = np.zeros((n, 64), np.uint8) if with_pix else None
    rc = lib.amv_transcode_blocks(
        lv.ctypes.data, None if dc is None else dc.ctypes.data,
        tables.ctypes.data, geo, out.ctypes.data,
        None if pix is None else pix.ctypes.data, n, mode, None)
    assert rc == 0
    return out, pix


@pytest.mark.parametrize("case", ["160x120", "168x120", "320x240", "none",
                                  "deq", "wrap"])
def test_transcode_source_matches_plain(transcode_lib, case):
    """Kernel T's shared-memory tiles on the CPU: a last CTA that is half
    full (3 frames of 160x120 are 7.5 CTAs), pad rows and columns, whole
    MCUs, no edge replication, the dequantized entry on a block count that
    is not whole MCUs, and the wrap, each entry against its plain version."""
    rng = np.random.default_rng(len(case))
    q = encoder_qmat(1 if case in ("none", "deq") else 2)
    sizes = {"160x120": (160, 120), "168x120": (168, 120),
             "320x240": (320, 240), "none": None}
    if case == "deq":
        deq = rng.integers(-2048, 2048, (1001, 64)).astype(np.int16)
        got_lv, got_px = _transcode(transcode_lib, deq, None, q,
                                    (1, 1, 16, 16), 2, True)
        want_px, want_lv = T.transcode_deq_plain(torch.from_numpy(deq), q)
    elif case == "wrap":
        n_base, repeat = 8 * 96, 16
        lv = _levels(rng, n_base)
        dc = rng.integers(-4000, 4000, n_base * repeat).astype(np.int32)
        got_lv, got_px = _transcode(transcode_lib, lv, dc, q,
                                    (1, 1, 16, 16), 1, True, repeat)
        want_lv, want_px = T.transcode_blocks_plain(
            torch.from_numpy(lv)[T.wrap_index(n_base, repeat, device="cpu")],
            torch.from_numpy(dc), q)
    else:
        size = sizes[case]
        n = 3 * (80 if size is None else
                 ((size[0] + 15) // 16) * ((size[1] + 15) // 16)) * 6
        lv = _levels(rng, n)
        dc = rng.integers(-40000, 40000, n).astype(np.int32)
        geom = T._geometry(size, n)
        got_lv, got_px = _transcode(transcode_lib, lv, dc, q, geom, 0, True)
        got_lv2, _ = _transcode(transcode_lib, lv, dc, q, geom, 0, False)
        np.testing.assert_array_equal(got_lv2, got_lv)
        want_lv, want_px = T.transcode_blocks_plain(
            torch.from_numpy(lv), torch.from_numpy(dc), q, geom)
    np.testing.assert_array_equal(got_lv, want_lv.numpy())
    np.testing.assert_array_equal(got_px, want_px.numpy())


def _levels(rng, n_blocks, dense=0.15):
    lv = np.where(rng.random((n_blocks, 64)) < dense,
                  rng.integers(-1023, 1024, (n_blocks, 64)), 0)
    lv[rng.random(n_blocks) < 0.05] = 1023
    return lv.astype(np.int16)


@pytest.fixture(scope="module")
def fdct_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    return emulated("fdct.cu", str(tmp_path_factory.mktemp("emu")))


@pytest.mark.parametrize("qscale,zigzag,n,skip", [
    pytest.param(1, True, 400, 0, id="1-True"),
    pytest.param(2, False, 400, 0, id="2-False"),
    pytest.param(31, True, 400, 0, id="31-True"),
    pytest.param(1, False, 400, 8, id="1-False-8-byte-aligned"),
    pytest.param(2, True, 0, 0, id="n0"),
    pytest.param(2, False, 1, 0, id="n1"),
    pytest.param(2, True, 7, 8, id="n7-8-byte-aligned"),
    pytest.param(1, True, 33, 0, id="n33-zigzag"),
    pytest.param(1, False, 33, 8, id="n33-raster-8-byte-aligned")])
def test_fdct_source_matches_plain(fdct_lib, qscale, zigzag, n, skip):
    """Kernel F, the FDCT and the quantizer of dct.cuh that kernels T and V
    share, on the CPU: random pixels and the extremes (flat 0 and 255, and
    a checkerboard of both, whose products wrap at qscale 1), raster and
    zigzag out; block counts of 0, 1, 7 (a CTA's step part full), one past
    a whole CTA step (33) and 400 (each of the emulator's two CTAs takes
    several steps), and pixels that are 8-byte but not 16-byte aligned
    (the least the wrapper accepts)."""
    rng = np.random.default_rng(qscale)
    src = rng.integers(0, 256, (max(n, 3), 64)).astype(np.uint8)
    src[0], src[1] = 0, 255
    src[2] = np.where(np.add.outer(np.arange(8), np.arange(8)) % 2, 255,
                      0).reshape(64)
    buf = np.zeros(n * 64 + 32, np.uint8)
    base = (-buf.ctypes.data) % 16 + skip
    pix = buf[base:base + n * 64].reshape(n, 64)
    pix[:] = src[:n]
    assert pix.ctypes.data % 16 == skip
    q = encoder_qmat(qscale)
    out = _aligned((n, 64), np.int16, 0x5A5A)
    rc = fdct_lib.amv_fdct_quant(pix.ctypes.data,
                                 np.ascontiguousarray(q, np.int32).ctypes.data,
                                 out.ctypes.data, n, int(zigzag), None)
    assert rc == 0
    want = F.fdct_quantize_plain(torch.from_numpy(pix.copy()), q)
    if zigzag:
        want = want[:, torch.as_tensor(F.ZIGZAG).long()]
    np.testing.assert_array_equal(out, want.numpy())


def _lib(source, tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    return emulated(source, str(tmp_path_factory.mktemp("emu")))


@pytest.fixture(scope="module")
def decode_lib(tmp_path_factory):
    return _lib("entropy_decode.cu", tmp_path_factory)


@pytest.fixture(scope="module")
def expand_lib(tmp_path_factory):
    return _lib("record_expand.cu", tmp_path_factory)


@pytest.fixture(scope="module")
def pack_lib(tmp_path_factory):
    return _lib("record_pack.cu", tmp_path_factory)


def _aligned(shape, dtype, fill):
    """A C-contiguous array of `shape` at a 16-byte aligned address, filled
    with `fill` (so that a kernel that skips an element shows)."""
    n = int(np.prod(shape)) * np.dtype(dtype).itemsize
    buf = np.empty(n + 16, np.uint8)
    base = (-buf.ctypes.data) % 16
    out = buf[base:base + n].view(dtype).reshape(shape)
    out[...] = fill
    return out


@pytest.fixture(scope="module")
def scans():
    """Unescaped scans of 4 C-encoded 160x120 pictures (~24 subsequences
    of 1,024 bits a frame) and 5 malformed ones: random bytes, a run of
    0xFF from a quarter of the scan on (invalid codes to its end), a scan
    truncated to a third, an empty one, and blocks that end on a ZRL
    reaching slot 63 (`zrl_scan`)."""
    rng = np.random.default_rng(3)
    y, cb, cr = fixtures.videogen(4, 120, 160, seed=3)
    y = np.clip(y.astype(np.int16) + rng.integers(-3, 4, y.shape), 0,
                255).astype(np.uint8)
    pays = [native.ref_encode_frame(y[i], cb[i][:60, :80], cr[i][:60, :80],
                                    2) for i in range(4)]
    rows, lens = native.unescape_frames(pays + pays + pays[:1])
    rows = np.ascontiguousarray(rows)          # the C entries' layout
    z = zrl_scan(480)[:rows.shape[1]]
    rows[8, :len(z)] = np.frombuffer(z, np.uint8)
    lens[8] = len(z)
    rows[4, :lens[4]] = rng.integers(0, 256, lens[4])
    rows[5, lens[5] // 4:] = 0xFF
    lens[6] //= 3
    lens[7] = 0
    return rows, lens


def _order(lens):
    return np.argsort(-lens, kind="stable").astype(np.int32)


def _records(lib, rows, lens, t_rows, n_blocks=480):
    """Kernel R's C entry on numpy arrays -> (records [F, t_rows], status
    [F, 2], rounds [F]); the records start as garbage."""
    f = rows.shape[0]
    recs = _aligned((f, t_rows), np.int32, 0x5A5A5A5A)
    status = np.zeros((f, 2), np.int32)
    rounds = np.full(f, -1, np.int32)
    tables = np.ascontiguousarray(REC_FAST)
    rc = lib.amv_decode_records(rows.ctypes.data, rows.shape[1],
                                lens.ctypes.data, _order(lens).ctypes.data,
                                f, n_blocks, tables.ctypes.data, t_rows,
                                recs.ctypes.data, status.ctypes.data,
                                rounds.ctypes.data, None)
    assert rc == 0
    return recs, status, rounds


@pytest.mark.parametrize("t_max", [64 * 480, 1000])
def test_record_decode_source_matches_plain(decode_lib, expand_lib, scans,
                                            t_max):
    """Kernel R (D's body in its record mode) on the CPU, records, status
    and its zero tail, in a budget no frame reaches and in one that cuts
    every frame inside a subsequence; then kernel X, frame-major, on those
    records.  The clean frames sync in rounds."""
    rows, lens = scans
    t_rows = ER.record_rows(t_max)
    recs, status, rounds = _records(decode_lib, rows, lens, t_rows)
    want_r, want_s = ER.decode_records_plain(torch.from_numpy(rows),
                                             torch.from_numpy(lens), 480,
                                             t_max)
    np.testing.assert_array_equal(status, want_s.numpy())
    np.testing.assert_array_equal(recs, want_r.numpy())
    assert (rounds >= 0).all() and rounds[:4].max() > 0
    if t_max > 1000:
        assert (status[:4, 0] == 480).all()
    else:
        assert (status[:, 1] == t_rows).all()
    levels = _aligned((9, 480, 64), np.int16, 0x5A5A)
    counts = np.ascontiguousarray(status[:, 1])
    rc = expand_lib.amv_expand_records(recs.ctypes.data, t_rows,
                                       counts.ctypes.data, 9, 480,
                                       levels.ctypes.data, None)
    assert rc == 0
    want = ER.expand_records_plain(want_r, want_s[:, 1].contiguous(), 480)
    np.testing.assert_array_equal(levels, want.numpy())


def _record(level, is_dc, write, wpos):
    """One record of kernel R's IR as an int32."""
    v = (level & 0xFFFF) << 16 | is_dc << 7 | write << 6 | wpos
    return v - (1 << 32) if v >= 1 << 31 else v


def _frame_records(rng, n_gen, kind):
    """The records of a frame of n_gen blocks: per block a DC record, then
    (kind "mixed") up to 11 ACs at increasing slots, some after a ZRL,
    most blocks ended by an EOB; (kind "dc") nothing else, so a tile of
    records covers as many blocks; (kind "zrl") 300 records that write
    nothing (ZRLs), so a window of blocks covers many tiles."""
    recs = []
    for _ in range(n_gen):
        recs.append(_record(int(rng.integers(-2048, 2048)), 1, 1, 0))
        if kind == "dc":
            continue
        if kind == "zrl":
            recs += [_record(0, 0, 0, 63)] * 300
            recs.append(_record(int(rng.integers(-9, 9)), 0, 1, 63))
            continue
        k = int(rng.integers(0, 12))
        for pos in np.sort(rng.choice(np.arange(1, 64), k, replace=False)):
            if rng.random() < 0.1:
                recs.append(_record(0, 0, 0, int(pos)))          # a ZRL
            recs.append(_record(int(rng.integers(-1023, 1024)), 0, 1,
                                int(pos)))
        if rng.random() < 0.8:
            recs.append(_record(0, 0, 0, 63))                   # an EOB
    return recs


@pytest.mark.parametrize("case,n_frames,n_blocks,t_rows", [
    ("mixed", 5, 480, 30720), ("dc", 3, 1800, 2048), ("zrl", 3, 480, 4096),
    ("counts", 5, 480, 6144), ("past", 3, 480, 8192),
    ("mixed", 3, 1200, 20480), ("mixed", 3, 1800, 30720),
    ("unaligned", 3, 480, 6003)])
def test_record_expand_source_matches_plain(expand_lib, case, n_frames,
                                            n_blocks, t_rows):
    """Kernel X on the CPU, on records made to stress its windows of
    blocks: frames of DC records only (a tile reaches many windows), runs
    of ZRLs (a window holds many tiles), counts of 0, negative and above
    T, records whose block passes n_blocks, n_blocks of 1,200 and 1,800
    (not a multiple of the window), a row length that is not a multiple
    of 4 records (no 16-byte loads), and frame counts of 3 and 5; the
    records past each frame's count and the levels start as garbage."""
    rng = np.random.default_rng(len(case) * 7 + n_blocks)
    recs = _aligned((n_frames, t_rows), np.int32, 0x5A5A5A5A)
    counts = np.zeros(n_frames, np.int32)
    for f in range(n_frames):
        n_gen = {"past": n_blocks + 100, "dc": n_blocks}.get(
            case, n_blocks - 7 * f)
        fr = _frame_records(rng, n_gen, "mixed" if case in (
            "counts", "past", "unaligned") else case)[:t_rows]
        recs[f, :len(fr)] = fr
        counts[f] = len(fr)
    if case == "counts":
        recs[1, counts[1]:] = 0               # read to T: no writes
        counts[:4] = [0, t_rows + 50, -3, counts[3] // 2]
    levels = _aligned((n_frames, n_blocks, 64), np.int16, 0x5A5A)
    rc = expand_lib.amv_expand_records(recs.ctypes.data, t_rows,
                                       counts.ctypes.data, n_frames,
                                       n_blocks, levels.ctypes.data, None)
    assert rc == 0
    want = ER.expand_records_plain(torch.from_numpy(recs),
                                   torch.from_numpy(counts), n_blocks)
    np.testing.assert_array_equal(levels, want.numpy())
    assert want.numpy().any()


def test_record_decode_source_cuts_on_boundaries(decode_lib, scans):
    """Kernel R's budget cut on a subsequence's boundary (the T-th record
    ends subsequence j: the sync stops at j) and 4 records before and
    after it, against the plain decoder's records cut to T."""
    rows, lens = scans
    rows, lens = rows[:1], lens[:1].copy()
    want_r, want_s = ER.decode_records_plain(torch.from_numpy(rows),
                                             torch.from_numpy(lens), 480,
                                             64 * 480)
    assert rows.shape[1] <= 16384        # the kernel's S is 1,024 bits
    ts = [t for t in boundaries(rows[0], lens[0], 480, 1024) if t % 4 == 0]
    assert len(ts) >= 2
    for t in ts[:2]:
        for t_rows in (t - 4, t, t + 4):
            recs, status, _ = _records(decode_lib, rows, lens, t_rows)
            wr, ws = cut(want_r.numpy(), want_s.numpy(), t_rows)
            np.testing.assert_array_equal(status, ws)
            np.testing.assert_array_equal(recs, wr)


def test_decode_scans_source_matches_plain(decode_lib, scans):
    """Kernel D (the same body, the C decoder's semantics) on the CPU:
    levels and ok on the clean and malformed scans, and token budgets that
    fail half the frames."""
    rows, lens = scans
    budget = D.token_budget(torch.from_numpy(lens), 480,
                            rows.shape[1]).numpy()
    budget[[0, 2]] = 700                 # spent inside the third subsequence
    levels = np.zeros((9, 480, 64), np.int16)
    ok = np.full(9, 7, np.uint8)
    rounds = np.full(9, -1, np.int32)
    tables = np.ascontiguousarray(DEC_FAST)
    rc = decode_lib.amv_decode_scans(
        rows.ctypes.data, rows.shape[1], lens.ctypes.data,
        _order(lens).ctypes.data, 9, 480, tables.ctypes.data,
        budget.ctypes.data, levels.ctypes.data, ok.ctypes.data,
        rounds.ctypes.data, None)
    assert rc == 0
    want_lv, want_ok = D.decode_scans_plain(
        torch.from_numpy(rows), torch.from_numpy(lens), 480,
        budget=torch.from_numpy(budget))
    np.testing.assert_array_equal(ok, want_ok.numpy())
    np.testing.assert_array_equal(levels, want_lv.numpy())
    assert ok[:4].tolist() == [0, 1, 0, 1] and (rounds >= 0).all()


def _pack(lib, recs, totals, w_out):
    """Kernel P's C entry -> (words, bits); the words start as garbage."""
    words = np.full((recs.shape[0], w_out), 0x5A5A5A5A, np.int32)
    bits = np.full(recs.shape[0], -1, np.int32)
    rc = lib.amv_pack_records(recs.ctypes.data, recs.shape[1],
                              totals.ctypes.data, recs.shape[0], w_out,
                              words.ctypes.data, bits.ctypes.data, None)
    assert rc == 0
    return words, bits


@pytest.mark.parametrize("case", ["tokens", "rechunk", "unaligned", "dense"])
def test_record_pack_source_matches_plain(pack_lib, case):
    """Kernel P on the CPU: the record encoder's tokens (two chunks of
    1,024 records or more a lane), the rechunk encoder's 26-bit pieces
    with their zero-length pads, rows whose length is not a multiple of 4
    records (no 16-byte loads), and records of 27 to 31 bits whose window
    words fill up; in each, a lane with no records, a total above T, and
    word budgets below and above the words needed (the tail zero-filled
    by the kernel)."""
    rng = np.random.default_rng(len(case))
    lv = np.where(rng.random((9, 96, 64)) < 0.3,
                  rng.integers(-1023, 1024, (9, 96, 64)), 0)
    lv[:, :, 0] = rng.integers(0, 2048, (9, 96))
    lv = torch.from_numpy(lv.astype(np.int16))
    if case == "rechunk":
        recs = EP.rechunk_records(lv, None)[0]
        totals = torch.full((9,), recs.shape[1], dtype=torch.int32)
    elif case == "dense":
        ln = rng.integers(27, 32, (9, 3000))
        code = rng.integers(0, 1 << 27, (9, 3000))
        recs = torch.from_numpy((code << 5 | ln).astype(np.int32))
        totals = torch.full((9,), 3000, dtype=torch.int32)
    else:
        t_max = 96 * 64 + (3 if case == "unaligned" else 0)
        recs, totals = ER.tokenize_levels(lv, t_max)[:2]
    recs = np.ascontiguousarray(recs.numpy())
    totals = totals.numpy().copy()
    totals[1] = 0
    totals[2] = recs.shape[1] + 100
    assert (totals > 1024).sum() >= 6                # two chunks or more
    for w_out in (16, 4000):
        words, bits = _pack(pack_lib, recs, totals, w_out)
        want_w, want_b = RP.pack_records_plain(
            torch.from_numpy(recs), torch.from_numpy(totals), w_out)
        np.testing.assert_array_equal(bits, want_b.numpy())
        np.testing.assert_array_equal(words, want_w.numpy())
    assert (bits[3:] > 16 * 32).all() and (bits[3:] < 4000 * 32).all()


@pytest.fixture(scope="module")
def trellis_lib(tmp_path_factory):
    return _lib("adpcm_trellis.cu", tmp_path_factory)


def _trellis_case(case):
    """(x, starts, pairs, step0) of a case of kernel L's source test."""
    rng = np.random.default_rng(len(case))
    if case in ("phase13", "window"):
        # one chunk of phase 13's 1,378 samples (11 traceback windows); a
        # chunk of 300 (past the 128-sample window, ending mid-word)
        n = 1378 if case == "phase13" else 300
        t = np.arange(n)
        x = np.clip(12000 * np.sin(t * 0.031) + rng.normal(0, 400, n),
                    -32768, 32767).astype(np.int16)
        return (x, np.zeros(1, np.int64), np.array([n // 2], np.int32),
                np.array([40], np.int32))
    if case == "rails":
        # full-scale runs at both rails and near-silence, from states 0
        # and 88: the path reaches both clipped ends
        runs = []
        for k in range(12):
            v = (32767, -32768, 0, 3)[k % 4]
            runs.append(np.full(int(rng.integers(20, 90)), v) +
                        (rng.integers(-2, 3, 1) if v in (0, 3) else 0))
        x = np.clip(np.concatenate(runs), -32768, 32767).astype(np.int16)
        x = x[:len(x) // 4 * 4]
        half = len(x) // 2
        return (x, np.array([0, half], np.int64),
                np.array([half // 2, half // 2], np.int32),
                np.array([88, 0], np.int32))
    total = 6 * 64
    t = np.arange(total)
    if case == "silence":
        x = np.zeros(total, np.int16)
    elif case == "square":
        x = np.where((t // 7) % 2, 32767, -32768).astype(np.int16)
    else:
        x = (9000 * np.sin(t * 0.07) + rng.normal(0, 500, total)).astype(
            np.int16)
    starts = np.arange(0, total, 64, dtype=np.int64)
    pairs = np.array([32, 31, 32, 20, 32, 1], np.int32)
    step0 = np.array([0, 88, 40, 87, 1, 88], np.int32)
    if case == "odd_starts":
        starts, pairs, step0 = starts[::-1].copy(), pairs[::-1].copy(), \
            step0[::-1].copy()
        pairs[2] = 0
    return x, starts, pairs, step0


@pytest.mark.parametrize("case", ["sine", "silence", "square", "odd_starts",
                                  "phase13", "window", "rails"])
def test_trellis_source_matches_plain(trellis_lib, case):
    """Kernel L, the Viterbi quantizer, on the CPU, against its plain
    version: chunks of 60-ish samples from given starts (state 0, 88 and
    between; state 88 is the one the dummy lanes 29..31 reduce onto) over
    a seeded sine with noise, silence (ties everywhere), a full-scale
    square wave (the predictor's clip), and chunks given out of stream
    order with one of no samples; a chunk of phase 13's 1,378 samples; a
    chunk of 300 (longer than the traceback's window of 128 samples, its
    last back-pointer word part full); and chunks from states 88 and 0
    over runs at both rails and near silence (the clipped ends)."""
    x, starts, pairs, step0 = _trellis_case(case)
    pred0 = x[starts].astype(np.int32)
    total = len(x)
    out = np.full(total // 2, 0xA5, np.uint8)
    final = np.full(len(starts), -1, np.int32)
    len_max = 2 * int(pairs.max())
    back = np.zeros(trellis_lib.amv_trellis_scratch(len(starts), len_max),
                    np.uint8)
    rc = trellis_lib.amv_trellis(
        x.ctypes.data, starts.ctypes.data, pairs.ctypes.data,
        step0.ctypes.data, pred0.ctypes.data, len(starts), len_max,
        back.ctypes.data, out.ctypes.data, final.ctypes.data, None)
    assert rc == 0
    want = torch.full((total // 2,), 0xA5, dtype=torch.uint8)
    wfinal = TL.trellis_chunks_plain(*(torch.from_numpy(a) for a in (
        x, starts, pairs, step0, pred0)), want)
    np.testing.assert_array_equal(out, want.numpy())
    np.testing.assert_array_equal(final, wfinal.numpy())
    if case == "rails":              # the path visits both clipped ends
        nib = np.stack([want.numpy() >> 4, want.numpy() & 15], 1).ravel()
        s, seen = int(step0[0]), set()
        for k, nb in enumerate(nib):
            if k == total // 2:
                s = int(step0[1])
            s = min(max(s + int(ref_adpcm.INDEX_TABLE[nb & 7]), 0), 88)
            seen.add(s)
        assert {0, 88} <= seen


@pytest.fixture(scope="module")
def ms_lib(tmp_path_factory):
    return _lib("adpcm_ms.cu", tmp_path_factory)


def _ms_case(case):
    """(nibbles uint8 [B, n], coeff1, coeff2, idelta, sample1, sample2)."""
    rng = np.random.default_rng(3 + len(case))
    if case == "block":
        # the MS-ADPCM block of the wav tests' extremes case (negative
        # idelta, full-scale samples, nibbles 7 and 8 until idelta wraps),
        # as the WAVE route lays it out
        data = bytes([6]) + np.array([-32768, 32767, -32768],
                                     "<i2").tobytes()
        data += bytes([0x7F, 0x88, 0xF0, 0x08] * 6)
        data += data[:7] + bytes([0x88] * 40)
        from amv_tpu_torch.codecs import wav_audio
        _, lanes = wav_audio._lanes(data, 1, 31, 7, wav_audio._ms_lanes)
        return tuple(np.ascontiguousarray(a) for a in lanes)
    b, n = {"random": (45, 300), "odd": (37, 203),
            "rows": (33, 2034)}.get(case, (9, 40))
    nib = rng.integers(0, 16, (b, n)).astype(np.uint8)
    st = [rng.choice([256, 512, 0, 192, 240, 460, 392], b),
          rng.choice([0, -256, 0, 64, 0, -208, -232], b),
          rng.integers(-300, 5000, b), rng.integers(-32768, 32768, b),
          rng.integers(-32768, 32768, b)]
    if case == "wrap":
        # |idelta| x 3 a sample from the extremes of int32: the predictor
        # product, idelta's growth and the sum wrap
        nib[:3] = 8
        st[2][:3] = [2 ** 30, -2 ** 31, 2 ** 31 - 1]
    return (nib, *(np.asarray(v, np.int32) for v in st))


@pytest.mark.parametrize("case", ["random", "wrap", "block", "odd", "rows"])
def test_ms_source_matches_plain(ms_lib, case):
    """Kernel M, the MS-ADPCM expand, on the CPU against its plain version
    (`decode_ms_nibbles_plain`): 45 lanes of 300 samples (two warps, the
    second part full; 18 chunks of 16 and a tail of 12), lanes at the
    int32 extremes of idelta with the nibble 8 that grows it, the
    extremes block of the WAVE tests laid out by the MS-ADPCM route; rows
    of an odd 203 samples (rows at every byte offset from a word, 16-bit
    stores) and phase 12's 2,034 (rows 2 bytes off a word every other
    row, a tail of 2)."""
    nib, *st = _ms_case(case)
    b, n = nib.shape
    out = np.full((b, n), 0x5A5A, np.int16)
    rc = ms_lib.amv_ms_expand(nib.ctypes.data, b, n,
                              *(a.ctypes.data for a in st),
                              out.ctypes.data, None)
    assert rc == 0
    want = AQ.decode_ms_nibbles_plain(*(torch.from_numpy(a)
                                        for a in (nib, *st)))
    np.testing.assert_array_equal(out, want.numpy())


@pytest.mark.parametrize("variant", ["rows_24", "rows_16", "rows_8",
                                     "stores_row_by_row", "table",
                                     "no_dpx"])
def test_ms_variant_source_matches_plain(tmp_path, variant):
    """tools/ms_variants.py's builds of kernel M, with fewer rows a warp
    (the lanes past them only copy and store) or another store loop, on
    the CPU against the plain version: 45 lanes of 300 samples (two to six
    warps, the last part full) and phase 12's 2,034 samples a row over 33
    lanes."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    from amv_tpu_torch.tools import ms_variants as mv
    from amv_tpu_torch.tools import trellis_variants as tv
    text = tv.sources(open(os.path.join(CSRC, mv.SOURCE)).read(),
                      mv.VARIANTS)[variant]
    lib = emulated(mv.SOURCE, str(tmp_path), text)
    for case in ("random", "rows"):
        nib, *st = _ms_case(case)
        b, n = nib.shape
        out = np.full((b, n), 0x5A5A, np.int16)
        assert lib.amv_ms_expand(nib.ctypes.data, b, n,
                                 *(a.ctypes.data for a in st),
                                 out.ctypes.data, None) == 0
        want = AQ.decode_ms_nibbles_plain(*(torch.from_numpy(a)
                                            for a in (nib, *st)))
        np.testing.assert_array_equal(out, want.numpy(), err_msg=case)


@pytest.fixture(scope="module")
def g729_lib(tmp_path_factory):
    return _lib("g729_decode.cu", tmp_path_factory)


def _g729_frames():
    """3 streams x 12 frames: stream 0 random with erasures, bad parity
    and high and low pitch codes; stream 1 erased for its first 2 frames
    (lags 0 and 1) and at the largest pitch gain (LP synthesis
    overflows); stream 2 with P1 = 0 (lag 19) in its third frame."""
    rng = np.random.default_rng(5)
    frames = fixtures.g729_frames(rng, 12, 3, erasure=0.1, bad_parity=0.1,
                                  high_pitch=0.1, low_pitch=0.2)
    frames[4:6, 0] = 0
    fixtures.g729_loud(frames[:, 1])
    frames[:2, 1] = 0
    fixtures.g729_set_field(frames[2, 2], 18, 8, 0)
    fixtures.g729_set_field(frames[2, 2], 26, 1, 1)
    return frames


def _g729(lib, parms, flat):
    t, b = parms.shape[:2]
    flat = np.ascontiguousarray(flat, np.int32).copy()
    pcm = np.full((t, b, 80), 0x5A5A, np.int16)
    p = np.ascontiguousarray(parms, np.int32)
    rc = lib.amv_g729_decode(p.ctypes.data, t, b, flat.ctypes.data,
                             pcm.ctypes.data, None)
    assert rc == 0
    return flat, pcm


@pytest.mark.parametrize("split", [12, 5, 1, 2])
def test_g729_source_matches_plain(g729_lib, monkeypatch, split):
    """Kernel G on the CPU against its plain version
    (`codecs.g729a.decode_frames_scan` on CPU tensors): erasures (leading
    ones too), the overflow redo (its whole-buffer shift), lags 0, 1 and
    19 (the interpolation in rounds), bad parity; in one launch, or in two
    (frames 0 to split - 1, then the rest from the state the first
    returned; a launch of 1 or 2 frames is shorter than the four-stage
    pipeline, which fills and drains within it).  PCM and every state
    field are bit-exact."""
    from amv_tpu_torch.codecs import g729a as G
    from amv_tpu_torch.kernels import g729 as K
    from test_torch_g729 import coverage
    frames = _g729_frames()
    _, redo, least = coverage(frames, monkeypatch)
    assert redo > 0 and least == 0
    assert g729_lib.amv_g729_state_words() == K.STATE_WORDS
    parms = G.unpack_frames(frames)
    st0 = G.init_state(3, device="cpu")
    want_st, want = G.decode_frames_scan(st0, parms)
    flat = K.flatten_state(st0).numpy()
    pcms = []
    for a, b in ((0, split), (split, 12)):
        if a < b:
            flat, pcm = _g729(g729_lib, parms[a:b].numpy(), flat)
            pcms.append(pcm)
    np.testing.assert_array_equal(np.concatenate(pcms), want.numpy())
    got_st = K.unflatten_state(torch.from_numpy(flat))
    for k, _ in G.STATE_FIELDS:
        np.testing.assert_array_equal(got_st[k].numpy(), want_st[k].numpy(),
                                      err_msg=k)


@pytest.fixture(scope="module")
def g729_encode_lib(tmp_path_factory):
    return _lib("g729_encode.cu", tmp_path_factory)


def _pulse_trains(periods, n, rng):
    """Shaped pulse trains of the given periods (samples) with noise: the
    pitch search locks onto their lags."""
    sig = []
    for period in periods:
        x = np.where(np.arange(n) % period == 0, 16000.0, 0.0)
        x = np.convolve(x, [1.0, 0.6, 0.3, -0.2, -0.4], "same")
        sig.append(np.clip(x + rng.standard_normal(n) * 300, -32768, 32767))
    return np.stack(sig).round()


def _g729_encode_case(case):
    """(state, hist, frames float32 [T, B, 80]) of a case: seeded speech;
    silence, full-scale noise, a full-scale square wave, a sine and speech;
    a start state with a full-scale excitation history at the largest
    sharpening, whose LP synthesis overflows (the redo); pulse trains of
    periods 25 (a lag under 40: its vector repeats), 23 and 142
    (subframe 1's window clamped to lags from 20 and to 134 up); two
    streams (in the emulator's device of 2 SMs the launch takes its
    128-thread build at up to 2 streams, its 64-thread one past that)."""
    from amv_tpu_torch.codecs import g729a as G
    rng = np.random.default_rng(8)
    if case == "speech":
        b, t = 3, 10
        sig = fixtures.speech_streams(b, t * 80, 2)
    elif case == "speech pair":
        b, t = 2, 8
        sig = fixtures.speech_streams(b, t * 80, 3)
    elif case.startswith("pulses"):
        t = 12
        sig = _pulse_trains((25, 23, 142) if case == "pulses" else (23, 142),
                            t * 80, rng)
        b = len(sig)
    else:
        t, n = 6, 480
        sig = np.stack([
            np.zeros(n), np.clip(rng.standard_normal(n) * 30000, -32768,
                                 32767),
            np.where(np.arange(n) % 40 < 20, 32767, -32768),
            8000 * np.sin(2 * np.pi * 440 * np.arange(n) / 8000),
            fixtures.speechgen(n, seed=2)])
        b = len(sig)
    st = G.init_state(b, device="cpu")
    if case == "loud state":
        st["exc"] = torch.from_numpy(rng.integers(
            -32768, 32768, (b, G.EXC_LEN)).astype(np.int32))
        st["syn_filter_data"] = torch.from_numpy(rng.integers(
            -32768, 32768, (b, 10)).astype(np.int32))
        st["pitch_sharp"][:] = G.SHARP_MAX
    frames = torch.from_numpy(np.ascontiguousarray(
        sig.astype(np.float32).reshape(b, t, 80).transpose(1, 0, 2)))
    return st, torch.zeros((b, 160)), frames


def _lags(parms):
    """Subframe 0's integer lag and subframe 1's window base, from the
    parameters [T, B, 16]."""
    p1 = parms[..., 5].numpy()
    t0 = np.where(p1 < 197, (p1 + 59) // 3, p1 - 112)
    return t0, np.clip(t0 - 5, 20, 134)


@pytest.mark.parametrize("case,split", [
    ("speech", 10), ("speech", 4), ("edges", 6), ("loud state", 6),
    ("pulses", 12), ("pulses", 5), ("pulses pair", 7), ("speech pair", 8)])
def test_g729_encode_source_matches_plain(g729_encode_lib, monkeypatch,
                                          case, split):
    """Kernel K on the CPU against its plain version
    (`codecs.g729a_encoder_batch.encode_frames_scan` on CPU tensors),
    parameters, state and hist bit for bit: seeded speech in one launch
    and in two (the second from the state and hist the first returned),
    the edge signals, a start state whose LP synthesis overflows, pulse
    trains whose lags reach under 40 and subframe 1's clamped windows, and
    two streams (the launch's other build)."""
    from amv_tpu_torch.codecs import g729a as G
    from amv_tpu_torch.codecs import g729a_encoder_batch as E
    from amv_tpu_torch.kernels import g729 as K
    st, hist, frames = _g729_encode_case(case)
    redo = [0]
    synth = G.lp_synthesis_filter

    def counted(lp, inp, fd, clip_output):
        out = synth(lp, inp, fd, clip_output)
        redo[0] += 0 if clip_output else int(out[2].sum())
        return out

    monkeypatch.setattr(G, "lp_synthesis_filter", counted)
    want_st, want_h, want = E.encode_frames_scan(st, hist, frames)
    assert (redo[0] > 0) == (case == "loud state")
    if case.startswith("pulses"):
        t0, base = _lags(want)
        if case == "pulses":
            assert (t0 < 40).any()
        assert (base == 20).any() and (base == 134).any()
    flat = K.flatten_state(st).numpy().copy()
    h = hist.numpy().copy()
    parms = []
    t, b = frames.shape[:2]
    for lo, hi in ((0, split), (split, t)):
        if lo < hi:
            x = np.ascontiguousarray(frames[lo:hi].numpy())
            p = np.full((hi - lo, b, 16), -1, np.int32)
            assert g729_encode_lib.amv_g729_encode(
                x.ctypes.data, hi - lo, b, flat.ctypes.data, h.ctypes.data,
                p.ctypes.data, None) == 0
            parms.append(p)
    np.testing.assert_array_equal(np.concatenate(parms), want.numpy())
    np.testing.assert_array_equal(h, want_h.numpy())
    got_st = K.unflatten_state(torch.from_numpy(flat))
    for k, _ in G.STATE_FIELDS:
        np.testing.assert_array_equal(got_st[k].numpy(), want_st[k].numpy(),
                                      err_msg=k)


@pytest.fixture(scope="module")
def yuv2rgb_lib(tmp_path_factory):
    return _lib("yuv2rgb_packed.cu", tmp_path_factory)


# table keys beyond the default: (brightness, contrast, saturation) that
# kernel Y's computed path takes for some formats and not for others
# (rgb32's and rgb565's indices then reach another channel's table), and
# one no format's computed path takes (its products leave int32)
_Y_KEYS = {"keyed": (64, 80000, 90000), "dim": (-50, 40000, 30000),
           "huge": (0, 2 ** 20, 2 ** 20)}


@pytest.mark.parametrize("fmt", sorted(Y._FORMATS) + [
    "rgb565 undithered", "bgr24 limited"] + [
    f"{f} {k}" for f in sorted(Y._FORMATS) for k in ("keyed",)] + [
    "rgb24 huge", "rgb565 huge", "rgb32 dim", "bgr555 limited-keyed",
    "rgb24 limited-dim", "rgb8 limited-keyed"])
def test_yuv2rgb_source_matches_plain(yuv2rgb_lib, fmt):
    """Kernel Y in every format: widths whose last group of 8 pixels is
    short (22, 10) or whole (16, 40), 160x120, rows of more than 256 groups
    (2,058 and 2,064 wide: a chroma row in two tiles), planes that start
    off a vector boundary (the general path) or on one (the whole-group
    path), saturated pixels that reach the arena clamp (a whole frame,
    every dither row, at the multi-frame shapes); limited range, no dither, and keys of brightness,
    contrast and saturation through both of its paths (`register_map`)."""
    fmt, _, mode = fmt.partition(" ")
    dither = mode != "undithered"
    full_range = "limited" not in mode
    bcs = _Y_KEYS.get(mode.rpartition("-")[2], (0, 65536, 65536))
    key = (fmt, full_range, dither, *bcs)
    rng = np.random.default_rng(sorted(Y._FORMATS).index(fmt) + len(mode))
    for h, w, skip, f in ((6, 22, 1, 3), (4, 10, 0, 3), (8, 16, 3, 3),
                          (2, 40, 0, 3), (120, 160, 0, 2),
                          (2, 2058, 1, 1), (2, 2064, 0, 1)):
        if fmt == "monoblack" and w % 8:
            continue
        y = rng.integers(0, 256, (f, h, w), np.uint8)
        c = [rng.integers(0, 256, (f, h // 2, w // 2), np.uint8)
             for _ in range(2)]
        # frame 0 saturated, whole (every dither row) where other frames
        # follow, else its first luma row pair
        sat = h if f > 1 else 2
        y[0, :sat] = rng.choice([0, 255], (sat, w))
        c[0][0, :sat // 2] = rng.choice([0, 255], (sat // 2, w // 2))
        bufs = []
        for a in (y, *c):
            buf = np.zeros(a.size + skip + 16, np.uint8)
            base = (-buf.ctypes.data) % 16 + skip
            buf[base:base + a.size] = a.reshape(-1)
            bufs.append((buf, buf.ctypes.data + base))
        shape, dtype, _ = Y._out_shape(fmt, (f,), h, w)
        out = torch.zeros(shape, dtype=dtype)
        tables = Y.kernel_tables(*key)
        rc = yuv2rgb_lib.amv_yuv2rgb_packed(
            bufs[0][1], bufs[1][1], bufs[2][1], tables.ctypes.data,
            Y.kernel_geometry(key, f, h, w), out.data_ptr(), None)
        assert rc == 0
        want = Y.yuv420_to_packed_plain(
            *(torch.from_numpy(a) for a in (y, *c)), *key[:3], *bcs)
        np.testing.assert_array_equal(out.numpy(), want.numpy(),
                                      err_msg=f"{fmt} {mode} {h}x{w}")


def test_yuv2rgb_register_map_takes_the_usual_keys():
    """The computed path covers the 32-, 24- and 16/15-bit formats at the
    default keys in both ranges, dithered or not, and no 8-, 4- or 1-bit
    format; a key whose lookups cross into another channel's table, or
    whose products leave int32, falls back to the tables."""
    for fmt, (depth, _) in Y._FORMATS.items():
        for full_range in (True, False):
            for dither in (True, False):
                reg = Y.register_map(fmt, full_range, dither, 0, 65536, 65536)
                assert (reg is not None) == (depth >= 15), fmt
    assert Y.register_map("rgb24", True, True, *_Y_KEYS["keyed"])
    assert Y.register_map("rgb32", True, True, *_Y_KEYS["keyed"]) is None
    assert Y.register_map("rgb24", True, True, *_Y_KEYS["huge"]) is None


@pytest.fixture(scope="module")
def amvlib_lib(tmp_path_factory):
    return _lib("amvlib_idct.cu", tmp_path_factory)


@pytest.mark.parametrize("w,h,f,large", [(25, 33, 2, False),
                                         (48, 32, 3, False),
                                         (48, 32, 2, True),
                                         (160, 120, 2, False),
                                         (320, 64, 1, False)])
def test_amvlib_source_matches_plain(amvlib_lib, w, h, f, large):
    """Kernel W's two entries: the int32 planes (odd 25x33 too: partial
    MCUs, rows and columns cropped) and the RGB (even sizes), with DC
    levels large enough that the row pass's products and shifts wrap;
    160x120 and 320x64 frames (80 MCUs: 3 chunks of at most 32, the last
    partial; 80 in 2 rows) carry the DC prediction across chunks."""
    rng = np.random.default_rng(w + h + large)
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    lv = np.zeros((f, mb_w * mb_h, 6, 64), np.int16)
    mask = rng.random(lv.shape) < 0.2
    lv[mask] = rng.integers(-60, 61, mask.sum())
    lv[..., 0] = rng.integers(-200, 201, lv.shape[:3])
    if large:
        lv[..., 0] = rng.integers(30000, 32768, lv.shape[:3])
        lv[..., 1:9] = rng.integers(-32768, 32768, lv[..., 1:9].shape)
    lvt = torch.from_numpy(lv)
    tables, geo = AV.kernel_args(f, w, h)
    want = AV.decode_transform_amvlib_plain(lvt, mb_w, mb_h, w, h)
    got = [torch.full_like(p, 7777) for p in want]
    assert amvlib_lib.amv_amvlib_idct(
        lvt.data_ptr(), tables.ctypes.data, geo,
        *(p.data_ptr() for p in got), 0, None) == 0
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), x.numpy())
    if w % 2 == 0 and h % 2 == 0:
        rgb = torch.zeros((f, h, w, 3), dtype=torch.uint8)
        assert amvlib_lib.amv_amvlib_idct(
            lvt.data_ptr(), tables.ctypes.data, geo, rgb.data_ptr(), None,
            None, 1, None) == 0
        np.testing.assert_array_equal(rgb.numpy(),
                                      AV.rgb_amvlib_plain(*want).numpy())
