"""The port's CUDA kernels against their plain torch versions, on the card.

Every test needs an NVIDIA GPU and nvcc and skips without them.  The GPU
machine has no JAX, so run this file there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs are made from numpy seeds; the contract is bit-exact equality.  The
file imports only the port (its own copies of the host layer and the
oracles), so it runs where `amv_tpu` cannot be built.
"""

import os
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from amv_tpu_torch import native  # noqa: E402
from amv_tpu_torch.codecs import amv_audio, amv_video  # noqa: E402
from amv_tpu_torch.codecs.amv_video import encoder_qmat  # noqa: E402
from amv_tpu_torch.codecs.jpeg_tables import (  # noqa: E402
    ENC_TABLES, ZIGZAG, encoder_quant_matrix)
from amv_tpu_torch.containers import riff  # noqa: E402
from amv_tpu_torch.kernels import adpcm as AQ  # noqa: E402
from amv_tpu_torch.kernels import decode_fused as U  # noqa: E402
from amv_tpu_torch.kernels import encode_fused as V  # noqa: E402
from amv_tpu_torch.kernels import entropy_decode as D  # noqa: E402
from amv_tpu_torch.kernels import entropy_encode as E  # noqa: E402
from amv_tpu_torch.kernels import entropy_parallel as EP  # noqa: E402
from amv_tpu_torch.kernels import entropy_records as ER  # noqa: E402
from amv_tpu_torch.kernels import fdct as F  # noqa: E402
from amv_tpu_torch.kernels import idct as I  # noqa: E402
from amv_tpu_torch.kernels import record_pack as RP  # noqa: E402
from amv_tpu_torch.kernels import transcode as T  # noqa: E402
from amv_tpu_torch.pipeline import decode as PD  # noqa: E402
from amv_tpu_torch.pipeline import encode as PE  # noqa: E402
from amv_tpu_torch.pipeline import serving as S  # noqa: E402
from amv_tpu_torch.pipeline import transcode as P  # noqa: E402
from amv_tpu_torch.verify import fixtures, ref_adpcm  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _payloads(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    y, cb, cr = fixtures.rotozoom(n, h, w)
    y = np.clip(y.astype(np.int16) + rng.integers(-6, 7, y.shape), 0,
                255).astype(np.uint8)
    return [native.ref_encode_frame(y[i], cb[i], cr[i], 2) for i in range(n)]


def _random_levels(rng, n_blocks, dense=0.15):
    lv = np.where(rng.random((n_blocks, 64)) < dense,
                  rng.integers(-1023, 1024, (n_blocks, 64)), 0)
    lv[rng.random(n_blocks) < 0.05] = 1023
    return lv.astype(np.int16)


@pytest.mark.parametrize("qscale,size", [(1, None), (2, (160, 120)),
                                         (31, (40, 24))])
def test_transcode_kernel_matches_plain(dev, qscale, size):
    rng = np.random.default_rng(qscale)
    n_mcu = 80 if size is None else ((size[0] + 15) // 16) * \
        ((size[1] + 15) // 16)
    n = 7 * n_mcu * 6
    lv = torch.from_numpy(_random_levels(rng, n))
    dc = torch.from_numpy(rng.integers(-40000, 40000, n).astype(np.int32))
    q = encoder_qmat(qscale)
    geom = T._geometry(size, n)
    want_lv, want_pix = T.transcode_blocks_plain(lv.to(dev), dc.to(dev), q,
                                                 geom)
    got_lv, got_pix = T.transcode_blocks_pix(lv.to(dev), dc.to(dev), q, size)
    got_lv2 = T.transcode_blocks(lv.to(dev), dc.to(dev), q, size)
    torch.cuda.synchronize()
    assert torch.equal(got_lv, want_lv)
    assert torch.equal(got_pix, want_pix)
    assert torch.equal(got_lv2, want_lv)


def test_decode_kernel_matches_plain_and_c(dev):
    pays = _payloads(12, 120, 160)
    rows, lens = native.unescape_frames(pays)
    rng = np.random.default_rng(3)
    bad = rows.copy()
    bad_lens = lens.copy()
    bad[0, :] = rng.integers(0, 256, bad.shape[1])          # random bytes
    bad_lens[1] //= 3                                        # truncated
    bad[2, 40:48] = 0xFF                                     # invalid code
    for r, ln in ((rows, lens), (bad, bad_lens)):
        rt, lt = torch.from_numpy(r).to(dev), torch.from_numpy(ln).to(dev)
        got = D.decode_scans(rt, lt, 480)
        want = D.decode_scans_plain(rt, lt, 480)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
    assert got[1].tolist()[3:] == [1] * 9
    assert got[1].tolist()[2] == 0


def test_encode_kernel_matches_plain(dev):
    rng = np.random.default_rng(5)
    lv = _random_levels(rng, 9 * 480).reshape(9, 480, 64)
    lv[:, :, 0] = rng.integers(-1023, 1024, (9, 480))
    lt = torch.from_numpy(lv).to(dev)
    for w_out in (64, 4096, 40000):
        got = E.encode_levels(lt, w_out)
        want = E.encode_levels_plain(lt, w_out)
        torch.cuda.synchronize()
        for g, x in zip(got, want):
            assert torch.equal(g, x)
    assert got[2].all() and not E.encode_levels(lt, 64)[2].any()


D_CASES = ["boundaries", "cut", "fail_first", "fail_last", "budget",
           "wide_rows", "widest_rows"]


def _decode_case(case, rng):
    """(rows, lens, budget or None) for kernel D's subsequence design: S is
    1,024 bits (128 bytes) for rows up to 16 KB and more for wider ones
    (20,000 and 170,000 bytes here)."""
    pays = _payloads(12, 120, 160, seed=11)
    rows, lens = native.unescape_frames(pays)
    rows, lens = rows.copy(), lens.copy()
    budget = None
    if case == "boundaries":        # data ending on, before, after 128 k
        for f in range(12):
            lens[f] = 128 * (1 + f % 6 + 6 * (f // 6)) + (f % 3) - 1
    elif case == "cut":             # decodes on into the zero fill
        lens -= np.arange(12) % 3 + 1
    elif case == "fail_first":
        rows[::2, 3:7] = 0xFF
    elif case == "fail_last":
        for f in range(0, 12, 2):
            at = (8 * int(lens[f]) - 1) // 1024 * 128 + 2
            at = min(at, int(lens[f]) - 4)
            rows[f, at:at + 4] = 0xFF
    elif case == "budget":
        budget = D.token_budget(torch.from_numpy(lens), 480, rows.shape[1])
        budget[::2] = torch.from_numpy(rng.integers(1, 900, 6))
    elif case in ("wide_rows", "widest_rows"):
        stride = 20000 if case == "wide_rows" else 170000
        wide = np.zeros((12, stride), np.uint8)
        wide[:, :rows.shape[1]] = rows
        rows = wide
    return rows, lens, budget


@pytest.mark.parametrize("case", D_CASES)
def test_decode_kernel_subsequence_cases_match_plain(dev, case):
    """Kernel D's speculative decode on the cases that stress it: data
    ending at and around subsequence boundaries, scans cut by 1-3 bytes,
    failures in the first and in the last subsequence, a spent token
    budget, and larger subsequences."""
    rows, lens, budget = _decode_case(case, np.random.default_rng(
        D_CASES.index(case)))
    rt, lt = torch.from_numpy(rows).to(dev), torch.from_numpy(lens).to(dev)
    kw = {} if budget is None else {"budget": budget.to(dev)}
    *got, rounds = D.decode_scans(rt, lt, 480, rounds=True, **kw)
    want = D.decode_scans_plain(rt, lt, 480, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert rounds.shape == (12,)
    if case in ("fail_first", "fail_last", "budget"):
        assert not got[1][::2].any() and got[1][1::2].all()


def bits_mod(lt):
    """frame 0's bits mod 32, as they are (no trimming)."""
    return int(E.count_bits_plain(lt[:1])[0]) % 32


E_CASES = ["exact_fit", "one_bit_over", "unstaged", "320x240", "175x97",
           "q60_flat"]


@pytest.mark.parametrize("case", E_CASES)
def test_encode_kernel_cases_match_plain(dev, case):
    """Kernel E and its count entry against their plain versions: frames
    ending exactly at 32 * w_out bits and one bit past, a w_out too large
    for shared memory (the global-atomic branch), 320x240 and 175x97
    pictures, and flat q60 frames at the DC extremes."""
    rng = np.random.default_rng(E_CASES.index(case))
    if case in ("320x240", "175x97", "q60_flat"):
        w, h = {"320x240": (320, 240), "175x97": (175, 97),
                "q60_flat": (160, 120)}[case]
        if case == "q60_flat":
            planes = [torch.full((4, hh, ww), v, dtype=torch.uint8)
                      for v in (0, 255, 128, 13)
                      for (hh, ww) in ((h, w), (h // 2, w // 2),
                                       (h // 2, w // 2))]
            planes = [torch.cat(planes[k::3]) for k in range(3)]
        else:
            y, cb, cr = fixtures.rotozoom(6, h, w)
            planes = [torch.from_numpy(np.ascontiguousarray(p))
                      for p in (y, cb[:, :h // 2, :w // 2],
                                cr[:, :h // 2, :w // 2])]
        quant = "q60" if case == "q60_flat" else "ffmpeg"
        lt = V.encode_planes(*(p.to(dev) for p in planes), 2, quant)
        w_outs = [(int(E.count_bits(lt).max()) + 31) // 32]
    else:
        lv = _random_levels(rng, 6 * 480, dense=0.1).reshape(6, 480, 64)
        lt = torch.from_numpy(lv).to(dev)
        # zero frame 0's levels from its end until its bits are 32 k
        # (exact_fit) or 32 k + 1
        target = {"exact_fit": 0, "one_bit_over": 1}.get(case, bits_mod(lt))
        bits = int(E.count_bits_plain(lt[:1])[0])
        for b in range(479, 0, -1):
            for k in range(63, 0, -1):
                if bits % 32 == target:
                    break
                if lt[0, b, k]:
                    lt[0, b, k] = 0
                    bits = int(E.count_bits_plain(lt[:1])[0])
        assert bits % 32 == target
        w_outs = {"exact_fit": [bits // 32],
                  "one_bit_over": [bits // 32, bits // 32 + 1],
                  "unstaged": [30000]}[case]
    for w_out in w_outs:
        got = E.encode_levels(lt, w_out)
        want = E.encode_levels_plain(lt, w_out)
        torch.cuda.synchronize()
        for g, x in zip(got, want):
            assert torch.equal(g, x)
    assert torch.equal(E.count_bits(lt), E.count_bits_plain(lt))
    if case == "exact_fit":
        assert got[2][0] == 1 and got[1][0] == 32 * w_outs[0]
    if case == "one_bit_over":
        assert got[2][0] == 1
        got = E.encode_levels(lt, w_outs[0])
        assert got[2][0] == 0 and got[1][0] == 32 * w_outs[0] + 1


@pytest.mark.parametrize("w,h", [(160, 120), (40, 24), (36, 20)])
def test_transcode_bytes_cuda_matches_c_reference(dev, w, h):
    pays = _payloads(6, h, w, seed=1)
    data = riff.mux(pays, [], width=w, height=h, fps=16)
    launches = (D.LAUNCHES, T.LAUNCHES, E.LAUNCHES)
    out = riff.demux(P.transcode_bytes(data, qscale=2, device="cuda"))
    want = [native.ref_encode_frame(*native.ref_decode_frame(p, w, h), 2)
            for p in pays]
    assert out.video_chunks == want
    assert all(a > b for a, b in zip((D.LAUNCHES, T.LAUNCHES, E.LAUNCHES),
                                     launches))


@pytest.mark.parametrize("case", ["random", "dc_only", "raw"])
def test_idct_kernel_matches_plain(dev, case):
    rng = np.random.default_rng(7)
    n = 6 * 997
    lv = _random_levels(rng, n)
    if case == "dc_only":
        lv[:, 1:] = 0
    dc = rng.integers(-40000, 40000, n).astype(np.int32)
    lt, dt = torch.from_numpy(lv).to(dev), torch.from_numpy(dc).to(dev)
    if case == "raw":
        got = I.idct_put(lt.reshape(-1, 8, 8))
        want = I.idct_put_plain(lt).reshape(-1, 8, 8)
    else:
        got = I.idct_blocks(lt, dt)
        want = I.idct_blocks_plain(lt, dt)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("qscale", [1, 2, 31])
def test_fdct_kernel_matches_plain(dev, qscale):
    rng = np.random.default_rng(qscale)
    pix = rng.integers(0, 256, (6 * 1013, 64)).astype(np.uint8)
    pix[:7] = np.array([0, 255] * 32, np.uint8)    # extreme checkerboards
    pix[7:9] = 255
    pt = torch.from_numpy(pix).to(dev)
    q = encoder_qmat(qscale)
    want = F.fdct_quantize_plain(pt, q)
    got_raster = F.fdct_quantize(pt.reshape(-1, 8, 8), q)
    got_zz = F.fdct_quant_blocks(pt, q)
    torch.cuda.synchronize()
    assert torch.equal(got_raster, want)
    zz = torch.as_tensor(ZIGZAG, device=dev).long()
    assert torch.equal(got_zz, want[:, zz])


@pytest.mark.parametrize("case", ["random", "0x77", "0xff_sidx88"])
def test_adpcm_decode_kernel_matches_plain(dev, case):
    rng = np.random.default_rng(11)
    c, nb = 300, 689
    pay = rng.integers(0, 256, (c, nb)).astype(np.uint8)
    pred = rng.integers(-32768, 32768, c).astype(np.int32)
    sidx = rng.integers(-5, 95, c).astype(np.int32)
    if case == "0x77":
        pay[:] = 0x77
    elif case == "0xff_sidx88":
        pay[:] = 0xFF
        sidx[:] = 88
    args = [torch.from_numpy(a).to(dev) for a in (pay, pred, sidx)]
    for repeat in (1, 3):
        got = AQ.decode_chunks(*args, repeat=repeat)
        want = AQ.decode_chunks_plain(*args, repeat=repeat)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["chunks", "no_reset_at_0", "sidx88",
                                  "no_resets"])
def test_adpcm_encode_kernel_matches_plain(dev, case):
    rng = np.random.default_rng(13)
    b, n = 3, 4000
    x = np.cumsum(rng.integers(-900, 900, (b, n)), axis=1).clip(
        -32768, 32767).astype(np.int16)
    x[1, ::7] = rng.choice([-32768, 32767], len(x[1, ::7]))
    reset = np.zeros((b, n), bool)
    reset[:, ::1378] = True
    reset[2, 1001] = True                       # an odd reset, in-segment
    sidx0 = np.array([0, 40, 88], np.int32)
    if case == "no_reset_at_0":
        reset[:, 0] = False
    elif case == "sidx88":
        sidx0[:] = 88
    elif case == "no_resets":
        reset[:] = False
    args = [torch.from_numpy(a).to(dev) for a in (x, reset, sidx0)]
    for repeat in (1, 2):
        got = AQ.encode_streams(*args, repeat=repeat)
        want = AQ.encode_streams_plain(*args, repeat=repeat)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("w,h", [(160, 120), (40, 24)])
def test_decode_encode_cuda_match_c_reference(dev, w, h):
    rng = np.random.default_rng(2)
    y, cb, cr = fixtures.videogen(5, h, w, seed=2)
    y = np.clip(y.astype(np.int16) + rng.integers(-5, 6, y.shape), 0,
                255).astype(np.uint8)
    pcm = fixtures.audiogen(5 / 16, seed=2)
    launches = (U.LAUNCHES, V.LAUNCHES, AQ.DECODE_LAUNCHES,
                AQ.ENCODE_LAUNCHES)
    old = (I.LAUNCHES, F.LAUNCHES)
    data = PE.encode_to_bytes(y, cb, cr, pcm, device="cuda")
    s = riff.demux(data)
    assert s.video_chunks == [native.ref_encode_frame(y[i], cb[i], cr[i], 2)
                              for i in range(5)]
    assert s.audio_chunks == ref_adpcm.encode(pcm, 1378, 22050)
    dec = PD.decode_bytes(data, device="cuda")
    for i, p in enumerate(s.video_chunks):
        ry, rcb, rcr = native.ref_decode_frame(p, w, h)
        assert np.array_equal(dec.y[i], ry)
        assert np.array_equal(dec.cb[i], rcb)
        assert np.array_equal(dec.cr[i], rcr)
    assert np.array_equal(dec.pcm, amv_audio.decode_chunks(
        s.audio_chunks, device="cpu"))
    assert all(a > b for a, b in zip(
        (U.LAUNCHES, V.LAUNCHES, AQ.DECODE_LAUNCHES, AQ.ENCODE_LAUNCHES),
        launches))
    assert (I.LAUNCHES, F.LAUNCHES) == old     # U and V replace I and F


@pytest.mark.parametrize("qscale", [1, 2])
def test_transcode_kernel_other_entries_match_plain(dev, qscale):
    """Kernel T's dequantized entry (transcode_soa's contract) and its
    repeat= wrap (transcode_zz_wrap's), against their plain versions."""
    rng = np.random.default_rng(20 + qscale)
    q = encoder_qmat(qscale)
    deq = torch.from_numpy(rng.integers(-2048, 2048, (4099, 64))
                           .astype(np.int16)).to(dev)
    got = T.transcode_deq(deq, q)
    want = T.transcode_deq_plain(deq, q)
    n_base, repeat = 8 * 96, 16                       # nm_base 96: pf 16
    base = torch.from_numpy(_random_levels(rng, n_base)).to(dev)
    dc = torch.from_numpy(rng.integers(-4000, 4000, n_base * repeat)
                          .astype(np.int32)).to(dev)
    got_w = T.transcode_blocks_pix(base, dc, q, repeat=repeat)
    want_w = T.transcode_blocks_plain(
        base[T.wrap_index(n_base, repeat, device=dev)], dc, q)
    torch.cuda.synchronize()
    for g, w in zip(got + got_w, want + want_w):
        assert torch.equal(g, w)


def test_record_decode_kernels_match_plain_and_d(dev):
    """Kernels R and X against their plain versions (valid, malformed and
    over-budget scans), and decode_scans_async against kernel D."""
    pays = _payloads(12, 120, 160, seed=4)
    rows, lens = native.unescape_frames(pays)
    rng = np.random.default_rng(6)
    rows[0, :] = rng.integers(0, 256, rows.shape[1])        # random bytes
    rows[1, 40:48] = 0xFF                                   # invalid code
    lens[2] //= 3                                           # truncated
    rt, lt = torch.from_numpy(rows).to(dev), torch.from_numpy(lens).to(dev)
    for t_max in (500, 480 * 64):
        recs, status = ER.decode_records(rt, lt, 480, t_max)
        want_r, want_s = ER.decode_records_plain(rt, lt, 480, t_max)
        lv = ER.expand_records(recs, status[:, 1].contiguous(), 480)
        want_lv = ER.expand_records_plain(want_r, want_s[:, 1], 480)
        torch.cuda.synchronize()
        assert torch.equal(recs, want_r) and torch.equal(status, want_s)
        assert torch.equal(lv, want_lv)
    assert (status[3:, 0] == 480).all()
    levels, ok = ER.decode_scans_async(rt, lt, 480, 480 * 64)
    want, ok_d = D.decode_scans(rt, lt, 480)
    assert torch.equal(levels[3:], want[3:]) and ok[3:].all()


def test_record_encoders_match_plain_and_e(dev):
    """Kernel P against its plain version, and the record, rechunk and
    parallel encoders against kernel E's words and bits."""
    rng = np.random.default_rng(8)
    lv = _random_levels(rng, 9 * 480, dense=0.08).reshape(9, 480, 64)
    lv[:, :, 0] = rng.integers(0, 2048, (9, 480))
    lt = torch.from_numpy(lv).to(dev)
    recs, totals, _, ok = ER.tokenize_levels(lt, 64 * 480)
    for w_out in (64, 8192):
        got = RP.pack_records(recs, totals, w_out)
        want = RP.pack_records_plain(recs, totals, w_out)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ok.all()
    ew, eb, _ = E.encode_levels(lt, 8192)
    for words, bits, ok in (
            ER.encode_layout_async(lt, 8192, 64 * 480),
            EP.encode_layout_rechunk(lt, 8192, None),
            EP.encode_layout_parallel(lt, 8192, **EP.FITTING_WINDOWS)):
        assert ok.all()
        assert torch.equal(words, ew) and torch.equal(bits, eb)


def _zrl_scan(n_blocks):
    """Blocks no C encoder writes: a DC of size 0, ZRL, ZRL, a 1 at slot
    47 and a ZRL reaching slot 63, which ends the block in JAX's record
    decode."""
    code, size = ENC_TABLES
    bits = ""
    for b in range(n_blocks):
        dc, ac = (0, 2) if b % 6 < 4 else (1, 3)
        for t, sym, extra in ((dc, 0, ""), (ac, 0xF0, ""), (ac, 0xF0, ""),
                              (ac, 0xE1, "1"), (ac, 0xF0, "")):
            bits += format(int(code[t, sym]), f"0{size[t, sym]}b") + extra
    bits += "1" * (-len(bits) % 8)
    return np.frombuffer(bytes(int(bits[i:i + 8], 2)
                               for i in range(0, len(bits), 8)), np.uint8)


@pytest.mark.parametrize("t_max", [1000, 1800 * 64])
def test_record_decode_kernel_edges_320x240(dev, t_max):
    """Kernel R at 320x240 (~40 subsequences of 1,024 bits a frame) in a
    budget that cuts every frame inside a subsequence and in one no frame
    reaches: clean frames, random bytes, a run of 0xFF to the end of the
    scan (invalid codes), a truncated scan, an empty one and blocks that
    end on a ZRL reaching slot 63 (`_zrl_scan`); the records
    land on memory left dirty, so R's own zero tail shows; then kernel X on
    R's frame-major records, and R's sync rounds."""
    pays = _payloads(6, 240, 320, seed=12)
    rows, lens = native.unescape_frames(pays + pays[:5])
    rows = np.ascontiguousarray(rows)
    rng = np.random.default_rng(12)
    rows[6, :lens[6]] = rng.integers(0, 256, lens[6])
    rows[7, lens[7] // 4:] = 0xFF
    lens[8] //= 3
    lens[9] = 0
    z = _zrl_scan(1800)[:rows.shape[1]]
    rows[10, :len(z)] = z
    lens[10] = len(z)
    rt, lt = torch.from_numpy(rows).to(dev), torch.from_numpy(lens).to(dev)
    t_rows = ER.record_rows(t_max)
    dirty = torch.full((11, t_rows), 0x5A5A5A5A, dtype=torch.int32,
                       device=dev)
    del dirty                    # the caching allocator hands it to R
    recs, status, rounds = ER.decode_records(rt, lt, 1800, t_max,
                                             rounds=True)
    want_r, want_s = ER.decode_records_plain(rt, lt, 1800, t_max)
    lv = ER.expand_records(recs, status[:, 1].contiguous(), 1800)
    want_lv = ER.expand_records_plain(want_r, want_s[:, 1], 1800)
    torch.cuda.synchronize()
    assert recs.is_contiguous() and recs.shape == (11, t_rows)
    assert torch.equal(status, want_s) and torch.equal(recs, want_r)
    assert torch.equal(lv, want_lv)
    rounds = rounds.cpu()
    assert (rounds >= 0).all() and rounds[:6].max() > 0
    if t_max > 1000:
        assert (status[:6, 0] == 1800).all()
        levels, _ = D.decode_scans(rt[:6], lt[:6], 1800)
        assert torch.equal(lv[:6], levels)
    else:
        assert (status[:, 1] == t_rows).all()


@pytest.mark.parametrize("case", ["tokens", "rechunk", "unaligned"])
def test_record_pack_kernel_edges_320x240(dev, case):
    """Kernel P at 320x240: the record encoder's tokens, the rechunk
    encoder's 26-bit pieces, and rows of a length that is not a multiple
    of 4 (no 16-byte loads); a lane with no records, a total above T, word
    budgets below the words needed (16), exact and above, on memory left
    dirty (P's own zero fill)."""
    rng = np.random.default_rng(len(case))
    lv = _random_levels(rng, 7 * 1800, dense=0.08).reshape(7, 1800, 64)
    lv[:, :, 0] = rng.integers(0, 2048, (7, 1800))
    lt = torch.from_numpy(lv).to(dev)
    if case == "rechunk":
        recs, _ = EP.rechunk_records(lt, None)
        totals = torch.full((7,), recs.shape[1], dtype=torch.int32,
                            device=dev)
    else:
        t_max = 64 * 1800 + (3 if case == "unaligned" else 0)
        recs, totals, _, _ = ER.tokenize_levels(lt, t_max)
        totals = totals.clone()
    totals[1] = 0
    totals[2] = recs.shape[1] + 100
    need = int((RP.pack_records_plain(recs, totals, 1)[1].max() + 31) // 32)
    for w_out in (16, need, need + 300):
        dirty = torch.full((7, w_out), -1, dtype=torch.int32, device=dev)
        del dirty
        got = RP.pack_records(recs, totals, w_out)
        want = RP.pack_records_plain(recs, totals, w_out)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("enc", ["record", "rechunk", "parallel"])
def test_transcode_routes_cuda_match_c_reference(dev, enc):
    pays = _payloads(6, 120, 160, seed=5)
    rows, lens = native.unescape_frames(pays)
    launches = (E.LAUNCHES, RP.LAUNCHES)
    words, bits, ok = P.transcode_complete(
        torch.from_numpy(rows).to(dev), torch.from_numpy(lens).to(dev), 80,
        2, (160, 120), enc=enc)
    assert ok.all()
    assert native.escape_frames(words.cpu().numpy(), bits.cpu().numpy()) == \
        [native.ref_encode_frame(*native.ref_decode_frame(p, 160, 120), 2)
         for p in pays]
    assert E.LAUNCHES == launches[0]
    assert (RP.LAUNCHES > launches[1]) == (enc != "parallel")


@pytest.mark.parametrize("w,h", [(160, 120), (40, 24), (33, 25)])
def test_fused_decode_kernel_matches_plain(dev, w, h):
    """Kernel U's two entries against their plain versions: the coded
    planes of decode_fused and the display planes of decode_planes, with
    and without the un-sort."""
    rng = np.random.default_rng(w + h)
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    f = 9
    lv = torch.from_numpy(_random_levels(rng, f * mb_w * mb_h * 6)).to(dev)
    dc = torch.from_numpy(rng.integers(-40000, 40000, lv.shape[0])
                          .astype(np.int32)).to(dev)
    perm = torch.from_numpy(rng.permutation(f)).to(dev)
    pairs = [(U.decode_planes(lv, dc, w, h, dst=d),
              U.decode_planes_plain(lv, dc, w, h, d)) for d in (None, perm)]
    lv4 = lv.view(f, mb_w * mb_h, 6, 64)
    dc3 = dc.view(f, mb_w * mb_h, 6)
    pairs.append((U.decode_fused(lv4, dc3, mb_w, mb_h),
                  U.decode_fused_plain(lv4, dc3, mb_w, mb_h)))
    torch.cuda.synchronize()
    for got, want in pairs:
        for g, x in zip(got, want):
            assert torch.equal(g, x)


@pytest.mark.parametrize("w,h", [(160, 120), (168, 120), (175, 97), (40, 24),
                                 (33, 25), (34, 17)])
def test_fused_encode_kernel_matches_plain(dev, w, h):
    """Kernel V's entries against their plain versions: encode_planes with
    both quantizers (qscale 1 wraps the products) on random and flat
    pictures, and encode_fused on coded planes."""
    rng = np.random.default_rng(w * h)
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    f = 7
    y = rng.integers(0, 256, (f, h, w)).astype(np.uint8)
    cb = rng.integers(0, 256, (f, h // 2, w // 2)).astype(np.uint8)
    cr = rng.integers(0, 256, (f, h // 2, w // 2)).astype(np.uint8)
    for i, val in enumerate((0, 255, 13)):
        y[i], cb[i], cr[i] = val, 255 - val, val
    planes = [torch.from_numpy(p).to(dev) for p in (y, cb, cr)]
    pairs = []
    for quant, q in (("ffmpeg", 1), ("ffmpeg", 2), ("q60", 2)):
        qm = encoder_qmat(q) if quant == "ffmpeg" else np.zeros(64, np.int32)
        pairs.append((V.encode_planes(*planes, q, quant),
                      V.encode_planes_plain(*planes, qm, quant)))
    coded = [torch.from_numpy(rng.integers(0, 256, (f, s * mb_h, s * mb_w))
                              .astype(np.uint8)).to(dev) for s in (16, 8, 8)]
    for q in (1, 2):
        pairs.append((V.encode_fused(*coded, mb_w, mb_h, q),
                      V.encode_fused_plain(*coded, mb_w, mb_h,
                                           encoder_qmat(q))))
    torch.cuda.synchronize()
    for got, want in pairs:
        assert torch.equal(got, want)


@pytest.mark.parametrize("w,h", [(160, 120), (33, 25)])
def test_q60_and_odd_sizes_cuda_match_cpu_and_c(dev, w, h):
    """The two-stage transcode (quant="q60", and an odd size with ffmpeg),
    the q60 encode and the odd-size decode on the card: bytes equal to the
    port's CPU route, ffmpeg bytes to the C reference, q60 payloads
    decoded by the C decoder to the port's planes; D, U, V and E launch,
    T does not."""
    pays = _payloads(6, h, w, seed=9)
    data = riff.mux(pays, [], width=w, height=h, fps=16)
    counts = (D.LAUNCHES, U.LAUNCHES, V.LAUNCHES, E.LAUNCHES, T.LAUNCHES)
    out = P.transcode_bytes(data, quant="q60", device="cuda")
    after = (D.LAUNCHES, U.LAUNCHES, V.LAUNCHES, E.LAUNCHES, T.LAUNCHES)
    assert all(a > b for a, b in zip(after[:4], counts[:4]))
    assert after[4] == counts[4]
    assert out == P.transcode_bytes(data, quant="q60", device="cpu")
    q60 = riff.demux(out).video_chunks
    dec = PD.decode_bytes(out, device="cuda")
    for i, p in enumerate(q60):
        for k, ref in enumerate(native.ref_decode_frame(p, w, h)):
            assert np.array_equal((dec.y, dec.cb, dec.cr)[k][i], ref)
    if w % 2:
        got = riff.demux(P.transcode_bytes(data, qscale=2, device="cuda"))
        assert got.video_chunks == [native.ref_encode_frame(
            *native.ref_decode_frame(p, w, h), 2) for p in pays]
    y, cb, cr = dec.y, dec.cb, dec.cr
    assert amv_video.encode_frames(y, cb, cr, quant="q60", device="cuda") \
        == amv_video.encode_frames(y, cb, cr, quant="q60", device="cpu")


@pytest.mark.parametrize("case", ["long_segments", "one_segment", "uneven",
                                  "many_groups"])
def test_adpcm_encode_kernel_segment_cases_match_plain(dev, case):
    """Kernel Q's windows: segments longer than a staged tile (chunks of
    3,000 samples), one segment for the whole stream, streams with uneven
    segment counts (B = 4), and streams of more than two groups of 64
    windows of 512 samples with sparse resets (most windows empty)."""
    rng = np.random.default_rng(17)
    b, n = 4, 12000
    if case == "many_groups":
        n = 2 * 64 * 512 + 1000                 # 130 windows, 3 groups
    x = np.cumsum(rng.integers(-1200, 1200, (b, n)), axis=1).clip(
        -32768, 32767).astype(np.int16)
    reset = np.zeros((b, n), bool)
    sidx0 = np.array([0, 88, 17, 60], np.int32)
    if case == "long_segments":
        reset[:, ::3000] = True
        reset[1, 4321] = True                   # odd, inside a segment
    elif case == "one_segment":
        reset[:, 0] = True
    elif case == "uneven":
        reset[0, ::1378] = True
        reset[1, ::40] = True
        reset[2, [0, 9000]] = True
        reset[3, 100::2] = rng.random((n - 100) // 2) < 0.01
    else:
        for bi in range(b):     # even resets 1,000-4,000 samples apart
            at = np.cumsum(rng.integers(500, 2000, n // 500))
            reset[bi, 2 * at[at < n // 2]] = True
        reset[:, 0] = True
        reset[2, 33333] = True                  # odd, inside a segment
    args = [torch.from_numpy(a).to(dev) for a in (x, reset, sidx0)]
    for repeat in (1, 3):
        got = AQ.encode_streams(*args, repeat=repeat)
        want = AQ.encode_streams_plain(*args, repeat=repeat)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("skip", [1, 2, 3])
def test_adpcm_encode_kernel_takes_offset_views(dev, skip):
    """One stream given as a contiguous view that starts 1-3 samples into
    its storage (samples and reset flags off a 4-byte boundary): the
    kernel's output equals the plain version's on the same views."""
    rng = np.random.default_rng(skip)
    n = 3000 + skip
    x = torch.from_numpy(rng.integers(-20000, 20000, (1, n)).astype(
        np.int16)).to(dev)
    reset = torch.zeros((1, n), dtype=torch.bool, device=dev)
    reset[:, skip::1000] = True
    args = (x[:, skip:], reset[:, skip:],
            torch.full((1,), 40, dtype=torch.int32, device=dev))
    assert args[0].is_contiguous() and args[1].is_contiguous()
    got = AQ.encode_streams(*args)
    want = AQ.encode_streams_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def test_zero_frame_encode_on_card(dev):
    """No frames and no audio: V, E's count, E and Q take the empty
    inputs without a launch error, and the file equals the CPU route's."""
    y = np.zeros((0, 120, 160), np.uint8)
    c = np.zeros((0, 60, 80), np.uint8)
    pcm = np.zeros(0, np.int16)
    for quant in ("ffmpeg", "q60"):
        got = PE.encode_to_bytes(y, c, c, pcm, quant=quant, device="cuda")
        torch.cuda.synchronize()
        assert got == PE.encode_to_bytes(y, c, c, pcm, quant=quant,
                                         device="cpu")
        assert len(got) == 324
    lv = V.encode_planes(*(torch.from_numpy(p).to(dev) for p in (y, c, c)),
                         2)
    assert lv.shape == (0, 480, 64)
    assert E.count_bits(lv).shape == (0,)
    words, bits, ok = E.encode_levels(lv, 1)
    assert words.shape == (0, 1) and bits.shape == (0,)
    empty = torch.zeros((1, 0), dtype=torch.int16, device=dev)
    out = AQ.encode_streams(empty, empty.bool(),
                            torch.zeros(1, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    assert out[0].shape == (1, 0) and out[1].shape == (1, 0)


@pytest.mark.parametrize("w,h", [(168, 120), (320, 240)])
def test_transcode_kernel_all_entries_at_sizes(dev, w, h):
    """Kernel T's four entries on frames of 168x120 (pad columns and rows)
    and 320x240 (whole MCUs), against their plain versions: the layout and
    pixel entries with the edge replication, the dequantized entry on the
    same blocks, and the wrap over two frames' blocks."""
    rng = np.random.default_rng(w)
    q = encoder_qmat(2)
    nb = ((w + 15) // 16) * ((h + 15) // 16) * 6
    n = 5 * nb
    lv = torch.from_numpy(_random_levels(rng, n)).to(dev)
    dc = torch.from_numpy(rng.integers(-40000, 40000, n).astype(np.int32)
                          ).to(dev)
    got = T.transcode_blocks_pix(lv, dc, q, (w, h))
    got_lv = T.transcode_blocks(lv, dc, q, (w, h))
    want = T.transcode_blocks_plain(lv, dc, q, T._geometry((w, h), n))
    deq = I.dequantize(lv, dc).to(torch.int16)
    got_deq = T.transcode_deq(deq, q)
    want_deq = T.transcode_deq_plain(deq, q)
    base = lv[:2 * nb]
    nm_base = base.shape[0] // 8
    repeat = T.WRAP_TILE // np.gcd(nm_base, T.WRAP_TILE)
    dc_w = dc[:2 * nb].repeat(repeat)
    got_w = T.transcode_blocks_pix(base, dc_w, q, repeat=repeat)
    want_w = T.transcode_blocks_plain(
        base[T.wrap_index(base.shape[0], repeat, device=dev)], dc_w, q)
    torch.cuda.synchronize()
    for g, x in zip(got + (got_lv,) + got_deq + got_w,
                    want + want[:1] + want_deq + want_w):
        assert torch.equal(g, x)


@pytest.mark.parametrize("n_mcu", [1, 7, 31, 32, 33, 65])
def test_transcode_kernel_partial_tiles(dev, n_mcu):
    """Block counts that are not whole CTA tiles of 32 MCUs (192 blocks):
    the layout and pixel entries with and without pad pixels, and the
    dequantized entry on counts that are not whole MCUs either."""
    rng = np.random.default_rng(n_mcu)
    q = encoder_qmat(1)
    n = 6 * n_mcu * 3
    lv = torch.from_numpy(_random_levels(rng, n)).to(dev)
    dc = torch.from_numpy(rng.integers(-40000, 40000, n).astype(np.int32)
                          ).to(dev)
    pairs = []
    for size in (None, (16 * n_mcu - 6, 10)):   # one MCU row, pad both ways
        want = T.transcode_blocks_plain(lv, dc, q, T._geometry(size, n))
        pairs += zip(T.transcode_blocks_pix(lv, dc, q, size), want)
        pairs.append((T.transcode_blocks(lv, dc, q, size), want[0]))
    deq = I.dequantize(lv, dc).to(torch.int16)
    for m in (1, n - 1, n):
        pairs += zip(T.transcode_deq(deq[:m], q),
                     T.transcode_deq_plain(deq[:m], q))
    torch.cuda.synchronize()
    for g, x in pairs:
        assert torch.equal(g, x)


@pytest.mark.parametrize("nbytes", [1, 16, 31, 32, 33, 689, 1024, 1025, 5000])
def test_adpcm_decode_kernel_tile_edges(dev, nbytes):
    """Kernel A on chunks shorter than a warp's lanes, around a lane run and
    a staged tile (1,024 bytes), and longer than four tiles; payloads that
    start 0-3 bytes past a 16-byte boundary (offset views of one buffer);
    the wrap 64 times over; header predictors beyond int16."""
    rng = np.random.default_rng(nbytes)
    c = 37
    buf = torch.from_numpy(rng.integers(0, 256, c * nbytes + 16)
                           .astype(np.uint8)).to(dev)
    pred = torch.from_numpy(rng.integers(-70000, 70000, c).astype(np.int32)
                            ).to(dev)
    sidx = torch.from_numpy(rng.integers(-5, 100, c).astype(np.int32)).to(dev)
    for skip in range(4):
        pay = buf[skip:skip + c * nbytes].view(c, nbytes)
        for repeat in (1, 64):
            got = AQ.decode_chunks(pay, pred, sidx, repeat=repeat)
            want = AQ.decode_chunks_plain(pay, pred, sidx, repeat=repeat)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (skip, repeat)


@pytest.mark.parametrize("h,w", [(120, 160), (240, 320)])
def test_record_expand_kernel_on_dirty_memory(dev, h, w):
    """Kernel X (480 and 1,800 blocks a frame: 3.75 and 14.06 windows of
    128 blocks) on kernel R's records, its levels allocated where a
    0x5A-filled buffer of their size was just freed, so that every slot
    the kernel leaves unwritten shows; a frame with count 0, one with a
    count above T, a truncated scan (a frame that is not ok: blocks no
    record reaches) and one of random bytes."""
    n_blocks = (w // 16) * ((h + 15) // 16) * 6
    pays = _payloads(7, h, w, seed=n_blocks)
    rows, lens = native.unescape_frames(pays)
    rows = np.ascontiguousarray(rows)
    rng = np.random.default_rng(n_blocks)
    rows[5, :lens[5]] = rng.integers(0, 256, lens[5])
    lens[4] //= 3
    rt, lt = torch.from_numpy(rows).to(dev), torch.from_numpy(lens).to(dev)
    recs, status = ER.decode_records(rt, lt, n_blocks, 64 * n_blocks)
    counts = status[:, 1].clone()
    counts[0] = 0
    counts[1] = recs.shape[1] + 5
    dirty = torch.full((7, n_blocks, 64), 0x5A5A, dtype=torch.int16,
                       device=dev)
    del dirty                    # the caching allocator hands it to X
    got = ER.expand_records(recs, counts, n_blocks)
    want = ER.expand_records_plain(recs, counts, n_blocks)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not got[0].any() and got[2:].any()


@pytest.mark.parametrize("n", [1, 7, 33, 32 * 1000 + 1])
def test_fdct_kernel_edges(dev, n):
    """Kernel F's both entries at block counts that are not a whole CTA
    step (32 blocks), and on an offset view 8 bytes past a 16-byte
    boundary (the least alignment the wrapper takes); a view 4 bytes past
    one is refused."""
    rng = np.random.default_rng(n)
    buf = torch.from_numpy(rng.integers(0, 256, n * 64 + 16).astype(
        np.uint8)).to(dev)
    pt = buf[8:8 + n * 64].view(n, 64)
    assert pt.data_ptr() % 16 == 8
    zz = torch.as_tensor(ZIGZAG, device=dev).long()
    for qscale in (1, 2):
        q = encoder_qmat(qscale)
        want = F.fdct_quantize_plain(pt, q)
        got_raster = F.fdct_quantize(pt.view(-1, 8, 8), q)
        got_zz = F.fdct_quant_blocks(pt, q)
        torch.cuda.synchronize()
        assert torch.equal(got_raster, want)
        assert torch.equal(got_zz, want[:, zz])
    with pytest.raises(ValueError, match="aligned"):
        F.fdct_quant_blocks(buf[4:4 + n * 64].view(n, 64), q)


def _c_transcode(pays, w, h):
    return [native.ref_encode_frame(*native.ref_decode_frame(p, w, h), 2)
            for p in pays]


@pytest.fixture(scope="module")
def served_clip():
    """48 rotozoom frames of 160x120 and their C reference transcode."""
    pays = _payloads(48, 120, 160, seed=9)
    return pays, _c_transcode(pays, 160, 120)


@pytest.mark.parametrize("batch_frames", [16, 20])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_serving_cuda_matches_whole_file(dev, served_clip, batch_frames,
                                         depth):
    """AsyncTranscoder on CUDA streams gives the whole-file route's bytes
    (transcode_bytes, one batch) and C's, at depths 1, 2 and 4 and at
    batch sizes that divide the 48 frames (16) and that do not (20)."""
    pays, want = served_clip
    data = riff.mux(pays, [], width=160, height=120, fps=16)
    assert riff.demux(P.transcode_bytes(data, device="cuda")).video_chunks \
        == want
    tr = S.AsyncTranscoder(80, batch_frames=batch_frames, depth=depth,
                           size=(160, 120), device=dev)
    assert tr.transcode(pays) == want


@pytest.mark.parametrize("quant", ["ffmpeg", "q60"])
def test_serving_cuda_two_stage_route(dev, quant):
    """The served two-stage route (kernels D, U, V, E) at an odd size,
    with each quantizer, equals the port's CPU route."""
    pays = _payloads(10, 25, 33, seed=4)
    kw = {"batch_frames": 4, "depth": 2, "size": (33, 25), "quant": quant}
    got = S.AsyncTranscoder(6, device=dev, **kw).transcode(pays)
    assert got == S.AsyncTranscoder(6, device="cpu", **kw).transcode(pays)
    if quant == "ffmpeg":
        assert got == _c_transcode(pays, 33, 25)


def test_serving_issue_never_syncs(dev, served_clip):
    """Stage 1 (`issue`: unescape into pinned memory, upload, kernels D, T
    and E's count, the copies of bits and ok) waits on nothing: three
    batches issued under torch.cuda.set_sync_debug_mode("error"), then
    packed and drained outside it."""
    pays, want = served_clip
    tr = S.AsyncTranscoder(80, batch_frames=16, depth=3, size=(160, 120),
                           w_bytes=native.row_stride([len(p) for p in pays]),
                           device=dev)
    tr.transcode(pays)                   # warm: library, buffers, tables
    blob, offsets, sizes = native.tables(pays)
    torch.cuda.set_sync_debug_mode("error")
    try:
        batches = [tr.issue(blob, offsets[16 * k:16 * (k + 1)],
                            sizes[16 * k:16 * (k + 1)]) for k in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = []
    for batch in batches:
        buf, offsets, lens = tr.drain(batch)
        got += [buf[o:o + n].tobytes() for o, n in zip(offsets, lens)]
    assert got == want


@pytest.mark.parametrize("kernel", ["D", "R"])
def test_decode_rounds_per_call_on_two_streams(dev, kernel):
    """Two batches of different frames (160x120 and 320x240) decoded at
    once on two streams each get their own levels and sync rounds back,
    the same as each decoded alone."""
    inputs = []
    for n, (h, w) in ((12, (120, 160)), (7, (240, 320))):
        rows, lens = native.unescape_frames(_payloads(n, h, w, seed=n))
        nb = 6 * ((w + 15) // 16) * ((h + 15) // 16)
        inputs.append((torch.from_numpy(rows).to(dev),
                       torch.from_numpy(lens).to(dev), nb))

    def run(r, ln, nb):
        if kernel == "D":
            return D.decode_scans(r, ln, nb, rounds=True)
        return ER.decode_records(r, ln, nb, 64 * nb, rounds=True)

    alone = [run(*x) for x in inputs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev) for _ in inputs]
    got = []
    for st, x in zip(streams, inputs):
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            got.append(run(*x))
    torch.cuda.synchronize()
    for g, a in zip(got, alone):
        assert all(torch.equal(u, v) for u, v in zip(g, a))
    assert got[0][2].shape == (12,) and got[1][2].shape == (7,)


def test_serving_cuda_malformed_frame_in_batch_two(dev, served_clip):
    """A frame kernel D rejects in the second batch raises ValueError
    naming its index in the stream; the transcoder serves again after."""
    pays = list(served_clip[0][:40])
    pays[21] = b"\xff\xd8" + b"\xff\x00" * 40 + b"\xff\xd9"
    tr = S.AsyncTranscoder(80, batch_frames=16, depth=2, size=(160, 120),
                           device=dev)
    with pytest.raises(ValueError, match=r"frame\(s\) \[21\] of the stream"):
        tr.transcode(pays)
    tr.w_bytes = None
    assert tr.transcode(served_clip[0]) == served_clip[1]


# ------------------------------------------------ ingest: AVI, WAV, -s, -ar

_INGEST_FORMATS = [(b"I420", 12, None), (b"YV12", 12, None),
                   (b"YUY2", 16, None), (b"UYVY", 16, None),
                   (b"Y800", 8, None), (b"DIB ", 8, "pal"),
                   (b"DIB ", 16, None), (b"DIB ", 16, (0xF800, 0x7E0, 0x1F)),
                   (b"DIB ", 24, None), (b"DIB ", 32, None)]


@pytest.mark.parametrize("codec,bits,extra", _INGEST_FORMATS)
def test_extract_yuv420_cuda_matches_cpu(dev, codec, bits, extra):
    """Each raw AVI format unpacked on the card (batches of 2 frames: the
    pinned slots reused) equals the CPU route, at 330 x 24 (BGR24 and pal8
    rows padded)."""
    from amv_tpu_torch.containers import avi
    rng = np.random.default_rng(bits)
    kw = dict(codec=codec, width=330, height=24, bits=bits)
    if extra == "pal":
        kw["palette"] = rng.integers(0, 256, (256, 4), dtype=np.uint8)
    elif extra:
        kw["bitmasks"] = extra
    fb = avi._layout(avi.AviStream("video", **kw))[1]
    kw["chunks"] = [bytes(rng.integers(0, 256, fb, dtype=np.uint8))
                    for _ in range(5)]
    old = avi.BATCH_FRAMES
    avi.BATCH_FRAMES = 2
    try:
        got = avi.extract_yuv420(avi.AviStream("video", **kw), device=dev)
    finally:
        avi.BATCH_FRAMES = old
    want = avi.extract_yuv420(avi.AviStream("video", **kw), device="cpu")
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.parametrize("filt", ["bilinear", "bicubic", "point", "area",
                                  "lanczos", "gauss", "sinc", "spline",
                                  "experimental", "bicublin"])
def test_scale_and_color_cuda_match_cpu(dev, filt):
    from amv_tpu_torch.kernels import color, scale
    rng = np.random.default_rng(3)
    planes = [torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8))
              for s in ((3, 240, 320), (3, 120, 160), (3, 120, 160))]
    for dst in ((120, 160), (144, 176), (360, 480)):
        got = scale.resize_yuv420(*(p.to(dev) for p in planes), *dst,
                                  filt=filt)
        want = scale.resize_yuv420(*planes, *dst, filt=filt)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    rgb = torch.from_numpy(rng.integers(0, 256, (2, 24, 30, 3),
                                        dtype=np.uint8))
    assert all(torch.equal(g.cpu(), w) for g, w in zip(
        color.rgb_to_yuv420_bt601(rgb.to(dev)),
        color.rgb_to_yuv420_bt601(rgb)))
    for mode in ("bt601", "amvlib"):
        assert torch.equal(color.yuv420_to_rgb(
            *(p.to(dev) for p in planes), mode=mode).cpu(),
            color.yuv420_to_rgb(*planes, mode=mode))


@pytest.mark.parametrize("rates", [(44100, 22050), (48000, 22050),
                                   (8000, 22050), (22050, 8000)])
def test_resample_cuda_matches_cpu(dev, rates):
    from amv_tpu_torch.kernels import resample
    x = np.random.default_rng(1).integers(-32768, 32768, 100003).astype(
        np.int16)
    x[:300] = 32767
    x[300:600:2] = -32768
    assert torch.equal(resample.resample_pcm(x, *rates, device=dev).cpu(),
                       resample.resample_pcm(x, *rates, device="cpu"))


def _wav_payload(fmt, ch, rng, blocks=40):
    """(bits, block_align, bytes) of a seeded stream in WAVE format fmt."""
    if fmt == 0x11:
        ba = 2048
        body = b"".join(
            b"".join(struct.pack("<hBB", int(rng.integers(-32768, 32768)),
                                 int(rng.integers(0, 100)), 0)
                     for _ in range(ch)) +
            bytes(rng.integers(0, 256, ba - 4 * ch, dtype=np.uint8))
            for _ in range(blocks))
        return 4, ba, body + body[:ba // 3]          # a short last block
    if fmt == 2:
        ba = 2048
        body = b""
        for _ in range(blocks):
            hdr = bytes(int(rng.integers(0, 7)) for _ in range(ch))
            hdr += b"".join(struct.pack("<h", int(rng.integers(-200, 4000)))
                            for _ in range(ch))
            hdr += b"".join(struct.pack("<h", int(rng.integers(-32768, 32768)))
                            for _ in range(2 * ch))
            body += hdr + bytes(rng.integers(0, 256, ba - 7 * ch,
                                             dtype=np.uint8))
        return 4, ba, body + body[:ba // 3]
    bits = {1: 16, 6: 8, 7: 8}.get(fmt, 8)
    return bits, ch * bits // 8, bytes(rng.integers(0, 256, 40001,
                                                    dtype=np.uint8))


@pytest.mark.parametrize("fmt,bits", [(1, 8), (1, 16), (1, 24), (1, 32),
                                      (6, 8), (7, 8), (0x11, 4), (2, 4)])
@pytest.mark.parametrize("ch", [1, 2])
def test_wav_decodes_cuda_match_cpu(dev, fmt, bits, ch):
    """Each WAVE format decoded on the card equals the CPU route and the
    port's scalar oracle on its first blocks; IMA-WAV launches kernel A."""
    from amv_tpu_torch.codecs import wav_audio
    from amv_tpu_torch.verify import ref_wav_audio
    rng = np.random.default_rng(fmt * 3 + ch)
    _, ba, data = _wav_payload(fmt, ch, rng)
    if fmt == 1:
        ba = ch * bits // 8
    a0 = AQ.DECODE_LAUNCHES
    got = wav_audio.decode_pcm_bytes(data, fmt, bits, ch, ba, device=dev)
    assert (AQ.DECODE_LAUNCHES > a0) == (fmt == 0x11)
    want = wav_audio.decode_pcm_bytes(data, fmt, bits, ch, ba, device="cpu")
    assert torch.equal(got.cpu(), want)
    if fmt in (0x11, 2):
        head = ref_wav_audio.decode_blocks(data[:8 * ba], ch, ba,
                                           "ima" if fmt == 0x11 else "ms")
        n = head.shape[0]
        assert np.array_equal(want.reshape(-1, ch)[:n].numpy(), head)


def test_cli_avi_route_cuda_matches_cpu(dev, tmp_path):
    """The canonical `-i in.avi -f amv -r 16 -s 160x120 -ac 1 -ar 22050` on
    the card: the same bytes as the CPU route, with V, E and Q launched,
    and the video equal to the C encoder on the CPU route's planes."""
    from amv_tpu_torch import cli
    from amv_tpu_torch.containers import avi
    from amv_tpu_torch.kernels import resample, scale
    y, cb, cr = fixtures.videogen(20, 240, 320, seed=4)
    pcm = fixtures.audiogen(20 / 16, 44100, seed=4)
    src = tmp_path / "in.avi"
    src.write_bytes(avi.mux(y, cb[:, :120, :160], cr[:, :120, :160], pcm,
                            fps=16, sample_rate=44100))
    argv = ["-i", str(src), "-f", "amv", "-r", "16", "-s", "160x120", "-ac",
            "1", "-ar", "22050"]
    launches = (V.LAUNCHES, E.LAUNCHES, AQ.ENCODE_LAUNCHES)
    assert cli.main([*argv, str(tmp_path / "gpu.amv"), "--device", "cuda"]) \
        == 0
    assert all(b > a for a, b in zip(launches, (V.LAUNCHES, E.LAUNCHES,
                                                AQ.ENCODE_LAUNCHES)))
    assert cli.main([*argv, str(tmp_path / "cpu.amv"), "--device", "cpu"]) \
        == 0
    got = (tmp_path / "gpu.amv").read_bytes()
    assert got == (tmp_path / "cpu.amv").read_bytes()
    planes = scale.resize_yuv420(*(torch.from_numpy(np.ascontiguousarray(p))
                                   for p in (y, cb[:, :120, :160],
                                             cr[:, :120, :160])), 120, 160)
    s = riff.demux(got)
    assert s.video_chunks == [native.ref_encode_frame(
        *(p[i].numpy() for p in planes), 2) for i in range(20)]
    want_pcm = resample.resample_pcm(pcm, 44100, 22050, device="cpu")
    assert s.audio_chunks == ref_adpcm.encode(want_pcm.numpy(), 1378, 22050)


# ------------------------------------------------ kernel L and the MJPEG path

def _trellis_stream(seconds, rate, fps, seed):
    """(x, starts, pairs, ns, starts_np) of a seeded sine + noise stream in
    the encoder's chunk layout."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n)
    x = np.clip(12000 * np.sin(t * 0.031) * (0.3 + 0.7 * np.abs(
        np.sin(t * 0.0007))) + rng.normal(0, 400, n), -32768,
        32767).astype(np.int16)
    ns, starts, padded, _ = amv_audio.stream_layout(
        x, PE.av_rescale_near(rate, 1, fps), rate)
    return (torch.from_numpy(padded), torch.from_numpy(starts),
            torch.tensor(ns, dtype=torch.int32), ns, starts)


@pytest.mark.parametrize("rate,fps,start", [(22050, 16, "spread"),
                                            (44100, 12, "spread"),
                                            (22050, 16, "zero"),
                                            (22050, 16, "top"),
                                            (22050, 16, "random"),
                                            (44100, 12, "random")])
def test_trellis_kernel_matches_plain(dev, rate, fps, start):
    """Kernel L from given starts (0..88 spread over the chunks, all 0, all
    88, seeded random) against its plain version: bytes and final
    states."""
    from amv_tpu_torch.kernels import adpcm_trellis as L
    x, st, pairs, ns, _ = _trellis_stream(2.0, rate, fps, seed=rate + fps)
    c = len(ns)
    step = {"spread": torch.arange(c) * 37 % 89, "zero": torch.zeros(c),
            "top": torch.full((c,), 88),
            "random": torch.from_numpy(np.random.default_rng(c).integers(
                0, 89, c))}[start].to(torch.int32)
    pred = x[st].to(torch.int32)
    want = torch.full((x.numel() // 2,), 0xA5, dtype=torch.uint8)
    fw = L.trellis_chunks_plain(x, st, pairs, step, pred, want)
    got = want.new_full(want.shape, 0xA5).to(dev)
    l0 = L.LAUNCHES
    fg = L.trellis_chunks(*(t.to(dev) for t in (x, st, pairs, step, pred)),
                          got)
    torch.cuda.synchronize()
    assert L.LAUNCHES == l0 + 1
    assert torch.equal(fg.cpu(), fw) and torch.equal(got.cpu(), want)


def test_trellis_encode_stream_cuda_matches_cpu(dev):
    """encode_stream(trellis=True) on the card (Q's guesses, L's chain) is
    the CPU route's bytes, from the right and from a wrong guess, and its
    chain holds at the fixed point."""
    from amv_tpu_torch.kernels import adpcm_trellis as L
    x, st, pairs, ns, _ = _trellis_stream(1.0, 22050, 16, seed=5)
    pcm = x.numpy()[:22050]
    want = amv_audio.encode_stream(pcm, 1378, 22050, trellis=True,
                                   device="cpu")
    assert amv_audio.encode_stream(pcm, 1378, 22050, trellis=True,
                                   device=dev) == want
    truth = torch.tensor([int.from_bytes(c[2:4], "little") for c in want],
                         dtype=torch.int32, device=dev)
    out, step, final, rounds = L.encode_chain(
        x.to(dev), st.to(dev), pairs.to(dev), 0, (truth + 1) % 89,
        rounds=True)
    assert torch.equal(step, truth) and torch.equal(step[1:], final[:-1])
    assert rounds >= 2


def test_ms_kernel_matches_plain(dev):
    """Kernel M against its plain version at 1,040 lanes of 2,034 samples
    (a 44,100 Hz stereo MS-ADPCM stream's lanes at block_align 2,048),
    with lanes at the int32 extremes of idelta and the nibble 8 that grows
    it until the products wrap; launched once."""
    rng = np.random.default_rng(13)
    b, n = 1040, 2034
    nib = rng.integers(0, 16, (b, n)).astype(np.uint8)
    st = [rng.choice([256, 512, 0, 192, 240, 460, 392], b),
          rng.choice([0, -256, 0, 64, 0, -208, -232], b),
          rng.integers(-300, 5000, b), rng.integers(-32768, 32768, b),
          rng.integers(-32768, 32768, b)]
    nib[:3] = 8
    st[2][:3] = [2 ** 30, -2 ** 31, 2 ** 31 - 1]
    args = [torch.from_numpy(nib)] + [torch.from_numpy(
        np.asarray(v, np.int32)) for v in st]
    want = AQ.decode_ms_nibbles_plain(*args)
    m0 = AQ.MS_LAUNCHES
    got = AQ.decode_ms_nibbles(*(t.to(dev) for t in args))
    torch.cuda.synchronize()
    assert AQ.MS_LAUNCHES == m0 + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_decode_ms_cuda_matches_cpu(dev, channels):
    """codecs.wav_audio.decode_ms on the card (kernel M) equals the CPU
    route (the plain loop), a short last block included."""
    from amv_tpu_torch.codecs import wav_audio
    rng = np.random.default_rng(channels)
    ba = 512
    blocks = rng.integers(0, 256, (40, ba), dtype=np.uint8)
    blocks[:, :channels] = rng.integers(0, 7, (40, channels))
    blocks[:, channels:3 * channels] = rng.integers(
        -200, 4000, (40, channels)).astype("<i2").view(np.uint8)
    data = blocks.tobytes()[:-100]
    m0 = AQ.MS_LAUNCHES
    got = wav_audio.decode_ms(data, channels, ba, device=dev)
    assert AQ.MS_LAUNCHES > m0
    want = wav_audio.decode_ms(data, channels, ba, device="cpu")
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("layout,ri", [("420", 0), ("422", 5), ("444", 1),
                                       ("gray", 0), ("422", 0)])
def test_mjpeg_cuda_matches_cpu(dev, layout, ri):
    """encode_mjpeg_frames and decode_mjpeg_frames on the card (V and E,
    or F and the C packer; D or the C decoder, then I) equal the CPU
    route, at 320x240 with 8 frames; F and I launched where they run."""
    from amv_tpu_torch.codecs import mjpeg as M
    rng = np.random.default_rng(len(layout) + ri)
    y = rng.integers(0, 256, (8, 240, 320), dtype=np.uint8)
    cshape = {"420": (8, 120, 160), "422": (8, 240, 160),
              "444": (8, 240, 320), "gray": (8, 1, 1)}[layout]
    cb = rng.integers(0, 256, cshape, dtype=np.uint8)
    chroma = (None, None) if layout == "gray" else (cb, 255 - cb)
    f0, i0 = F.LAUNCHES, I.LAUNCHES
    pays = M.encode_mjpeg_frames(y, *chroma, subsampling=layout,
                                 restart_interval=ri, device=dev)
    assert (F.LAUNCHES > f0) == (layout != "420" or ri != 0)
    assert pays == M.encode_mjpeg_frames(y, *chroma, subsampling=layout,
                                         restart_interval=ri, device="cpu")
    got = M.decode_mjpeg_frames(pays, device=dev, batch_frames=5)
    assert I.LAUNCHES >= i0 + 2
    want = M.decode_mjpeg_frames(pays, device="cpu")
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert torch.equal(g.cpu(), w)


def test_idct_put_and_fdct_quantize_at_mjpeg_shapes(dev):
    """I's idct_put and F's fdct_quantize at the MJPEG path's shapes (a
    batch of 64 320x240 4:2:2 frames: 153,600 blocks) against their plain
    versions, extreme coefficients included."""
    rng = np.random.default_rng(12)
    coef = rng.integers(-2048, 2048, (64, 600, 4, 8, 8)).astype(np.int16)
    coef[0, 0] = 32767
    coef[0, 1] = -32768
    ct = torch.from_numpy(coef)
    assert torch.equal(I.idct_put(ct.to(dev)).cpu(), I.idct_put(ct))
    pix = torch.from_numpy(rng.integers(0, 256, (64, 600, 4, 8, 8),
                                        dtype=np.uint8))
    q = encoder_qmat(2)
    assert torch.equal(F.fdct_quantize(pix.to(dev), q).cpu(),
                       F.fdct_quantize(pix, q))


def _sof2_sof3_frames(n, h, w, seed):
    """n seeded pictures as progressive (SOF2: the coefficients of the
    port's baseline encode, DC made absolute, Al 1 and refinement scans)
    and lossless (SOF3) 4:2:0 frames, the lossless ones also in RGB mode."""
    from amv_tpu_torch.bitstream import jpeg_lossless as PL
    from amv_tpu_torch.bitstream import jpeg_progressive as PP
    from amv_tpu_torch.codecs import mjpeg as M
    y, cb, cr = fixtures.videogen(n, h, w, seed=seed)
    cb, cr = cb[:, :h // 2, :w // 2], cr[:, :h // 2, :w // 2]
    blocks = M.extract_blocks_topdown(
        *(torch.from_numpy(np.ascontiguousarray(p)) for p in (y, cb, cr)),
        "420", (w + 15) // 16, (h + 15) // 16)
    lv = F.fdct_quantize(blocks.contiguous(), encoder_qmat(2))
    lv = lv[..., torch.as_tensor(ZIGZAG).long()].numpy().copy()
    lv[..., 0] -= 128
    prog = [PP.encode_progressive(f, (w, h)) for f in lv]
    ll = [PL.encode_lossless([y[i], cb[i], cr[i]], predictor=1 + i % 7)
          for i in range(n)]
    rgb = [PL.encode_lossless([y[i], y[i][::-1], y[i][:, ::-1]],
                              predictor=4, rgb=True, rct=i % 2 == 0)
           for i in range(n)]
    return y, cb, cr, prog, ll, rgb


def test_progressive_lossless_cuda_match_cpu(dev, tmp_path):
    """Progressive (SOF2) and lossless (SOF3) MJPEG input on the card:
    decode_mjpeg_frames' and decode_lossless_frames' planes (I launched
    for SOF2, none of I for SOF3) and the canonical `-f amv` conversion's
    bytes equal the CPU route's, for each stream, an RGB-mode one
    included."""
    from amv_tpu_torch import cli
    from amv_tpu_torch.codecs import mjpeg as M
    from amv_tpu_torch.containers import avi
    y, cb, cr, prog, ll, rgb = _sof2_sof3_frames(12, 240, 320, seed=18)
    for frames, kernel_i in ((prog, True), (ll, False)):
        i0 = I.LAUNCHES
        got = M.decode_mjpeg_frames(frames, device=dev, batch_frames=5)
        assert (I.LAUNCHES > i0) == kernel_i
        want = M.decode_mjpeg_frames(frames, device="cpu")
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    got = M.decode_lossless_frames(rgb, device=dev, batch_frames=5)
    want = M.decode_lossless_frames(rgb, device="cpu")
    assert got[0] == want[0] == "rgb"
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got[1], want[1]))
    pcm = fixtures.audiogen(12 / 16, 44100, seed=18)
    for name, frames in (("prog", prog), ("ll", ll), ("rgb", rgb)):
        src = tmp_path / f"{name}.avi"
        src.write_bytes(avi.mux(y, cb, cr, pcm, fps=16, sample_rate=44100,
                                video_chunks=frames))
        argv = ["-i", str(src), "-f", "amv", "-r", "16", "-s", "160x120",
                "-ac", "1", "-ar", "22050"]
        v0 = V.LAUNCHES
        for d in ("cuda", "cpu"):
            assert cli.main([*argv, str(tmp_path / f"{d}.amv"), "--device",
                             d]) == 0
        assert V.LAUNCHES > v0
        assert (tmp_path / "cuda.amv").read_bytes() == \
            (tmp_path / "cpu.amv").read_bytes(), name


def test_idct_put_at_progressive_shape(dev):
    """I's idct_put at the progressive path's shape (a batch of 1,024
    320x240 4:2:0 frames: 1,843,200 blocks) against its plain version,
    dequantized with the absolute DC, extreme coefficients included."""
    from amv_tpu_torch.codecs import mjpeg as M
    rng = np.random.default_rng(18)
    lv = torch.from_numpy(rng.integers(-300, 301, (1024, 300, 6, 64))
                          .astype(np.int16))
    lv[0, 0, :, 0] = 32767
    qm = np.tile(encoder_quant_matrix(2)[ZIGZAG], (6, 1))
    coef = M.dequantize(lv.to(dev), qm, "420", dc_absolute=True)
    assert torch.equal(coef.cpu(), M.dequantize(lv, qm, "420",
                                                dc_absolute=True))
    assert torch.equal(I.idct_put(coef).cpu(), I.idct_put(coef.cpu()))


def test_ms_kernel_matches_plain_odd_rows(dev):
    """Kernel M at a second shape: 333 lanes of an odd 4,091 samples
    (rows at every byte offset from a word, 16-bit stores, a tail of 11),
    from an offset view of the nibbles, against its plain version."""
    rng = np.random.default_rng(14)
    b, n = 333, 4091
    nib = rng.integers(0, 16, (b, n + 1)).astype(np.uint8)
    st = [rng.choice([256, 512, 0, 192, 240, 460, 392], b),
          rng.choice([0, -256, 0, 64, 0, -208, -232], b),
          rng.integers(16, 5000, b), rng.integers(-32768, 32768, b),
          rng.integers(-32768, 32768, b)]
    args = [torch.from_numpy(nib[:, 1:])] + [torch.from_numpy(
        np.asarray(v, np.int32)) for v in st]
    want = AQ.decode_ms_nibbles_plain(*args)
    m0 = AQ.MS_LAUNCHES
    got = AQ.decode_ms_nibbles(*(t.to(dev) for t in args))
    torch.cuda.synchronize()
    assert AQ.MS_LAUNCHES == m0 + 1
    assert torch.equal(got.cpu(), want)


def _g729_frames(t, b, seed):
    """Seeded frames: erasures, bad parity, high and low pitch codes;
    stream 1 erased for its first 3 frames and at the largest pitch gain
    (its LP synthesis overflows), stream 2 with P1 = 0 (lag 19)."""
    rng = np.random.default_rng(seed)
    frames = fixtures.g729_frames(rng, t, b, erasure=0.02, bad_parity=0.02,
                                  high_pitch=0.1, low_pitch=0.1)
    fixtures.g729_loud(frames[:, 1])
    frames[:3, 1] = 0
    fixtures.g729_set_field(frames[2, 2], 18, 8, 0)
    fixtures.g729_set_field(frames[2, 2], 26, 1, 1)
    return frames


def test_g729_kernel_matches_plain(dev):
    """Kernel G (decode_frames_scan on CUDA tensors, one launch) against
    its plain version on the CPU: 67 streams x 24 frames, PCM and every
    state field; then two windows on the card from G's own state equal one
    launch over both."""
    from amv_tpu_torch.codecs import g729a as G
    from amv_tpu_torch.kernels import g729 as K
    frames = _g729_frames(24, 67, 0)
    parms = G.unpack_frames(frames)
    want_st, want = G.decode_frames_scan(G.init_state(67, device="cpu"), parms)
    g0 = K.LAUNCHES
    st, pcm = G.decode_frames_scan(G.init_state(67, device=dev), parms.to(dev))
    torch.cuda.synchronize()
    assert K.LAUNCHES == g0 + 1
    assert torch.equal(pcm.cpu(), want)
    for k, _ in G.STATE_FIELDS:
        assert torch.equal(st[k].cpu(), want_st[k]), k
    sa, pa = G.decode_frames_scan(G.init_state(67, device=dev),
                                  parms[:9].to(dev))
    sb, pb = G.decode_frames_scan(sa, parms[9:].to(dev))
    assert torch.equal(torch.cat([pa, pb]).cpu(), want)
    for k, _ in G.STATE_FIELDS:
        assert torch.equal(sb[k].cpu(), want_st[k]), k


def test_g729_decode_streams_long_stream(dev):
    """decode_streams on the card: one stream of 600 frames (a launch of
    one warp) equals the same frames as stream 0 of a batch of 40 (a
    launch of 40), and the first 16 frames equal the oracle copy."""
    from amv_tpu_torch.codecs import g729a as G
    from amv_tpu_torch.verify import ref_g729
    frames = _g729_frames(600, 40, 1)
    frames[:3, 0] = fixtures.g729_frames(np.random.default_rng(2), 3, 1)[:, 0]
    one = G.decode_streams(torch.from_numpy(frames[:, :1].copy()).to(dev))
    many = G.decode_streams(torch.from_numpy(frames).to(dev))
    assert torch.equal(one[0], many[0])
    dec = ref_g729.G729Decoder()
    want = np.concatenate([dec.decode_frame(f.tobytes())
                           for f in frames[:16, 0]])
    assert np.array_equal(one[0, :16 * 80].cpu().numpy(), want)


def test_cli_act_cuda_matches_cpu(dev, tmp_path):
    """cli.main -i rec.act out.wav on the card (kernel G, one launch)
    writes the CPU route's bytes; out.bit needs no decode."""
    from amv_tpu_torch import cli
    from amv_tpu_torch.containers import act
    from amv_tpu_torch.kernels import g729 as K
    src = tmp_path / "rec.act"
    frames = _g729_frames(120, 3, 3)[:, 1]
    frames[0] = fixtures.g729_frames(np.random.default_rng(4), 1, 1)[0, 0]
    src.write_bytes(act.mux(frames))
    g0 = K.LAUNCHES
    assert cli.main(["-i", str(src), str(tmp_path / "g.wav")]) == 0
    assert K.LAUNCHES == g0 + 1
    assert cli.main(["-i", str(src), str(tmp_path / "c.wav"),
                     "--device", "cpu"]) == 0
    assert (tmp_path / "g.wav").read_bytes() == \
        (tmp_path / "c.wav").read_bytes()
    assert cli.main(["-i", str(src), str(tmp_path / "g.bit")]) == 0
    assert K.LAUNCHES == g0 + 1
    assert (tmp_path / "g.bit").read_bytes() == act.to_itu_bitstream(
        act.demux(src.read_bytes())[0])


def test_g729_kernel_past_one_wave_matches_plain(dev):
    """Kernel G with more streams than the card holds at 4 CTAs an SM
    (the launch takes its build at 64 registers a thread): 4 x SMs + 7
    streams x 5 frames against the plain version, PCM and state."""
    from amv_tpu_torch.codecs import g729a as G
    b = 4 * torch.cuda.get_device_properties(dev).multi_processor_count + 7
    parms = G.unpack_frames(_g729_frames(5, b, 7))
    want_st, want = G.decode_frames_scan(G.init_state(b, device="cpu"), parms)
    st, pcm = G.decode_frames_scan(G.init_state(b, device=dev), parms.to(dev))
    assert torch.equal(pcm.cpu(), want)
    for k, _ in G.STATE_FIELDS:
        assert torch.equal(st[k].cpu(), want_st[k]), k


def test_g729_kernel_one_stream_6000_frames(dev):
    """Kernel G at one stream over 6,000 frames (its pipeline's latency
    path) in one launch equals the same stream decoded in three windows
    (each from the state the last returned) and its first 24 frames equal
    the plain version's, PCM and state."""
    from amv_tpu_torch.codecs import g729a as G
    frames = _g729_frames(6000, 3, 5)[:, 1:2].copy()
    parms = G.unpack_frames(torch.from_numpy(frames).to(dev))
    st, pcm = G.decode_frames_scan(G.init_state(1, device=dev), parms)
    sw, parts = G.init_state(1, device=dev), []
    for lo, hi in ((0, 7), (7, 3001), (3001, 6000)):
        sw, p = G.decode_frames_scan(sw, parms[lo:hi])
        parts.append(p)
    assert torch.equal(torch.cat(parts), pcm)
    for k, _ in G.STATE_FIELDS:
        assert torch.equal(sw[k], st[k]), k
    want_st, want = G.decode_frames_scan(G.init_state(1, device="cpu"),
                                         parms[:24].cpu())
    s24, p24 = G.decode_frames_scan(G.init_state(1, device=dev), parms[:24])
    assert torch.equal(p24.cpu(), want) and torch.equal(pcm[:24].cpu(), want)
    for k, _ in G.STATE_FIELDS:
        assert torch.equal(s24[k].cpu(), want_st[k]), k


def test_g729_encode_kernel_matches_plain(dev):
    """Kernel K (encode_frames_scan on CUDA tensors, one launch) against
    its plain version on the card: 19 seeded speech streams x 6 frames,
    parameters, state and hist bit for bit; then a second launch from K's
    state equals the plain step from the same state; and G decodes K's
    frames to K's shadow state."""
    from amv_tpu_torch.codecs import g729a as G
    from amv_tpu_torch.codecs import g729a_encoder_batch as E
    from amv_tpu_torch.kernels import g729 as K
    b, t = 19, 6
    sig = fixtures.speech_streams(b, 2 * t * 80, 6).astype(np.float32)
    frames = torch.from_numpy(np.ascontiguousarray(
        sig.reshape(b, 2 * t, 80).transpose(1, 0, 2))).to(dev)
    st0, h0 = G.init_state(b, device=dev), torch.zeros((b, 160), device=dev)
    k0 = K.ENCODE_LAUNCHES
    st, h, parms = E.encode_frames_scan(st0, h0, frames[:t])
    torch.cuda.synchronize()
    assert K.ENCODE_LAUNCHES == k0 + 1
    sp, hp, want = st0, h0, []
    for i in range(t):
        sp, hp, p = E.encode_frame_batch(sp, hp, frames[i])
        want.append(p)
    assert torch.equal(parms, torch.stack(want))
    assert torch.equal(h, hp)
    for k, _ in G.STATE_FIELDS:
        assert torch.equal(st[k], sp[k]), k
    st2, h2, parms2 = E.encode_frames_scan(st, h, frames[t:t + 2])
    for i in range(2):
        sp, hp, p = E.encode_frame_batch(sp, hp, frames[t + i])
        assert torch.equal(parms2[i], p), i
    packed = E.pack_frames(torch.cat([parms, parms2]))
    dst, _ = G.decode_frames_scan(G.init_state(b, device=dev),
                                  G.unpack_frames(packed))
    for k in E.TRACKED:
        assert torch.equal(dst[k], st2[k]), k


@pytest.mark.parametrize("streams", ["3", "4 x SMs + 5", "8 x SMs + 7"])
def test_g729_encode_kernel_builds_match_plain(dev, streams):
    """Kernel K at stream counts that pick each of its builds and leave a
    wave part full: 3 streams (128 threads a stream, far from a wave),
    4 x SMs + 5 (past the 128-thread build's one wave at 4 CTAs an SM, so
    64 threads, one wave part full) and 8 x SMs + 7 (past the 64-thread
    build's one wave at 8 CTAs an SM): seeded speech x 3 frames against
    the plain version on the card, parameters, state and hist bit for bit,
    and a window from K's state equal to one launch over both."""
    from amv_tpu_torch.codecs import g729a as G
    from amv_tpu_torch.codecs import g729a_encoder_batch as Enc
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b = {"3": 3, "4 x SMs + 5": 4 * sms + 5, "8 x SMs + 7": 8 * sms + 7}[
        streams]
    t = 3
    sig = fixtures.speech_streams(b, t * 80, 9).astype(np.float32)
    frames = torch.from_numpy(np.ascontiguousarray(
        sig.reshape(b, t, 80).transpose(1, 0, 2))).to(dev)
    st0, h0 = G.init_state(b, device=dev), torch.zeros((b, 160), device=dev)
    st, h, parms = Enc.encode_frames_scan(st0, h0, frames)
    sp, hp, want = st0, h0, []
    for i in range(t):
        sp, hp, p = Enc.encode_frame_batch(sp, hp, frames[i])
        want.append(p)
    assert torch.equal(parms, torch.stack(want))
    assert torch.equal(h.view(torch.int32), hp.view(torch.int32))
    for k, _ in G.STATE_FIELDS:
        assert torch.equal(st[k], sp[k]), k
    sa, ha, pa = Enc.encode_frames_scan(st0, h0, frames[:1])
    sb, hb, pb = Enc.encode_frames_scan(sa, ha, frames[1:])
    assert torch.equal(torch.cat([pa, pb]), parms)
    assert torch.equal(hb.view(torch.int32), h.view(torch.int32))
    for k, _ in G.STATE_FIELDS:
        assert torch.equal(sb[k], st[k]), k


@pytest.mark.parametrize("h,w", [(120, 160), (98, 174), (32, 40),
                                 (240, 320)])
def test_yuv2rgb_kernel_matches_plain(dev, h, w):
    """Kernel Y in every format (and the 16-bit formats undithered, the
    limited range, keys of brightness, contrast and saturation that its
    computed path takes for some formats and that leave it for others)
    against its plain version; 174 wide leaves a short last group of 8
    pixels and odd row strides."""
    from amv_tpu_torch.kernels import yuv2rgb_dither as Y
    rng = np.random.default_rng(h + w)
    planes = [torch.from_numpy(rng.integers(0, 256, (5, hh, ww), np.uint8))
              for hh, ww in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    planes[0][0] = 255
    planes[1][1] = 0
    on = [p.to(dev) for p in planes]
    l0 = Y.LAUNCHES
    n = 0
    for fmt in Y._FORMATS:
        if fmt == "monoblack" and w % 8:
            continue
        for kw in ({}, {"dither": False}, {"full_range": False},
                   {"brightness": 64, "contrast": 80000, "saturation": 90000},
                   {"full_range": False, "brightness": -50,
                    "contrast": 40000, "saturation": 30000},
                   {"contrast": 2 ** 20, "saturation": 2 ** 20}):
            got = Y.yuv420_to_packed(*on, fmt=fmt, **kw)
            want = Y.yuv420_to_packed_plain(*planes, fmt=fmt, **kw)
            torch.cuda.synchronize()
            assert got.dtype == want.dtype, fmt
            assert torch.equal(got.cpu(), want), (fmt, kw)
            n += 1
    assert Y.LAUNCHES - l0 == n


def test_sharded_functions_match_single_device_on_a_virtual_mesh(dev):
    """Every sharded_* of parallel/sharding.py on 4 positions of the card
    (dp 2 x sp 2, a stream each) against the single-device function, bit
    for bit (chip_smoke.py's phase 19 checks, at 64 frames of 160x120)."""
    import chip_smoke
    from amv_tpu_torch.parallel import sharding
    m = chip_smoke.import_port()
    mesh = sharding.make_mesh(["cuda:0"] * 4)
    done = chip_smoke.mesh_checks(m, mesh, _payloads(64, 120, 160),
                                  np.random.default_rng(0))
    assert len(done) == 14


def test_serving_mesh_matches_single_device(dev):
    """AsyncTranscoder over a mesh of 2 positions of the card: the single
    device's bytes and C's, over batches with a short last one."""
    from amv_tpu_torch.parallel import sharding
    pays = _payloads(100, 120, 160, seed=3)
    kw = dict(batch_frames=32, depth=2, size=(160, 120))
    one = S.AsyncTranscoder(80, 2, device="cuda", **kw).transcode(pays)
    got = S.AsyncTranscoder(80, 2, mesh=sharding.make_mesh(["cuda:0"] * 2),
                            **kw).transcode(pays)
    assert got == one == [native.ref_encode_frame(
        *native.ref_decode_frame(p, 160, 120), 2) for p in pays]


def test_launch_guard_follows_the_tensors(dev):
    """With card 0 current, a kernel given tensors of card 1 runs there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    lv = torch.from_numpy(_random_levels(np.random.default_rng(0), 600))
    dc = torch.zeros(600, dtype=torch.int32)
    want = I.idct_blocks_plain(lv, dc)
    with torch.cuda.device(0):
        got = I.idct_blocks(lv.to("cuda:1"), dc.to("cuda:1"))
    assert got.device == torch.device("cuda", 1)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("w,h,f", [(160, 120, 40), (25, 33, 7),
                                   (48, 32, 300)])
def test_amvlib_kernel_matches_plain(dev, w, h, f):
    """Kernel W, both entries, on random levels with some large DCs (the
    int32 wrap of the row pass)."""
    from amv_tpu_torch.codecs import amvlib_video as AV
    rng = np.random.default_rng(w * h)
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    lv = np.zeros((f, mb_w * mb_h, 6, 64), np.int16)
    mask = rng.random(lv.shape) < 0.2
    lv[mask] = rng.integers(-80, 81, mask.sum())
    lv[..., 0] = rng.integers(-300, 301, lv.shape[:3])
    lv[0, :, :, 0] = 32000
    lv[0, :, :, 1:4] = rng.integers(-32768, 32768, lv[0, :, :, 1:4].shape)
    lvt = torch.from_numpy(lv)
    want = AV.decode_transform_amvlib(lvt, mb_w, mb_h, w, h)
    got = AV.decode_transform_amvlib(lvt.to(dev), mb_w, mb_h, w, h)
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert torch.equal(g.cpu(), x)
    if w % 2 == 0 and h % 2 == 0:
        rgb = AV.decode_rgb_amvlib(lvt.to(dev), w, h)
        assert torch.equal(rgb.cpu(), AV.decode_rgb_amvlib(lvt, w, h))


def _pixel_clip(tmp_path, n=20, h=120, w=160):
    rng = np.random.default_rng(9)
    y, cb, cr = fixtures.rotozoom(n, h, w)
    y = np.clip(y.astype(np.int16) + rng.integers(-6, 7, y.shape), 0,
                255).astype(np.uint8)
    src = tmp_path / "in.amv"
    src.write_bytes(PE.encode_to_bytes(y, cb, cr,
                                       fixtures.audiogen(n / 16, seed=9),
                                       device="cpu"))
    return str(src)


def test_cli_pixel_routes_cuda_match_cpu(dev, tmp_path):
    """Every -pix_fmt to .raw and .bmp under both --color values through
    cli.main on the card: D, U and Y (or color) launched, bytes equal to the
    CPU route's."""
    from amv_tpu_torch import cli
    from amv_tpu_torch.kernels import yuv2rgb_dither as Y
    src = _pixel_clip(tmp_path)
    for fmt in cli._PIX_FMTS:
        outs = []
        for d in ("cuda", "cpu"):
            out = tmp_path / f"{fmt}_{d}.raw"
            y0, u0 = Y.LAUNCHES, U.LAUNCHES
            assert cli.main(["-i", src, "-pix_fmt", fmt, str(out),
                             "--device", d]) == 0
            if d == "cuda":
                assert U.LAUNCHES > u0
                assert (Y.LAUNCHES > y0) == (fmt not in ("yuyv422",
                                                         "uyvy422"))
            outs.append(out.read_bytes())
        assert outs[0] == outs[1], fmt
    for color in ("bt601", "amvlib"):
        for d in ("cuda", "cpu"):
            assert cli.main(["-i", src, "--color", color,
                             str(tmp_path / d / "f_%02d.bmp"), "--device",
                             d]) == 0
        for name in sorted(os.listdir(tmp_path / "cpu")):
            assert (tmp_path / "cuda" / name).read_bytes() == \
                (tmp_path / "cpu" / name).read_bytes()


def test_amvlib_api_cuda_matches_cpu(dev, tmp_path):
    """AmvOpen on the card (the default): AmvVideoDecode through D and W,
    AmvAudioDecode through A, equal to device="cpu"."""
    from amv_tpu_torch import amvlib_api as A
    from amv_tpu_torch.codecs import amvlib_video as AV
    src = _pixel_clip(tmp_path, n=6)
    amv, ref = A.AmvOpen(src), A.AmvOpen(src, device="cpu")
    assert amv.device.type == "cuda"
    w0 = AV.LAUNCHES
    for _ in range(6):
        assert A.AmvReadNextFrame(amv) == A.AmvReadNextFrame(ref) == 0
        assert A.AmvVideoDecode(amv) == A.AmvVideoDecode(ref) == 0
        assert A.AmvAudioDecode(amv) == A.AmvAudioDecode(ref) == 0
        np.testing.assert_array_equal(amv.videobuf, ref.videobuf)
        np.testing.assert_array_equal(amv.audiobuf, ref.audiobuf)
    assert AV.LAUNCHES - w0 == 6
    assert A.AmvCreateWavFileFromAmvFile(amv, 0, str(tmp_path / "a.wav")) \
        == A.AmvCreateWavFileFromAmvFile(ref, 0, str(tmp_path / "b.wav")) == 0
    assert (tmp_path / "a.wav").read_bytes() == \
        (tmp_path / "b.wav").read_bytes()
