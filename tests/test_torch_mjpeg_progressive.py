"""The port's progressive (SOF2) MJPEG input on the CPU against the JAX
package: `bitstream.jpeg_progressive.encode_progressive`'s bytes,
`decode_progressive`'s levels through the C pass and through the Python
scan loop (and the C-then-Python fallback), `codecs.mjpeg.
decode_mjpeg_frames`' planes (mixed baseline and progressive batches,
per-scan table redefinition, a PIL progressive file), the tables and
block maps the codec carries, and parity on the JAX package's fuzz
mutants.  Inputs are made with numpy from seeds.  Tolerance: exact
equality.
"""

import io
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from amv_tpu.bitstream import jpeg_progressive as JP  # noqa: E402
from amv_tpu.bitstream import jpeg_tables as JT  # noqa: E402
from amv_tpu.codecs.amv_video import _encoder_quant_matrix  # noqa: E402
from amv_tpu.codecs import mjpeg as JM  # noqa: E402
from amv_tpu.verify import ref_jpeg as JR  # noqa: E402
from amv_tpu_torch.bitstream import jpeg_progressive as PP  # noqa: E402
from amv_tpu_torch.codecs import mjpeg as MJ  # noqa: E402

_MCU = {"420": (16, 16), "422": (16, 8), "444": (8, 8), "gray": (8, 8)}
_SAMP = {"420": (2, 2), "422": (2, 1), "444": (1, 1), "gray": (1, 1)}


class _Frame:
    def __init__(self, layout, w, h):
        self.width, self.height = w, h
        s = _SAMP[layout]
        self.components = [(1, s[0], s[1], 0)] + \
            ([(2, 1, 1, 0), (3, 1, 1, 0)] if layout != "gray" else [])


def _levels(layout, w, h, seed, ac_range=80):
    """Seeded zigzag levels [M, nb, 64] (absolute DC) with sparse AC, some
    all-zero AC blocks, and no AC in the MCU padding blocks that
    non-interleaved scans never code (T.81 A.2.3)."""
    mcu_w, mcu_h = _MCU[layout]
    m = ((w + mcu_w - 1) // mcu_w) * ((h + mcu_h - 1) // mcu_h)
    nb = len(MJ.COMP_OF_BLOCK[layout])
    rng = np.random.default_rng(seed)
    lv = np.zeros((m, nb, 64), np.int16)
    lv[:, :, 0] = rng.integers(-40, 41, (m, nb))
    lv[:, :, 1:] = np.where(rng.random((m, nb, 63)) < 0.12,
                            rng.integers(-ac_range, ac_range + 1,
                                         (m, nb, 63)), 0)
    lv[:, :, 1:] *= (rng.random((m, nb)) >= 0.3)[:, :, None]
    coded = np.zeros((m, nb), bool)
    for bm in PP._block_index_maps(_Frame(layout, w, h)):
        for mi, s in bm.reshape(-1, 2):
            if mi >= 0:
                coded[mi, s] = True
    lv[:, :, 1:] *= coded[:, :, None]
    return lv


def _baseline(lv, layout, w, h):
    """A baseline frame of the same coefficients (its DC chain starts at
    128 against the progressive frame's absolute DC)."""
    base = lv.copy()
    base[:, :, 0] += 128
    return JM._jpeg_header_with_tables(
        w, h, _encoder_quant_matrix(2)[JT.ZIGZAG], layout=layout) + \
        JM._pack_scan_generic(base, JM._COMP_OF_BLOCK[layout], 0) + \
        b"\xFF\xD9"


CASES = [("420", (48, 32), (1, 1)), ("420", (28, 20), (0, 0)),
         ("420", (32, 32), (2, 2)), ("420", (32, 32), (1, 3)),
         ("422", (44, 24), (1, 1)), ("444", (24, 24), (2, 2)),
         ("444", (20, 12), (1, 1)), ("gray", (28, 20), (1, 3)),
         ("gray", (13, 9), (0, 0))]


@pytest.mark.parametrize("layout,wh,al", CASES)
def test_encode_and_decode_match_jax(layout, wh, al):
    """encode_progressive's bytes and decode_progressive's levels, through
    the C pass and through the Python scan loop, equal the JAX package's
    (and round-trip the levels)."""
    lv = _levels(layout, *wh, seed=sum(wh) + al[1], ac_range=300)
    data = PP.encode_progressive(lv, wh, layout=layout, al_dc=al[0],
                                 al_ac=al[1])
    assert data == JP.encode_progressive(lv, wh, layout=layout,
                                         al_dc=al[0], al_ac=al[1])
    want, jf = JP.decode_progressive(data)
    np.testing.assert_array_equal(want, lv)
    for native in (True, False):
        got, f = PP.decode_progressive(data, native=native)
        assert got.dtype == np.int16 and (f.width, f.height) == wh
        np.testing.assert_array_equal(got, want)


def test_python_loop_matches_jax_python_loop(monkeypatch):
    lv = _levels("420", 48, 32, seed=5)
    data = PP.encode_progressive(lv, (48, 32), al_dc=2, al_ac=2)
    monkeypatch.setenv("AMV_PROGRESSIVE_PY", "1")
    want, _ = JP.decode_progressive(data)
    got, _ = PP.decode_progressive(data, native=False)
    np.testing.assert_array_equal(got, want)


def test_c_failure_falls_back_to_python_loop(monkeypatch):
    """When the C pass raises, the Python scan loop restarts from clean
    state and gives JAX's levels (the JAX package's C-then-Python
    contract, jpeg_progressive.py:334-339)."""
    lv = _levels("422", 44, 24, seed=8)
    data = PP.encode_progressive(lv, (44, 24), layout="422")
    calls = []

    def failing(scans, coef, plan):
        calls.append(len(scans))
        coef[...] = 7                      # a half-written frame
        raise ValueError("progressive frame decode failed (rc=-3)")

    monkeypatch.setattr(PP, "progressive_frame", failing)
    got, _ = PP.decode_progressive(data)
    assert calls
    np.testing.assert_array_equal(got, JP.decode_progressive(data)[0])


def test_tables_and_block_maps_match_jax():
    """The state the codec carries: the progressive AC table of
    encode_progressive (as the JAX package's DHT writes it) and the block
    grids and maps."""
    lv = _levels("420", 32, 32, seed=1)
    f = JP._Scans(JP.encode_progressive(lv, (32, 32))).frame
    for tid in (0, 1):
        np.testing.assert_array_equal(f.huff[(1, tid)][0], PP.AC_BITS)
        np.testing.assert_array_equal(f.huff[(1, tid)][1], PP.AC_VALS)
    for layout in _MCU:
        for wh in ((48, 32), (28, 20), (13, 9)):
            fr = _Frame(layout, *wh)
            assert PP._comp_grids(fr) == JP._comp_grids(fr)
            assert PP._mcu_grid(fr) == JP._mcu_grid(fr)
            for a, b in zip(PP._block_index_maps(fr),
                            JP._block_index_maps(fr)):
                np.testing.assert_array_equal(a, b)


def _planes_equal(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == torch.uint8
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("layout,wh", [("420", (48, 32)), ("422", (32, 24)),
                                       ("444", (16, 16)), ("gray", (24, 16)),
                                       ("420", (28, 20))])
def test_decode_mjpeg_frames_matches_jax(layout, wh):
    """Progressive frames through decode_mjpeg_frames give the JAX
    package's planes, which equal the baseline decode of the same
    coefficients."""
    frames = [PP.encode_progressive(_levels(layout, *wh, seed=s), wh,
                                    layout=layout) for s in (3, 4, 5)]
    want = JM.decode_mjpeg_frames(frames)
    _planes_equal(MJ.decode_mjpeg_frames(frames, device="cpu",
                                         batch_frames=2), want)
    base = JM.decode_mjpeg_frames([_baseline(_levels(layout, *wh, seed=3),
                                             layout, *wh)])
    for p, b in zip(want, base):
        if p is not None:
            np.testing.assert_array_equal(np.asarray(p)[0], np.asarray(b)[0])


def test_mixed_baseline_progressive_batch(monkeypatch):
    """A batch mixing baseline and progressive frames (in batches that hold
    one kind, the other, or both) gives the JAX package's planes."""
    monkeypatch.setattr(MJ, "HOST_THREADS", 2)
    w, h = 32, 32
    prog = [PP.encode_progressive(_levels("420", w, h, seed=s), (w, h))
            for s in (11, 13)]
    base = [_baseline(_levels("420", w, h, seed=s), "420", w, h)
            for s in (12, 14)]
    frames = [base[0], prog[0], base[1], base[0], prog[1], prog[0]]
    want = JM.decode_mjpeg_frames(frames)
    for batch in (None, 1, 2, 4):
        _planes_equal(MJ.decode_mjpeg_frames(frames, device="cpu",
                                             batch_frames=batch), want)


def _redefined_tables_stream():
    """An 8x8 gray progressive stream whose two AC scans use different
    Huffman tables under the same id (1, 0), as libjpeg/mozjpeg's
    optimized output redefines them between scans."""
    def dht(tc, tid, bits, vals):
        body = bytes([(tc << 4) | tid]) + \
            bytes(np.asarray(bits)[1:].astype(np.uint8)) + \
            bytes(np.asarray(vals).astype(np.uint8))
        return b"\xFF\xC4" + (len(body) + 2).to_bytes(2, "big") + body

    def sos(ss, se, ah, al):
        body = bytes([1, 1, 0x00, ss, se, (ah << 4) | al])
        return b"\xFF\xDA" + (len(body) + 2).to_bytes(2, "big") + body

    def scan(puts):
        bw = JR.BitWriter()
        for n, v in puts:
            bw.put_bits(n, v)
        if bw.nbits % 8:
            bw.put_bits(8 - bw.nbits % 8, 0xFF)
        return JR.escape_ff(bw.flush())

    dc_bits = np.zeros(17, np.int32)
    dc_bits[3] = 8
    dc_vals = np.arange(8, dtype=np.int32)
    dc = JT.build_huffman_codes(dc_bits, dc_vals)
    a_bits = np.zeros(17, np.int32)
    a_bits[2] = 2
    a_vals = np.array([0x02, 0x00], np.int32)
    ta = JT.build_huffman_codes(a_bits, a_vals)
    b_bits = np.zeros(17, np.int32)
    b_bits[1] = b_bits[2] = 1
    b_vals = np.array([0x00, 0x02], np.int32)
    tb = JT.build_huffman_codes(b_bits, b_vals)
    out = bytearray(b"\xFF\xD8")
    out += b"\xFF\xDB" + (67).to_bytes(2, "big") + b"\x00" + bytes([1] * 64)
    out += dht(0, 0, dc_bits, dc_vals) + dht(1, 0, a_bits, a_vals)
    out += b"\xFF\xC2\x00\x0B\x08\x00\x08\x00\x08\x01\x01\x11\x00"
    out += sos(0, 0, 0, 0) + scan([(int(dc[0][3]), int(dc[1][3])),
                                   (3, 0b101)])
    out += sos(1, 5, 0, 0) + scan([(int(ta[0][2]), int(ta[1][2])),
                                   (2, 0b11), (int(ta[0][0]), int(ta[1][0]))])
    out += dht(1, 0, b_bits, b_vals)
    out += sos(6, 63, 0, 0) + scan([(int(tb[0][2]), int(tb[1][2])),
                                    (2, 0b01), (int(tb[0][0]), int(tb[1][0]))])
    return bytes(out + b"\xFF\xD9")


def test_per_scan_table_redefinition():
    data = _redefined_tables_stream()
    want = np.zeros(64, np.int16)
    want[0], want[1], want[6] = 5, 3, -2
    np.testing.assert_array_equal(JP.decode_progressive(data)[0][0, 0], want)
    for native in (True, False):
        np.testing.assert_array_equal(
            PP.decode_progressive(data, native=native)[0][0, 0], want)
    _planes_equal(MJ.decode_mjpeg_frames([data, data], device="cpu"),
                  JM.decode_mjpeg_frames([data, data]))


def test_pil_progressive_file():
    """libjpeg's progressive output (PIL: optimized per-scan tables,
    successive approximation) gives the JAX package's planes and the
    baseline encoding's."""
    image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(2)
    xx, yy = np.mgrid[0:64, 0:80]
    img = np.stack([
        np.clip(120 + 70 * np.sin(xx / 7.0) + rng.integers(-9, 9, (64, 80)),
                0, 255),
        np.clip(110 + 60 * np.cos(yy / 9.0), 0, 255),
        np.clip(90 + 50 * np.sin((xx + yy) / 11.0), 0, 255)],
        axis=-1).astype(np.uint8)
    base, prog = io.BytesIO(), io.BytesIO()
    image.fromarray(img).save(base, "JPEG", quality=80, progressive=False,
                              optimize=False, subsampling=2)
    image.fromarray(img).save(prog, "JPEG", quality=80, progressive=True,
                              subsampling=2)
    got = MJ.decode_mjpeg_frames([prog.getvalue()], device="cpu")
    _planes_equal(got, JM.decode_mjpeg_frames([prog.getvalue()]))
    _planes_equal(got, JM.decode_mjpeg_frames([base.getvalue()]))


def _mutations(data: bytes, rng, n, max_flips=8):
    """tests/test_fuzz_parsers.py's mutants: byte flips, truncations and
    32-bit length scribbles."""
    for _ in range(n):
        b = bytearray(data)
        kind = rng.integers(0, 3)
        if kind == 0:
            for _ in range(int(rng.integers(1, max_flips + 1))):
                b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        elif kind == 1:
            b = b[:int(rng.integers(0, len(b)))]
        elif len(b) >= 4:
            pos = int(rng.integers(0, len(b) - 3))
            val = int(rng.integers(0, 2)) * 0xFFFFFFF0 + int(
                rng.integers(0, 16))
            b[pos:pos + 4] = struct.pack("<I", val & 0xFFFFFFFF)
        yield bytes(b)


def _outcome(fn, data):
    try:
        return fn(data)
    except Exception as e:      # noqa: BLE001 - the outcome is compared
        return e


def test_fuzz_parity(monkeypatch):
    """tests/test_fuzz_parsers.py:test_fuzz_progressive_decode's 200
    mutants (same seed and seed stream): the port returns the JAX
    package's levels wherever it returns some, and raises wherever it
    raises; by default (C, then the Python loop) and with the Python loop
    alone (the JAX package's AMV_PROGRESSIVE_PY=1)."""

    def jax_python_loop(d):
        monkeypatch.setenv("AMV_PROGRESSIVE_PY", "1")
        try:
            return JP.decode_progressive(d)[0]
        finally:
            monkeypatch.delenv("AMV_PROGRESSIVE_PY")

    rng = np.random.default_rng(0x50F2)
    lv = np.zeros((4, 1, 64), np.int16)
    lv[:, :, 0] = rng.integers(-40, 41, (4, 1))
    lv[:, :, 1:] = np.where(rng.random((4, 1, 63)) < 0.2,
                            rng.integers(-80, 81, (4, 1, 63)), 0)
    data = JP.encode_progressive(lv, (16, 16), layout="gray")
    decoded = raised = 0
    for mut in _mutations(data, rng, 200):
        try:
            f = JP._Scans(mut).frame
        except Exception:       # noqa: BLE001 - the port must raise too
            with pytest.raises(Exception):
                PP.decode_progressive(mut)
            raised += 1
            continue
        if f.width * f.height > 1 << 22:
            continue            # a scribbled SOF: no giant grid
        for native, jax_fn in ((False, jax_python_loop),
                               (True, lambda d: JP.decode_progressive(d)[0])):
            want = _outcome(jax_fn, mut)
            got = _outcome(lambda d: PP.decode_progressive(
                d, native=native)[0], mut)
            if isinstance(want, Exception):
                assert isinstance(got, Exception), (native, want)
            else:
                assert not isinstance(got, Exception), (native, got)
                np.testing.assert_array_equal(got, want)
        decoded += not isinstance(want, Exception)
        raised += isinstance(want, Exception)
    assert decoded and raised
