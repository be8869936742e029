"""The port's lossless (SOF3) MJPEG input on the CPU against the JAX
package: `bitstream.jpeg_lossless.encode_lossless`'s bytes,
`decode_lossless` through the host C walk and through the Python walk
(predictors 0-7, 4:2:0, 4:2:2, gray, RGB plain/RCT/Pegasus, point
transforms, restart intervals, DC symbols above 16), `codecs.mjpeg.
decode_lossless_frames` and `decode_mjpeg_frames` with their errors, the
table the encoder carries, and parity on the JAX package's fuzz mutants.
Inputs are made with numpy from seeds.  Tolerance: exact equality.
"""

import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from amv_tpu.bitstream import jpeg_lossless as JL  # noqa: E402
from amv_tpu.bitstream import jpeg_tables as JT  # noqa: E402
from amv_tpu.bitstream.jpeg_parse import parse_jpeg  # noqa: E402
from amv_tpu.codecs import mjpeg as JM  # noqa: E402
from amv_tpu.verify import ref_jpeg as JR  # noqa: E402
from amv_tpu_torch.bitstream import jpeg_lossless as PL  # noqa: E402
from amv_tpu_torch.codecs import mjpeg as MJ  # noqa: E402


def _img(rng, h, w):
    base = np.cumsum(rng.integers(-6, 7, (h, w)), axis=1)
    base = np.cumsum(base, axis=0) // 3 + 128
    return np.clip(base, 0, 255).astype(np.uint8)


def _noise(rng, h, w):
    return rng.integers(0, 256, (h, w)).astype(np.uint8)


def _case(name, rng):
    """(planes, encode_lossless keywords) of a named case."""
    if name.startswith("gray p"):
        return [_img(rng, 13, 17)], {"predictor": int(name[-1])}
    return {
        "420": ([_img(rng, 16, 16), _img(rng, 8, 8), _img(rng, 8, 8)],
                {"predictor": 4, "restart_interval": 2}),
        "420 odd": ([_img(rng, 15, 13), _img(rng, 8, 7), _img(rng, 8, 7)],
                    {"predictor": 1}),
        "422": ([_img(rng, 12, 16), _img(rng, 12, 8), _img(rng, 12, 8)],
                {"predictor": 6}),
        "rgb": ([_img(rng, 9, 11) for _ in range(3)],
                {"predictor": 7, "rgb": True}),
        "rgb ri": ([_noise(rng, 6, 5) for _ in range(3)],
                   {"predictor": 5, "rgb": True, "restart_interval": 3}),
        "rct": ([_noise(rng, 8, 10) for _ in range(3)],
                {"predictor": 4, "rgb": True, "rct": True}),
        "pegasus": ([_noise(rng, 8, 10) for _ in range(3)],
                    {"predictor": 2, "rgb": True, "pegasus": True}),
        "pt 2": ([_img(rng, 10, 10)],
                 {"predictor": 1, "point_transform": 2}),
        "rgb pt 1": ([_img(rng, 7, 9) for _ in range(3)],
                     {"predictor": 6, "rgb": True, "point_transform": 1}),
        "ri 1": ([_img(rng, 9, 13)], {"predictor": 4, "restart_interval": 1}),
    }[name]


CASES = [f"gray p{k}" for k in range(1, 8)] + [
    "420", "420 odd", "422", "rgb", "rgb ri", "rct", "pegasus", "pt 2",
    "rgb pt 1", "ri 1"]


def _same(got, want):
    assert got[0] == want[0] and len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        assert a.dtype == np.uint8 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", CASES)
def test_encode_and_decode_match_jax(name):
    """encode_lossless's bytes, and decode_lossless through the C walk and
    the Python walk, equal the JAX package's (and round-trip)."""
    planes, kw = _case(name, np.random.default_rng(len(name) * 7 + 1))
    data = PL.encode_lossless(planes, **kw)
    assert data == JL.encode_lossless(planes, **kw)
    want = JL.decode_lossless(data)
    if not kw.get("point_transform"):
        for a, b in zip(want[1], planes):
            np.testing.assert_array_equal(a, b)
    for native in (True, False):
        _same(PL.decode_lossless(data, native=native), want)


def _with_sos(data, **fields):
    """data with its SOS predictor (ss) or point transform (al) set."""
    pos = data.index(b"\xFF\xDA")
    ns = data[pos + 4]
    b = bytearray(data)
    at = pos + 5 + 2 * ns
    if "ss" in fields:
        b[at] = fields["ss"]
    if "al" in fields:
        b[at + 2] = fields["al"]
    return bytes(b)


@pytest.mark.parametrize("predictor", [0, 8, 15])
def test_predictors_outside_1_to_7(predictor):
    """Predictor 0 and those above 7 take the C default (7) in both walks,
    as in the JAX package."""
    rng = np.random.default_rng(predictor)
    data = _with_sos(PL.encode_lossless([_img(rng, 11, 14)], predictor=7),
                     ss=predictor)
    want = JL.decode_lossless(data)
    assert want[2].ss == predictor
    for native in (True, False):
        _same(PL.decode_lossless(data, native=native), want)


def test_hand_computed_vector():
    """tests/test_jpeg_lossless.py's differential vector: each decoded
    sample satisfies the reference's prediction walk (mjpegdec.c:572-658)
    and the image round-trips, through both walks."""
    img = _img(np.random.default_rng(21), 4, 5)
    data = PL.encode_lossless([img], predictor=5)
    for native in (True, False):
        _, planes, _ = PL.decode_lossless(data, native=native)
        p = planes[0].astype(int)
        for py in range(p.shape[0]):
            for px in range(p.shape[1]):
                if py == 0 and px == 0:
                    continue
                if py == 0:
                    pred = p[py, px - 1]
                elif px == 0:
                    pred = p[py - 1, px]
                else:
                    pred = PL._predict(p[py - 1, px - 1], p[py - 1, px],
                                       p[py, px - 1], 5)
                assert 0 <= (p[py, px] - pred) % 256 < 256
        np.testing.assert_array_equal(planes[0], img)


def _dht(bits, vals):
    body = bytes([0x00]) + bytes(np.asarray(bits)[1:].astype(np.uint8)) + \
        bytes(np.asarray(vals).astype(np.uint8))
    return b"\xFF\xC4" + (len(body) + 2).to_bytes(2, "big") + body


@pytest.mark.parametrize("rgb", [False, True])
def test_dc_symbols_above_16(rgb):
    """A DHT that gives DC sizes above 16 (as a scribbled table can): the
    walk reads that many bits and keeps what survives the mask, as
    Python's unbounded integers do."""
    rng = np.random.default_rng(17)
    bits = np.zeros(17, np.int32)
    bits[3] = 6
    vals = np.array([0, 3, 17, 40, 70, 200], np.int32)
    codes = JT.build_huffman_codes(bits, vals)
    bw = JR.BitWriter()
    for _ in range(3 * 4 * 5):
        sym = int(rng.choice(vals))
        bw.put_bits(int(codes[0][sym]), int(codes[1][sym]))
        for k in range(0, sym, 16):
            n = min(16, sym - k)
            bw.put_bits(n, int(rng.integers(0, 1 << n)))
    bw.put_bits((-bw.bit_count()) & 7, 0xFF)
    ncomp = 3 if rgb else 1
    sof = bytes([8, 0, 4, 0, 5, ncomp]) + b"".join(
        bytes([i + 1, 0x11, 0]) for i in range(ncomp))
    sos = bytes([ncomp]) + b"".join(bytes([i + 1, 0]) for i in range(ncomp))
    data = (b"\xFF\xD8" + _dht(bits, vals) + b"\xFF\xC3" +
            (len(sof) + 2).to_bytes(2, "big") + sof + b"\xFF\xDA" +
            (len(sos) + 5).to_bytes(2, "big") + sos + bytes([4, 0, 1]) +
            JR.escape_ff(bw.flush()) + b"\xFF\xD9")
    want = JL.decode_lossless(data)
    assert want[0] == ("rgb" if rgb else "yuv")
    for native in (True, False):
        _same(PL.decode_lossless(data, native=native), want)


def test_encoder_table_matches_jax():
    np.testing.assert_array_equal(PL._LL_BITS, JL._LL_BITS)
    np.testing.assert_array_equal(PL._LL_VALS, JL._LL_VALS)


def _frames_equal(got, want):
    assert got[0] == want[0] and len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        assert a.dtype == torch.uint8
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("name", ["420", "422", "rgb", "rct", "pegasus",
                                  "gray p3"])
def test_decode_lossless_frames_matches_jax(name, monkeypatch):
    """decode_lossless_frames on several host threads and in batches gives
    the JAX package's mode and planes; decode_mjpeg_frames its YUV and
    gray planes."""
    monkeypatch.setattr(MJ, "HOST_THREADS", 3)
    rng = np.random.default_rng(99)
    payloads = []
    for _ in range(5):
        planes, kw = _case(name, rng)
        payloads.append(PL.encode_lossless(planes, **kw))
    want = JM.decode_lossless_frames(payloads)
    for batch in (None, 2):
        _frames_equal(MJ.decode_lossless_frames(
            payloads, device="cpu", batch_frames=batch), want)
    if want[0] == "yuv":
        got = MJ.decode_mjpeg_frames(payloads, device="cpu", batch_frames=2)
        for a, b in zip(got, JM.decode_mjpeg_frames(payloads)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), b)
    assert MJ.decode_lossless_frames([], device="cpu") == (None, None)


def test_lossless_frame_errors():
    """The JAX package's errors: mixed modes or geometry, lossless mixed
    with DCT frames, an RGB-mode stream through decode_mjpeg_frames."""
    rng = np.random.default_rng(3)
    gray = PL.encode_lossless([_img(rng, 8, 8)])
    gray_big = PL.encode_lossless([_img(rng, 8, 9)])
    rgb = PL.encode_lossless([_img(rng, 8, 8) for _ in range(3)], rgb=True)
    base = MJ.encode_mjpeg_frames(_img(rng, 16, 16)[None],
                                  _img(rng, 8, 8)[None],
                                  _img(rng, 8, 8)[None], device="cpu")[0]
    for frames, match in (([gray, rgb], "share geometry/mode"),
                          ([gray, gray_big], "share geometry/mode")):
        with pytest.raises(ValueError, match=match):
            JM.decode_lossless_frames(frames)
        with pytest.raises(ValueError, match=match):
            MJ.decode_lossless_frames(frames, device="cpu")
    for frames, match in (([gray, base], "mix"), ([base, gray], "mix"),
                          ([rgb], "RGB-mode")):
        with pytest.raises(ValueError, match=match):
            JM.decode_mjpeg_frames(frames)
        with pytest.raises(ValueError, match=match):
            MJ.decode_mjpeg_frames(frames, device="cpu")


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


@pytest.mark.parametrize("seed_case", ["jax", "rgb"])
def test_fuzz_parity(seed_case):
    """tests/test_fuzz_parsers.py:test_fuzz_lossless_decode's 200 mutants
    (same seed and seed stream), and 200 of an RGB-mode RCT frame with
    restarts: both walks return the JAX package's planes wherever it
    returns some, and raise wherever it raises."""
    if seed_case == "jax":
        rng = np.random.default_rng(0x50F3)
        y = rng.integers(0, 256, (16, 16), np.uint8).astype(np.uint8)
        c = rng.integers(0, 256, (8, 8), np.uint8).astype(np.uint8)
        data = JL.encode_lossless([y, c, c], predictor=4, restart_interval=2)
    else:
        rng = np.random.default_rng(0x50F4)
        data = JL.encode_lossless([_noise(rng, 9, 11) for _ in range(3)],
                                  predictor=6, rgb=True, rct=True,
                                  restart_interval=5)
    decoded = raised = 0
    for mut in _mutations(data, rng, 200):
        try:
            fr = parse_jpeg(mut, allow_lossless=True)
        except Exception:       # noqa: BLE001 - the port must raise too
            with pytest.raises(Exception):
                PL.decode_lossless(mut)
            raised += 1
            continue
        if fr.width * fr.height > 1 << 14:
            continue            # a scribbled SOF: the Python walk is slow
        want = _outcome(JL.decode_lossless, mut)
        for native in (True, False):
            got = _outcome(lambda d: PL.decode_lossless(d, native=native),
                           mut)
            if isinstance(want, Exception):
                assert isinstance(got, Exception), (native, want)
            else:
                assert not isinstance(got, Exception), (native, got)
                _same(got, want)
        decoded += not isinstance(want, Exception)
        raised += isinstance(want, Exception)
    assert decoded and raised
