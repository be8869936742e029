"""The port's baseline MJPEG (`codecs/mjpeg.py`, kernels D, I, F, V, E in
their plain versions on the CPU, the host C scan decoder and packer)
against the JAX package: decoded planes and encoded bytes for 4:2:0,
4:2:2, 4:4:4 and gray with restart intervals 0, 1 and 5; frames whose
DQT differs within a batch; an interlaced field pair; MJPG AVI input and
the CLI's MJPEG and copy routes; and a fuzz of the C scan decoder against
the JAX package's own.  Inputs are seeded numpy pictures encoded by
`amv_tpu.codecs.mjpeg.encode_mjpeg_frames`.  Tolerance: exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from amv_tpu import cli as jax_cli  # noqa: E402
from amv_tpu.codecs import mjpeg as JM  # noqa: E402
from amv_tpu.containers import avi as jax_avi  # noqa: E402
from amv_tpu.native import entropy_native as jax_native  # noqa: E402
from amv_tpu.pipeline import encode as jax_encode  # noqa: E402
from amv_tpu.verify import fixtures  # noqa: E402
from amv_tpu_torch import cli, native  # noqa: E402
from amv_tpu_torch.bitstream.jpeg_parse import parse_jpeg  # noqa: E402
from amv_tpu_torch.codecs import mjpeg as PM  # noqa: E402
from amv_tpu_torch.containers import avi  # noqa: E402

LAYOUTS = ("420", "422", "444", "gray")
F, H, W = 3, 40, 56           # 2.5 x 3.5 MCUs of 16: padded on both edges


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this file runs: the plain trellis is
    thousands of small torch operations in a row, and with the suite's
    parallel workers on the same cores, intra-op threads that wait for
    each other made them ~50x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planes(layout, f=F, h=H, w=W, seed=0):
    """Seeded pictures: a videogen luma with noise, and chroma at the
    layout's size."""
    rng = np.random.default_rng(seed)
    y = np.clip(fixtures.videogen(f, h, w, seed=seed)[0].astype(np.int16) +
                rng.integers(-9, 10, (f, h, w)), 0, 255).astype(np.uint8)
    cshape = {"420": (f, h // 2, w // 2), "422": (f, h, (w + 1) // 2),
              "444": (f, h, w), "gray": (f, 1, 1)}[layout]
    cb = rng.integers(60, 200, cshape, dtype=np.uint8)
    return y, cb, 255 - cb


def _jax_frames(layout, ri, qscale=3, **kw):
    y, cb, cr = _planes(layout, **kw)
    if layout == "gray":
        cb = cr = None
    return JM.encode_mjpeg_frames(y, cb, cr, qscale=qscale,
                                  subsampling=layout, restart_interval=ri)


def _assert_planes(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.dtype == torch.uint8 and np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("ri", [0, 1, 5])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_decode_matches_jax(layout, ri):
    pays = _jax_frames(layout, ri)
    host0 = PM.HOST_FRAMES
    got = PM.decode_mjpeg_frames(pays, device="cpu")
    _assert_planes(got, JM.decode_mjpeg_frames(pays))
    # 4:2:0 with stock tables and no restart markers runs kernel D
    assert (PM.HOST_FRAMES == host0) == (layout == "420" and ri == 0)


@pytest.mark.parametrize("ri", [0, 1, 5])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_encode_matches_jax(layout, ri):
    y, cb, cr = _planes(layout, seed=1)
    if layout == "gray":
        cb = cr = None
    got = PM.encode_mjpeg_frames(y, cb, cr, qscale=4, subsampling=layout,
                                 restart_interval=ri, device="cpu")
    assert got == JM.encode_mjpeg_frames(y, cb, cr, qscale=4,
                                         subsampling=layout,
                                         restart_interval=ri)


@pytest.mark.parametrize("layout", ["420", "422"])
def test_odd_size_round_trip(layout):
    """A 37x23 picture (odd: 4:2:2 chroma is 19 wide): both packages'
    bytes and planes, in batches of 2 frames."""
    y, cb, cr = _planes(layout, f=3, h=23, w=37, seed=2)
    if layout == "420":
        cb, cr = cb[:, :11, :18], cr[:, :11, :18]
    pays = JM.encode_mjpeg_frames(y, cb, cr, subsampling=layout)
    assert PM.encode_mjpeg_frames(y, cb, cr, subsampling=layout,
                                  device="cpu") == pays
    _assert_planes(PM.decode_mjpeg_frames(pays, device="cpu",
                                          batch_frames=2),
                   JM.decode_mjpeg_frames(pays))


def test_tables_vary_within_a_batch():
    """Frames of different quant tables (qscale 2 and 7) and restart
    intervals (0 and 3), interleaved: each run transforms with its own."""
    a = _jax_frames("422", 0, qscale=2, seed=3)
    b = _jax_frames("422", 3, qscale=7, seed=4)
    pays = [a[0], b[0], a[1], b[1], b[2], a[2]]
    assert len({parse_jpeg(p).quant[0].tobytes() for p in pays}) == 2
    _assert_planes(PM.decode_mjpeg_frames(pays, device="cpu",
                                          batch_frames=4),
                   JM.decode_mjpeg_frames(pays))


def test_interlaced_field_pair():
    """Packets of two field images (each 20 rows of a 40-row frame): the
    fields row-interleaved, detected without and with the container's
    height, and with the AVI1 marker's bottom-field-first polarity."""
    top = _jax_frames("422", 0, seed=5, h=20)
    bottom = _jax_frames("422", 0, seed=6, h=20)
    pays = [t + b for t, b in zip(top, bottom)]
    for org in (0, 40):
        _assert_planes(PM.decode_mjpeg_frames(pays, org, device="cpu"),
                       JM.decode_mjpeg_frames(pays, org))
    tagged = [t[:2] + b"\xFF\xE0\x00\x07AVI1\x02" + t[2:] + b
              for t, b in zip(top, bottom)]
    got = PM.decode_mjpeg_frames(tagged, device="cpu")
    _assert_planes(got, JM.decode_mjpeg_frames(tagged))
    _assert_planes(got[:1], [np.asarray(
        JM.decode_interlaced_frames(pays, 1)[0])])


def test_frame_kernel_d_rejects_raises_like_jax(monkeypatch):
    """A 4:2:0 stock-table frame whose scan holds an invalid code (all
    ones): kernel D rejects it, the host C decoder gets it and raises
    ValueError, as the JAX package's decoder does."""
    pays = _jax_frames("420", 0, seed=12)
    f = parse_jpeg(pays[1])
    bad = pays[1][:len(pays[1]) - len(f.scan) - 2] + b"\xFF\x00" * 40 + \
        b"\xFF\xD9"
    pays = [pays[0], bad, pays[2]]
    with pytest.raises(ValueError):
        JM.decode_mjpeg_frames(pays)
    sent = []
    host = PM._host_decode
    monkeypatch.setattr(PM, "_host_decode", lambda frames, *a: (
        sent.append(len(frames)), host(frames, *a))[1])
    with pytest.raises(ValueError):
        PM.decode_mjpeg_frames(pays, device="cpu")
    assert sent == [1]                   # only the rejected frame


def _mjpg_avi(path, layout, ri, n=4, h=48, w=64, rate=44100, seed=7):
    y, cb, cr = _planes(layout, f=n, h=h, w=w, seed=seed)
    pays = PM.encode_mjpeg_frames(y, None if layout == "gray" else cb,
                                  None if layout == "gray" else cr,
                                  subsampling=layout, restart_interval=ri,
                                  device="cpu")
    pcm = fixtures.audiogen(n / 16, rate, seed=seed)
    path.write_bytes(jax_avi.mux(y, y[:, ::2, ::2], y[:, ::2, ::2], pcm,
                                 fps=16, sample_rate=rate,
                                 video_chunks=pays))
    return path


@pytest.mark.parametrize("layout,ri", [("420", 0), ("422", 5), ("444", 1),
                                       ("gray", 0)])
def test_extract_yuv420_mjpg_matches_jax(tmp_path, layout, ri, monkeypatch):
    """The MJPG branch of extract_yuv420 (4:4:4 and 4:2:2 to 4:2:0, gray
    chroma 128) in batches of 3 frames."""
    src = _mjpg_avi(tmp_path / "in.avi", layout, ri, n=5, h=30, w=46)
    monkeypatch.setattr(avi, "BATCH_FRAMES", 3)
    vst = avi.read(str(src))[0]
    got = avi.extract_yuv420(vst, device="cpu")
    want = jax_avi.extract_yuv420(jax_avi.read(str(src))[0])
    _assert_planes(got, want)


def test_extract_yuv420_interlaced_crop():
    """Interlaced packets whose fields pad past the container's height
    (two 16-row fields in a 30-row AVI): the frames cropped to 30 rows."""
    top = _jax_frames("420", 0, seed=8, h=16, w=32)
    bottom = _jax_frames("420", 0, seed=9, h=16, w=32)
    st = dict(codec=b"MJPG", width=32, height=30,
              chunks=[t + b for t, b in zip(top, bottom)])
    got = avi.extract_yuv420(avi.AviStream("video", **st), device="cpu")
    want = jax_avi.extract_yuv420(jax_avi.AviStream("video", **st))
    assert got[0].shape == (F, 30, 32)
    _assert_planes(got, want)


def _both_clis(tmp_path, argv, out_name):
    """Run both CLIs (the port's with --device cpu); the outputs' paths."""
    port, jax = tmp_path / "port", tmp_path / "jax"
    port.mkdir(exist_ok=True)
    jax.mkdir(exist_ok=True)
    assert cli.main([*argv, str(port / out_name), "--device", "cpu"]) == 0
    assert jax_cli.main([*argv, str(jax / out_name)]) == 0
    return port, jax


@pytest.mark.parametrize("extra", [[], ["-trellis", "-r", "50"],
                                   ["--seek", "2"], ["-t", "0.125"]])
def test_cli_mjpg_avi_to_amv_matches_jax(tmp_path, extra):
    """The canonical conversion from a camera-style MJPG AVI (4:2:2,
    restart interval 5, 44,100 Hz PCM): -f amv -r 16 -s 48x32 -ac 1 -ar
    22050, with -trellis (at -r 50: audio chunks of 441 samples, which
    keeps the trellis's CPU run short), --seek and -t."""
    src = _mjpg_avi(tmp_path / "cam.avi", "422", 5)
    port, jax = _both_clis(tmp_path, [
        "-i", str(src), "-f", "amv", "-r", "16", "-s", "48x32", "-ac", "1",
        "-ar", "22050", *extra], "out.amv")
    assert (port / "out.amv").read_bytes() == (jax / "out.amv").read_bytes()


@pytest.fixture(scope="module")
def amv_file(tmp_path_factory):
    """A 5-frame 48x32 .amv with audio."""
    d = tmp_path_factory.mktemp("amv")
    y, cb, cr = fixtures.rotozoom(5, 32, 48)
    pcm = fixtures.audiogen(5 / 16, seed=2)
    path = d / "in.amv"
    path.write_bytes(jax_encode.encode_to_bytes(y, cb, cr, pcm))
    return path


@pytest.mark.parametrize("argv,out_name", [
    (["-vcodec", "mjpeg"], "out.avi"),
    (["-vcodec", "mjpeg", "-qscale", "6", "--max-frames", "3"], "out.avi"),
    (["-vcodec", "copy"], "out.avi"),
    (["-vcodec", "copy", "--seek", "1", "--max-frames", "2"], "out.avi"),
    ([], "f_%03d.jpg"),
    ([], "one.jpg"),
    (["-acodec", "copy"], "out.wav"),
    (["-acodec", "copy", "--seek", "2"], "out.wav"),
])
def test_cli_amv_outputs_match_jax(tmp_path, amv_file, argv, out_name):
    port, jax = _both_clis(tmp_path, ["-i", str(amv_file), *argv], out_name)
    names = sorted(p.name for p in jax.iterdir())
    assert names and sorted(p.name for p in port.iterdir()) == names
    for nm in names:
        assert (port / nm).read_bytes() == (jax / nm).read_bytes(), nm


def test_vcodec_mjpeg_round_trip_runs_kernel_d(tmp_path, amv_file):
    """A 4:2:0 -vcodec mjpeg file written by the port decodes through
    kernel D (stock tables, no restart markers) to the JAX decoder's
    planes."""
    out = tmp_path / "out.avi"
    assert cli.main(["-i", str(amv_file), "-vcodec", "mjpeg", str(out),
                     "--device", "cpu"]) == 0
    vst = avi.read(str(out))[0]
    host0 = PM.HOST_FRAMES
    got = PM.decode_mjpeg_frames(vst.chunks, device="cpu")
    assert PM.HOST_FRAMES == host0
    _assert_planes(got, JM.decode_mjpeg_frames(vst.chunks))


# ------------------------------------------------------------- the fuzz

def _scan_case(rng, kind):
    """(scans, n_mcu, huff, pairs, restart) of a fuzz case from seeded
    4:2:2 frames of 2 x 4 MCUs (restart interval 2; none where a cut
    scan should decode to bounded levels)."""
    ri = 0 if kind in ("truncated", "mixed") else 2
    pays = _jax_frames("422", ri, seed=int(rng.integers(1 << 30)), h=32,
                       w=32)
    frames = [parse_jpeg(p) for p in pays]
    huff = dict(frames[0].huff)
    scans = [f.scan for f in frames]
    pairs = [(dc, ac) for (_, dc, ac, _) in frames[0].mcu_blocks()]
    if kind == "truncated":
        scans = [s[:int(rng.integers(0, len(s)))] for s in scans]
    elif kind == "rst_order":
        # each RSTn marker renumbered at random
        scans = [bytes(s).replace(b"\xFF\xD0", bytes(
            [0xFF, 0xD0 + int(rng.integers(8))])) for s in scans]
    elif kind == "flipped":
        scans = [bytes(b ^ (0xFF if rng.random() < 0.02 else 0) for b in s)
                 for s in scans]
    elif kind == "kraft":
        bits = huff[(1, 0)][0].copy()
        bits[2] += int(rng.integers(3, 9))  # more 2-bit codes than fit
        vals = np.concatenate([huff[(1, 0)][1],
                               np.zeros(int(bits[1:].sum()) -
                                        len(huff[(1, 0)][1]), np.int32)])
        huff[(1, 0)] = (bits, vals)
    elif kind == "selector":
        pairs[int(rng.integers(len(pairs)))] = (int(rng.integers(4, 16)), 0)
    elif kind == "mixed":
        long = parse_jpeg(_jax_frames("422", 0, seed=11, h=64, w=96)[0])
        cut = int(rng.integers(1, len(long.scan)))
        return [long.scan, long.scan[:cut]], 6 * 8, huff, pairs, 0
    return scans, 2 * 4, huff, pairs, ri


@pytest.mark.parametrize("kind", ["truncated", "rst_order", "flipped",
                                  "kraft", "selector", "mixed"])
def test_decode_scans_custom_fuzz(kind):
    """The port's C scan decoder on malformed input: truncated scans, RST
    markers out of sequence, flipped bytes, a DHT whose code counts break
    the Kraft bound, table selectors above 3, and a batch of one long
    valid frame and one truncated frame.  Each case raises ValueError or
    returns levels of the asked shape, exactly as the JAX package's C
    decoder does (reads stay within each scan: the unescape reads its
    row's bytes and the bit reader zero-fills past them)."""
    rng = np.random.default_rng(len(kind))
    for _ in range(12):
        scans, n_mcu, huff, pairs, ri = _scan_case(rng, kind)
        try:
            want = jax_native.decode_scans_custom(scans, n_mcu, huff, pairs,
                                                  restart_interval=ri)
        except ValueError:
            with pytest.raises(ValueError):
                native.decode_scans_custom(scans, n_mcu, huff, pairs,
                                           restart_interval=ri)
            continue
        got = native.decode_scans_custom(scans, n_mcu, huff, pairs,
                                         restart_interval=ri)
        assert got.shape == (len(scans), n_mcu, len(pairs), 64)
        assert np.array_equal(got, want)
