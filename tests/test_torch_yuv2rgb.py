"""The port's packed/dithered RGB output (kernel Y's plain version, the
YUYV/UYVY packing and the scalar oracle) against the JAX package's
`amv_tpu.kernels.yuv2rgb_dither` and `amv_tpu.verify.ref_yuv2rgb`, and
the CLI's `-pix_fmt` .rgb/.raw and `.bmp` outputs and its `--info`,
`--compare`, `--benchmark` and AMV_TRACE_DIR against `amv_tpu.cli`.

Inputs are made with numpy from seeds; every comparison is exact (array
equality or byte equality).  The port's uint32/uint16 outputs are int32/
int16 tensors holding the same bits: they are compared as those bits.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

from amv_tpu import cli as jcli
from amv_tpu.kernels import yuv2rgb_dither as J
from amv_tpu.pipeline import encode as jax_encode
from amv_tpu.verify import fixtures
from amv_tpu.verify import ref_yuv2rgb as JR
from amv_tpu_torch import cli
from amv_tpu_torch.kernels import yuv2rgb_dither as Y
from amv_tpu_torch.verify import ref_yuv2rgb as PR

H, W = 16, 24


def _planes(seed=0, extreme=False, lead=()):
    rng = np.random.default_rng(seed)
    if extreme:
        # saturated chroma and luma at the rails reach past the tables'
        # spans: the arena clamp
        y = rng.choice([0, 1, 254, 255], size=(*lead, H, W)).astype(np.uint8)
        cb = rng.choice([0, 255], size=(*lead, H // 2, W // 2)).astype(
            np.uint8)
        cr = rng.choice([0, 255], size=(*lead, H // 2, W // 2)).astype(
            np.uint8)
    else:
        y = rng.integers(0, 256, (*lead, H, W), np.uint8)
        cb = rng.integers(0, 256, (*lead, H // 2, W // 2), np.uint8)
        cr = rng.integers(0, 256, (*lead, H // 2, W // 2), np.uint8)
    return y, cb, cr


def _port(y, cb, cr, fmt, **kw):
    out = Y.yuv420_to_packed(*(torch.from_numpy(a) for a in (y, cb, cr)),
                             fmt=fmt, **kw).numpy()
    depth = Y._FORMATS[fmt][0]
    if depth == 32:
        return out.view(np.uint32)
    if depth in (15, 16):
        return out.view(np.uint16)
    return out


def _jax(y, cb, cr, fmt, **kw):
    return np.asarray(J.yuv420_to_packed(y, cb, cr, fmt=fmt, **kw))


def test_tables_equal_jax():
    """The port's copies of the dither matrices, formats and the cached
    host tables are the JAX package's."""
    for name in ("DITHER_2X2_4", "DITHER_2X2_8", "DITHER_8X8_32",
                 "DITHER_8X8_73", "DITHER_8X8_220"):
        np.testing.assert_array_equal(getattr(Y, name), getattr(J, name))
    assert Y._FORMATS == J._FORMATS
    assert Y.DEFAULT_INV_TABLE == J.DEFAULT_INV_TABLE
    for fmt in Y._FORMATS:
        for fr in (True, False):
            for kw in ({}, {"brightness": 12, "contrast": 70000,
                            "saturation": 50000}):
                got = Y._build_tables(fmt, fr, **kw)
                want = J._build_tables(fmt, fr, **kw)
                assert got[1] == want[1]
                for a, b in zip(got[:1] + got[2:], want[:1] + want[2:]):
                    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt", sorted(Y._FORMATS))
@pytest.mark.parametrize("full_range", [True, False])
def test_packed_matches_jax_and_oracles(fmt, full_range):
    y, cb, cr = _planes(seed=sorted(Y._FORMATS).index(fmt) * 2 + full_range)
    got = _port(y, cb, cr, fmt, full_range=full_range)
    want = _jax(y, cb, cr, fmt, full_range=full_range)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        PR.ref_yuv420_to_packed(y, cb, cr, fmt, full_range=full_range), want)
    np.testing.assert_array_equal(
        JR.ref_yuv420_to_packed(y, cb, cr, fmt, full_range=full_range), got)


@pytest.mark.parametrize("fmt", ["rgb565", "bgr565", "rgb555", "bgr555"])
@pytest.mark.parametrize("dither", [True, False])
def test_16bpp_dither_modes(fmt, dither):
    y, cb, cr = _planes(seed=7)
    got = _port(y, cb, cr, fmt, dither=dither)
    np.testing.assert_array_equal(got, _jax(y, cb, cr, fmt, dither=dither))
    np.testing.assert_array_equal(
        got, PR.ref_yuv420_to_packed(y, cb, cr, fmt, dither=dither))


@pytest.mark.parametrize("fmt", sorted(Y._FORMATS))
def test_packed_extreme_chroma(fmt):
    """Saturated inputs read past the tables' spans: the clamp of the flat
    index to the arena."""
    y, cb, cr = _planes(seed=3, extreme=True)
    for kw in ({"full_range": True}, {"full_range": False},
               {"brightness": 40, "contrast": 90000, "saturation": 120000}):
        np.testing.assert_array_equal(_port(y, cb, cr, fmt, **kw),
                                      _jax(y, cb, cr, fmt, **kw))


@pytest.mark.parametrize("fmt", ["rgb32", "bgr24", "rgb565", "rgb8", "rgb4",
                                 "bgr4_byte", "monoblack"])
def test_batched_equals_single_frames(fmt):
    y, cb, cr = _planes(seed=11, lead=(2, 3))
    got = _port(y, cb, cr, fmt)
    np.testing.assert_array_equal(got, _jax(y, cb, cr, fmt))
    for i in range(2):
        for j in range(3):
            np.testing.assert_array_equal(
                got[i, j], _port(y[i, j], cb[i, j], cr[i, j], fmt))


def test_monob_bit_order_and_rgb4_nibble_order():
    """monoblack: the leftmost pixel is the MSB; rgb4: the even column is
    the low nibble."""
    y = np.zeros((2, 8), np.uint8)
    y[:, 0] = 255
    c = np.full((1, 4), 128, np.uint8)
    mono = _port(y, c, c, "monoblack")
    assert mono.shape == (2, 1) and (mono == 0x80).all()
    np.testing.assert_array_equal(mono, _jax(y, c, c, "monoblack"))
    y = np.zeros((2, 8), np.uint8)
    y[:, 1::2] = 255                 # odd columns white
    nib = _port(y, c, c, "rgb4")
    assert nib.shape == (2, 4)
    assert ((nib & 0x0F) < (nib >> 4)).all()
    byte = _port(y, c, c, "rgb4_byte")
    np.testing.assert_array_equal(nib, byte[:, 0::2] | (byte[:, 1::2] << 4))
    np.testing.assert_array_equal(nib, _jax(y, c, c, "rgb4"))


@pytest.mark.parametrize("kind", ["yuyv422", "uyvy422"])
def test_yuv422_packing(kind):
    y, cb, cr = _planes(seed=5, lead=(2,))
    got = getattr(Y, f"yuv420_to_{kind}")(
        *(torch.from_numpy(a) for a in (y, cb, cr))).numpy()
    want = np.asarray(getattr(J, f"yuv420_to_{kind}")(y, cb, cr))
    assert got.shape == (2, H, 2 * W)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,fmt,match", [
    ((15, 24), "rgb24", "even dimensions"),
    ((16, 22), "rgb565", None),
    ((16, 21), "rgb565", "even dimensions"),
    ((16, 12), "monoblack", "width % 8"),
    ((16, 24), "rgb48", "unknown packed format"),
])
def test_value_errors(shape, fmt, match):
    h, w = shape
    y = torch.zeros((h, w), dtype=torch.uint8)
    c = torch.zeros((h // 2, w // 2), dtype=torch.uint8)
    if match is None:
        assert Y.yuv420_to_packed(y, c, c, fmt=fmt).shape == (h, w)
        return
    with pytest.raises(ValueError, match=match):
        Y.yuv420_to_packed(y, c, c, fmt=fmt)
    with pytest.raises(ValueError, match=match):
        J.yuv420_to_packed(y.numpy(), c.numpy(), c.numpy(), fmt=fmt)


def test_kernel_tables_layout():
    """Kernel Y's table buffer: the four offset tables, the dither matrices
    tiled to 8x8, then the arena."""
    for fmt in Y._FORMATS:
        depth = Y._FORMATS[fmt][0]
        for dither in (True, False):
            tab = Y.kernel_tables(fmt, True, dither, 0, 65536, 65536)
            arena, _, r, gu, gv, b = Y._build_tables(fmt, True)
            np.testing.assert_array_equal(tab[:1024],
                                          np.concatenate([r, gu, gv, b]))
            np.testing.assert_array_equal(tab[1216:], arena)
            for k, mat in enumerate(Y._dither_mats(depth, dither)):
                d = tab[1024 + 64 * k:1088 + 64 * k].reshape(8, 8)
                np.testing.assert_array_equal(d, Y._tile(mat, 8, 8))
            assert len(arena) <= 2048        # csrc/yuv2rgb_packed.cu


# ---------------------------------------------------------------- the CLI

N = 4


@pytest.fixture(scope="module")
def amv(tmp_path_factory):
    """A 4-frame 48x32 .amv with audio, written by the JAX package."""
    rng = np.random.default_rng(2)
    y, cb, cr = fixtures.rotozoom(N, 32, 48)
    y = np.clip(y.astype(np.int16) + rng.integers(-9, 10, y.shape), 0,
                255).astype(np.uint8)
    path = tmp_path_factory.mktemp("pix") / "in.amv"
    path.write_bytes(jax_encode.encode_to_bytes(
        y, cb, cr, fixtures.audiogen(N / 16, seed=2)))
    return str(path)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("fmt", [None] + cli._PIX_FMTS)
def test_cli_pix_fmt_matches_jax(amv, tmp_path, fmt):
    """Every -pix_fmt value to .raw, and the default rgb24 to .rgb: the
    same bytes and the same line as `python -m amv_tpu`."""
    ext = ".rgb" if fmt is None else ".raw"
    flags = ["-i", amv] + ([] if fmt is None else ["-pix_fmt", fmt])
    want_rc, want = _run(jcli.main, flags + [str(tmp_path / f"j{ext}")])
    got_rc, got = _run(cli.main, flags + [str(tmp_path / f"p{ext}"),
                                          "--device", "cpu"])
    assert got_rc == want_rc == 0
    assert got == want.replace(f"j{ext}", f"p{ext}")
    assert (tmp_path / f"p{ext}").read_bytes() == \
        (tmp_path / f"j{ext}").read_bytes()


@pytest.mark.parametrize("color", ["bt601", "amvlib"])
@pytest.mark.parametrize("name", ["one.bmp", "f_%04d.bmp"])
def test_cli_bmp_matches_jax(amv, tmp_path, color, name):
    """.bmp under both --color values, one file or every frame (%)."""
    want_rc, want = _run(jcli.main, ["-i", amv, "--color", color,
                                     str(tmp_path / "j" / name)])
    got_rc, got = _run(cli.main, ["-i", amv, "--color", color,
                                  str(tmp_path / "p" / name), "--device",
                                  "cpu"])
    assert got_rc == want_rc == 0 and got == want
    files = sorted(os.listdir(tmp_path / "j"))
    assert files == sorted(os.listdir(tmp_path / "p"))
    assert len(files) == (N if "%" in name else 1)
    for f in files:
        assert (tmp_path / "p" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()


# ------------------------------------------- the CLI's --info, --compare, ...

@pytest.fixture(scope="module")
def probe_files(amv, tmp_path_factory):
    """An .amv, an I420 .avi with PCM and an .act, each written by the JAX
    package."""
    from amv_tpu.containers import act as jact
    from amv_tpu.containers import avi as javi
    d = tmp_path_factory.mktemp("probe")
    rng = np.random.default_rng(6)
    y = rng.integers(0, 256, (3, 32, 48), np.uint8)
    c = rng.integers(0, 256, (3, 16, 24), np.uint8)
    (d / "in.avi").write_bytes(javi.mux(
        y, c, c, fixtures.audiogen(3 / 16, seed=6), fps=16,
        sample_rate=22050))
    frames = [bytes(rng.integers(0, 256, 10, np.uint8)) for _ in range(25)]
    (d / "in.act").write_bytes(jact.mux(frames, sample_rate=8000))
    return {".amv": amv, ".avi": str(d / "in.avi"), ".act": str(d / "in.act")}


@pytest.mark.parametrize("ext", [".amv", ".avi", ".act"])
def test_cli_info_matches_jax(probe_files, ext):
    want = _run(jcli.main, ["--info", probe_files[ext]])
    assert _run(cli.main, ["--info", probe_files[ext]]) == want
    assert want[0] == 0 and want[1]


def test_cli_compare_matches_jax(amv, tmp_path):
    """compare_amv's lines and exit codes: 0 on equal files, 1 on a file
    whose chunks differ."""
    data = open(amv, "rb").read()
    from amv_tpu_torch.containers import riff
    s = riff.demux(data)
    other = tmp_path / "other.amv"
    other.write_bytes(riff.mux(s.video_chunks[:2] + [s.video_chunks[2][:-5]]
                               + s.video_chunks[3:], s.audio_chunks[:3],
                               width=48, height=32, fps=16))
    for a, b in ((amv, amv), (amv, str(other)), (str(other), amv)):
        want = _run(jcli.main, ["--compare", a, b])
        assert _run(cli.main, ["--compare", a, b]) == want
    assert _run(cli.main, ["--compare", amv, amv]) == \
        (0, "Check successfully finished\n")
    rc, out = _run(cli.main, ["--compare", amv, str(other)])
    assert rc == 1 and out.endswith("mismatches\n")


def test_cli_benchmark_and_trace(amv, tmp_path, monkeypatch):
    """--benchmark prints utime, wall and maxrss after the route's line;
    with AMV_TRACE_DIR set the route leaves a torch.profiler trace under
    <dir>/cli."""
    monkeypatch.setenv("AMV_TRACE_DIR", str(tmp_path / "traces"))
    rc, out = _run(cli.main, ["-i", amv, "--benchmark", str(tmp_path /
                                                             "o.yuv"),
                              "--device", "cpu"])
    lines = out.splitlines()
    assert rc == 0 and lines[0].startswith("wrote ")
    assert re.fullmatch(r"bench: utime=\d+\.\d{3}s wall=\d+\.\d{3}s "
                        r"maxrss=\d+MB", lines[-1])
    traces = os.listdir(tmp_path / "traces" / "cli")
    assert len(traces) == 1 and traces[0].endswith(".json")
    text = (tmp_path / "traces" / "cli" / traces[0]).read_text()
    assert "traceEvents" in text
    monkeypatch.delenv("AMV_TRACE_DIR")
    rc, out = _run(cli.main, ["-i", amv, str(tmp_path / "p.yuv"), "--device",
                              "cpu"])
    assert rc == 0 and "bench:" not in out
    assert len(os.listdir(tmp_path / "traces" / "cli")) == 1
