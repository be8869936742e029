"""The port's AVI container (`amv_tpu_torch.containers.avi`) and its CLI
routes on the CPU against the JAX package: demux fields and mux bytes
(idx1, ODML indx, no index, AVIX), `seek_frame`, `extract_yuv420` for every
raw format (on the CPU route; the card's is in test_torch_cuda.py),
`extract_pcm`, and both CLIs on the AVI/AMV encode routes with -s, -ar and
-psnr and on `clip.amv -> out.avi`.  Inputs are made with numpy from
seeds.  Tolerance: exact equality.
"""

import dataclasses
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from amv_tpu import cli as jax_cli  # noqa: E402
from amv_tpu.containers import avi as jax_avi  # noqa: E402
from amv_tpu.pipeline import encode as jax_encode  # noqa: E402
from amv_tpu.verify import fixtures  # noqa: E402
from amv_tpu_torch import cli  # noqa: E402
from amv_tpu_torch.bitstream import jpeg_lossless  # noqa: E402
from amv_tpu_torch.bitstream import jpeg_progressive  # noqa: E402
from amv_tpu_torch.containers import avi  # noqa: E402


def _chunk(tag, body):
    return tag + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def _fields(st):
    d = dataclasses.asdict(st)
    d["palette"] = None if st.palette is None else st.palette.tolist()
    return d


def _same_streams(got, want):
    assert [_fields(s) for s in got] == [_fields(s) for s in want]


def _planes(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, h, w), dtype=np.uint8),
            rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8),
            rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8))


def _odml(data):
    """data (a muxed AVI) rebuilt with an ODML standard index ('indx' of
    type 1 in the video strl, absolute offsets, every third chunk a
    keyframe) and no idx1."""
    riff = data[12:]
    hdrl_size = struct.unpack_from("<I", riff, 4)[0]
    hdrl = riff[8:8 + hdrl_size]
    movi = riff[8 + hdrl_size:]
    movi = movi[:8 + struct.unpack_from("<I", movi, 4)[0]]
    strl_at = hdrl.index(b"LIST", 4)            # the video stream's strl
    strl_size = struct.unpack_from("<I", hdrl, strl_at + 4)[0]

    def build(entries):
        body = struct.pack("<HBBI4sQI", 2, 0, 1, len(entries), b"00dc", 0, 0)
        body += b"".join(struct.pack("<II", o, s | (0x80000000 if k % 3
                                                    else 0))
                         for k, (o, s) in enumerate(entries))
        strl = hdrl[strl_at + 8:strl_at + 8 + strl_size] + _chunk(b"indx",
                                                                 body)
        out = b"AVI " + _chunk(b"LIST", hdrl[:strl_at] + _chunk(b"LIST", strl)
                               + hdrl[strl_at + 8 + strl_size:]) + movi
        return b"RIFF" + struct.pack("<I", len(out)) + out

    n = len(jax_avi.demux(data, use_index=False)[0].chunks)
    probe = jax_avi.demux(build([(0, 0)] * n), use_index=False)[0]
    return build([(o, s) for (o, s, _) in probe.index])


@pytest.fixture(scope="module")
def files():
    y, cb, cr = _planes(5, 16, 24)
    pcm = np.random.default_rng(1).integers(-30000, 30000, 4000).astype(
        np.int16)
    idx1 = jax_avi.mux(y, cb, cr, pcm, fps=16, sample_rate=22050)
    riff = idx1[12:]
    hdrl_size = struct.unpack_from("<I", riff, 4)[0]
    movi = riff[8 + hdrl_size:]
    movi = movi[:8 + struct.unpack_from("<I", movi, 4)[0]]
    body = b"AVI " + riff[:8 + hdrl_size] + movi
    noindex = b"RIFF" + struct.pack("<I", len(body)) + body
    odml = _odml(idx1)
    avix = idx1[:8] + b"AVIX" + idx1[12:]
    return {"idx1": idx1, "none": noindex, "odml": odml, "avix": avix}


@pytest.mark.parametrize("kind", ["idx1", "none", "odml", "avix"])
@pytest.mark.parametrize("use_index", [True, False])
def test_demux_matches_jax(files, kind, use_index):
    data = files[kind]
    got = avi.demux(data, use_index=use_index)
    _same_streams(got, jax_avi.demux(data, use_index=use_index))
    assert [s.kind for s in got] == ["video", "audio"]
    if kind == "odml" and use_index:
        assert any(not k for _, _, k in got[0].index)


@pytest.mark.parametrize("audio,mjpg", [(True, False), (False, False),
                                        (True, True)])
def test_mux_matches_jax(audio, mjpg):
    y, cb, cr = _planes(4, 16, 24, seed=3)
    pcm = (np.random.default_rng(4).integers(-3000, 3000, 3001 if audio
                                             else 0)).astype(np.int16)
    chunks = [bytes(range(k, k + 9 + k)) for k in range(4)] if mjpg else None
    got = avi.mux(y, cb, cr, pcm, fps=16, sample_rate=22050,
                  video_chunks=chunks)
    assert got == jax_avi.mux(y, cb, cr, pcm, fps=16, sample_rate=22050,
                              video_chunks=chunks)


def test_seek_frame_matches_jax(files):
    st = avi.demux(files["odml"])[0]
    jst = jax_avi.demux(files["odml"])[0]
    for f in range(-2, len(st.index) + 2):
        assert avi.seek_frame(st, f) == jax_avi.seek_frame(jst, f)
    bare = avi.AviStream("video", chunks=[b"x"] * 5)
    jbare = jax_avi.AviStream("video", chunks=[b"x"] * 5)
    for f in (-1, 0, 3, 9):
        assert avi.seek_frame(bare, f) == jax_avi.seek_frame(jbare, f)


def _raw_stream(codec, bits, w, h, n, rng, **kw):
    """A stream of n random frames of exactly the bytes `codec` reads, and
    a few extra bytes on the last (JAX reads each frame's prefix)."""
    fb = avi._layout(avi.AviStream("video", codec=codec, width=w, height=h,
                                   bits=bits, **kw))[1]
    chunks = [bytes(rng.integers(0, 256, fb + 3 * (k == n - 1),
                                 dtype=np.uint8)) for k in range(n)]
    return dict(codec=codec, width=w, height=h, bits=bits, chunks=chunks,
                **kw)


_GRAY = np.stack([np.arange(256)] * 3 + [np.zeros(256)], -1).astype(np.uint8)
FORMATS = [(b"I420", 12, {}), (b"IYUV", 12, {}), (b"YV12", 12, {}),
           (b"YUY2", 16, {}), (b"YUYV", 16, {}), (b"V422", 16, {}),
           (b"YUNV", 16, {}), (b"UYVY", 16, {}), (b"Y422", 16, {}),
           (b"UYNV", 16, {}), (b"Y800", 8, {}), (b"GREY", 8, {}),
           (b"DIB ", 8, {}), (b"DIB ", 8, {"palette": _GRAY}),
           (b"DIB ", 8, {"palette": "random"}),
           (b"\0\0\0\0", 8, {"palette": "random"}),
           (b"DIB ", 16, {}), (b"DIB ", 16, {"bitmasks": (0xF800, 0x07E0,
                                                          0x001F)}),
           (b"DIB ", 24, {}), (b"\0\0\0\0", 24, {}), (b"DIB ", 32, {}),
           (b"DIB ", 4, {})]


@pytest.mark.parametrize("codec,bits,kw", FORMATS,
                         ids=[f"{c.decode(errors='replace').strip()}-{b}-{i}"
                              for i, (c, b, _) in enumerate(FORMATS)])
def test_extract_yuv420_matches_jax(codec, bits, kw, monkeypatch):
    """Every raw format at 22 x 10 (pal8 and BGR24 rows padded by 2
    bytes), 5 frames in batches of 2 (the pinned slots reused)."""
    rng = np.random.default_rng(len(codec) + bits)
    if isinstance(kw.get("palette"), str):
        kw = {"palette": rng.integers(0, 256, (200, 4), dtype=np.uint8)}
    spec = _raw_stream(codec, bits, 22, 10, 5, rng, **kw)
    monkeypatch.setattr(avi, "BATCH_FRAMES", 2)
    got = avi.extract_yuv420(avi.AviStream("video", **spec), device="cpu")
    want = jax_avi.extract_yuv420(jax_avi.AviStream("video", **spec))
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8 and np.array_equal(g.numpy(), w)


def test_extract_yuv420_refusals(monkeypatch):
    """Progressive (SOF2) and lossless (SOF3) MJPEG streams, once refused,
    give the JAX package's planes (lossless in YUV 4:2:0, 4:2:2, gray and
    RGB modes, in batches of 2 frames); other codecs and short frames are
    refused by both."""
    rng = np.random.default_rng(9)
    monkeypatch.setattr(avi, "BATCH_FRAMES", 2)
    pics = [rng.integers(0, 256, (16, 16), dtype=np.uint8) for _ in range(5)]
    lv = np.zeros((1, 6, 64), np.int16)
    lv[0, :, :10] = rng.integers(-20, 21, (6, 10))
    streams = {
        "sof2": [jpeg_progressive.encode_progressive(lv * k, (16, 16))
                 for k in (1, 2, 3)],
        "sof3 420": [jpeg_lossless.encode_lossless(
            [p, p[:8, :8], p[8:, 8:]], predictor=4) for p in pics],
        "sof3 422": [jpeg_lossless.encode_lossless(
            [p, p[:, :8], p[:, 8:]], predictor=2) for p in pics],
        "sof3 gray": [jpeg_lossless.encode_lossless([p], predictor=7)
                      for p in pics],
        "sof3 rgb": [jpeg_lossless.encode_lossless(
            [p, p.T, p[::-1]], predictor=6, rgb=True, pegasus=True)
            for p in pics]}
    for key, chunks in streams.items():
        spec = dict(codec=b"MJPG", width=16, height=16, chunks=chunks)
        got = avi.extract_yuv420(avi.AviStream("video", **spec), device="cpu")
        want = jax_avi.extract_yuv420(jax_avi.AviStream("video", **spec))
        for g, w in zip(got, want):
            assert g.dtype == torch.uint8, key
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for codec, bits in ((b"H264", 24), (b"XVID", 12)):
        st = dict(codec=codec, width=16, height=16, bits=bits,
                  chunks=[bytes(rng.integers(0, 256, 1000, dtype=np.uint8))])
        if bits == 24:
            st["codec"] = b"DIB "
            st["chunks"] = [st["chunks"][0][:100]]        # a short frame
        with pytest.raises(ValueError):
            jax_avi.extract_yuv420(jax_avi.AviStream("video", **st))
        with pytest.raises(ValueError):
            avi.extract_yuv420(avi.AviStream("video", **st), device="cpu")
    empty = avi.extract_yuv420(avi.AviStream("video", codec=b"I420",
                                             width=8, height=6),
                               device="cpu")
    assert [tuple(p.shape) for p in empty] == [(0, 6, 8), (0, 3, 4),
                                               (0, 3, 4)]


def _ms_block(rng, channels, n_data):
    hdr = bytes(int(rng.integers(0, 8)) for _ in range(channels))
    for _ in range(channels):
        hdr += struct.pack("<h", int(rng.integers(-200, 4000)))
    for _ in range(2 * channels):
        hdr += struct.pack("<h", int(rng.integers(-32768, 32768)))
    return hdr + bytes(rng.integers(0, 256, n_data, dtype=np.uint8))


@pytest.mark.parametrize("fmt,bits,ch", [(1, 16, 1), (1, 0, 2), (1, 16, 3),
                                         (1, 8, 2), (1, 24, 2), (6, 8, 2),
                                         (2, 4, 2), (2, 4, 1), (0x11, 4, 2)])
def test_extract_pcm_matches_jax(fmt, bits, ch):
    """extract_pcm, including the MS-ADPCM stereo downmix (a float mean
    truncated toward zero in JAX: odd negative sums)."""
    rng = np.random.default_rng(fmt * 10 + ch)
    if fmt == 2:
        ba = 7 * ch + 30
        data = [_ms_block(rng, ch, 30) for _ in range(5)]
    elif fmt == 0x11:
        ba = 4 * ch + 8 * ch
        data = [struct.pack("<hBB", -777, 40, 0) * ch +
                bytes(rng.integers(0, 256, 8 * ch, dtype=np.uint8))
                for _ in range(4)]
    else:
        ba = 0
        data = [bytes(rng.integers(0, 256, 301, dtype=np.uint8))
                for _ in range(3)]
    kw = dict(codec=struct.pack("<H", fmt), channels=ch, bits=bits,
              block_align=ba, sample_rate=22050, chunks=data)
    got = avi.extract_pcm(avi.AviStream("audio", **kw), device="cpu")
    want = jax_avi.extract_pcm(jax_avi.AviStream("audio", **kw))
    assert got.dtype == torch.int16 and np.array_equal(got.numpy(), want)


# ------------------------------------------------------------- CLI routes

def _run_both(argv, tmp_path, capsys):
    """Both CLIs on argv (output paths formatted with {out}); -> the two
    outputs' bytes and the lines each printed."""
    outs = []
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        out = tmp_path / f"{name}{argv[-1]}"
        assert main([*argv[:-1], str(out), *extra]) == 0
        outs.append((out.read_bytes(), capsys.readouterr().out))
    return outs


def _write_avi(tmp_path, n, w, h, rate, seed=0):
    y, cb, cr = fixtures.videogen(n, h, w, seed=seed)
    pcm = fixtures.audiogen(n / 16, rate, seed=seed)
    data = jax_avi.mux(y, cb[:, :h // 2, :w // 2], cr[:, :h // 2, :w // 2],
                       pcm, fps=16, sample_rate=rate)
    path = tmp_path / "in.avi"
    path.write_bytes(data)
    return str(path)


@pytest.mark.parametrize("flags", [
    ["-s", "32x24"],
    ["-s", "32x24", "-sws_flags", "bicublin", "--seek", "2",
     "--max-frames", "3"],
    ["-s", "64x48", "-t", "0.25"],
])
def test_cli_avi_canonical_matches_jax(tmp_path, capsys, flags):
    """The canonical `-i in.avi -f amv -r 16 -s WxH -ac 1 -ar 22050`: an
    I420 AVI with 44,100 Hz PCM, rescaled and resampled; the bytes and the
    printed lines of both CLIs."""
    src = _write_avi(tmp_path, 6, 64, 48, 44100)
    (a, pa), (b, pb) = _run_both(["-i", src, "-f", "amv", "-r", "16",
                                  "-ac", "1", "-ar", "22050", *flags,
                                  ".amv"], tmp_path, capsys)
    assert a == b
    assert pa.splitlines()[:-1] == pb.splitlines()[:-1]
    assert "resampling audio 44100 -> 22050 Hz" in pb


def test_cli_amv_rescale_and_psnr_match_jax(tmp_path, capsys):
    y, cb, cr = fixtures.videogen(4, 32, 48, seed=5)
    pcm = fixtures.audiogen(4 / 16, 22050, seed=5)
    amv = tmp_path / "in.amv"
    amv.write_bytes(jax_encode.encode_to_bytes(y, cb, cr, pcm))
    for flags in (["-s", "32x24", "-ar", "16000"],
                  ["-s", "32x24", "-psnr", "-sws_flags", "lanczos"],
                  ["-psnr"]):
        (a, pa), (b, pb) = _run_both(["-i", str(amv), "-f", "amv", *flags,
                                      ".amv"], tmp_path, capsys)
        assert a == b
        got = [ln for ln in pb.splitlines() if not ln.startswith("wrote")]
        assert got == [ln for ln in pa.splitlines()
                       if not ln.startswith("wrote")]
        assert ("-psnr" in flags) == ("PSNR Mean Y:" in pb)


@pytest.mark.parametrize("fmt", ["ima", "ms", "u8", "alaw"])
def test_cli_yuv_and_wav_match_jax(tmp_path, capsys, fmt):
    """.yuv + an 8 kHz WAV (stereo for the PCM formats) resampled to
    22,050 Hz."""
    rng = np.random.default_rng(8)
    y, cb, cr = _planes(3, 24, 32, seed=8)
    yuv = tmp_path / "in.yuv"
    np.concatenate([p.reshape(3, -1) for p in (y, cb, cr)], 1).tofile(yuv)
    if fmt == "ima":
        tag, ch, ba, bits = 0x11, 1, 4 + 64, 4
        payload = b"".join(struct.pack("<hBB", int(rng.integers(-999, 999)),
                                       int(rng.integers(0, 60)), 0) +
                           bytes(rng.integers(0, 256, 64, dtype=np.uint8))
                           for _ in range(20))
    elif fmt == "ms":
        tag, ch, ba, bits = 2, 2, 14 + 40, 4
        payload = b"".join(_ms_block(rng, 2, 40) for _ in range(20))
    else:
        tag, ch, ba, bits = (1 if fmt == "u8" else 6), 2, 2, 8
        payload = bytes(rng.integers(0, 256, 3000, dtype=np.uint8))
    hdr = b"fmt " + struct.pack("<IHHIIHH", 16, tag, ch, 8000, 8000 * ba, ba,
                                bits)
    hdr += b"data" + struct.pack("<I", len(payload)) + payload
    wavp = tmp_path / "in.wav"
    wavp.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(hdr)) + b"WAVE" +
                     hdr)
    (a, _), (b, _) = _run_both(["-i", str(yuv), "-i", str(wavp), "-f", "amv",
                                "-s", "32x24", "-ar", "22050", ".amv"],
                               tmp_path, capsys)
    assert a == b


def test_cli_amv_to_avi_matches_jax(tmp_path, capsys):
    y, cb, cr = fixtures.videogen(3, 32, 48, seed=6)
    pcm = fixtures.audiogen(3 / 16, 22050, seed=6)
    amv = tmp_path / "in.amv"
    amv.write_bytes(jax_encode.encode_to_bytes(y, cb, cr, pcm))
    (a, _), (b, _) = _run_both(["-i", str(amv), ".avi"], tmp_path, capsys)
    assert a == b
    (a, _), (b, _) = _run_both(["-i", str(amv), "--seek", "1", ".avi"],
                               tmp_path, capsys)
    assert a == b
    # and the AVI back through both encoders
    (a, _), (b, _) = _run_both(["-i", str(tmp_path / "port.avi"), "-f", "amv",
                                ".amv"], tmp_path, capsys)
    assert a == b
