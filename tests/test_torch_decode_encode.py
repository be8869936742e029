"""The port's decode and encode entry points on the CPU (plain versions of
kernels D, U, A and V, E, Q) against the JAX package and the C reference:
`pipeline.decode.decode_bytes`, `pipeline.batch.decode_many`,
`pipeline.encode.encode_to_bytes` (quant "ffmpeg" and "q60"), the CLI's
routes (`--device cpu`) and the explicit-device contract.
Inputs are made with numpy from seeds.  Tolerance: exact equality.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from amv_tpu import cli as jcli  # noqa: E402
from amv_tpu.containers import riff as jax_riff  # noqa: E402
from amv_tpu.pipeline import batch as jax_batch  # noqa: E402
from amv_tpu.pipeline import decode as jax_decode  # noqa: E402
from amv_tpu.pipeline import encode as jax_encode  # noqa: E402
from amv_tpu.pipeline import transcode as jax_transcode  # noqa: E402
from amv_tpu.verify import fixtures, ref_adpcm  # noqa: E402
from amv_tpu_torch import cli, native  # noqa: E402
from amv_tpu_torch.bitstream import jpeg_lossless as PL  # noqa: E402
from amv_tpu_torch.bitstream import jpeg_progressive as PP  # noqa: E402
from amv_tpu_torch.codecs import g729a as G  # noqa: E402
from amv_tpu_torch.codecs import mjpeg as MJ  # noqa: E402
from amv_tpu_torch.containers import avi, riff, wav  # noqa: E402
from amv_tpu_torch.kernels import transcode as T  # noqa: E402
from amv_tpu_torch.kernels.fdct import fdct_quantize  # noqa: E402
from amv_tpu_torch.pipeline import batch as PB  # noqa: E402
from amv_tpu_torch.pipeline import decode as PD  # noqa: E402
from amv_tpu_torch.pipeline import encode as PE  # noqa: E402

W, H, N = 48, 32, 6


@pytest.fixture(scope="module")
def clip():
    """(y, cb, cr, pcm, .amv bytes) of a 6-frame 48x32 clip at 16 fps."""
    rng = np.random.default_rng(0)
    y, cb, cr = fixtures.rotozoom(N, H, W)
    y = np.clip(y.astype(np.int16) + rng.integers(-5, 6, y.shape), 0,
                255).astype(np.uint8)
    pcm = fixtures.audiogen(N / 16, seed=1)
    return y, cb, cr, pcm, PE.encode_to_bytes(y, cb, cr, pcm, device="cpu")


def test_encode_matches_jax_and_c(clip):
    y, cb, cr, pcm, data = clip
    assert data == jax_encode.encode_to_bytes(y, cb, cr, pcm)
    s = riff.demux(data)
    assert s.video_chunks == [native.ref_encode_frame(y[i], cb[i], cr[i], 2)
                              for i in range(N)]
    assert s.audio_chunks == ref_adpcm.encode(pcm, 1378, 22050)
    assert PE.encode_to_bytes(y, cb, cr, pcm, fps=20, qscale=5,
                              device="cpu") == \
        jax_encode.encode_to_bytes(y, cb, cr, pcm, fps=20, qscale=5)


@pytest.mark.parametrize("kw", [{}, {"start_frame": 2, "max_frames": 3},
                                {"video": False}, {"audio": False}])
def test_decode_matches_jax_and_c(clip, kw):
    data = clip[4]
    got = PD.decode_bytes(data, device="cpu", **kw)
    want = jax_decode.decode_bytes(data, **kw)
    assert got.info == riff.demux(data).info
    for k in ("y", "cb", "cr", "pcm"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    s = jax_riff.demux(data)
    first = kw.get("start_frame", 0)
    for i in range(got.y.shape[0]):
        ref = native.ref_decode_frame(s.video_chunks[first + i], W, H)
        for k, plane in enumerate((got.y, got.cb, got.cr)):
            np.testing.assert_array_equal(plane[i], ref[k])


def test_decode_many_matches_jax(clip):
    """Three files of two geometries: one batch per geometry, each file's
    planes and PCM equal to the JAX package's."""
    y, cb, cr, pcm, data = clip
    rng = np.random.default_rng(9)
    y2, cb2, cr2 = fixtures.videogen(3, 24, 40, seed=9)
    y2 = np.clip(y2.astype(np.int16) + rng.integers(-3, 4, y2.shape), 0,
                 255).astype(np.uint8)
    other = PE.encode_to_bytes(y2, cb2, cr2, fixtures.audiogen(3 / 16, seed=9),
                               device="cpu")
    datas = [data, other, PE.encode_to_bytes(y[:2], cb[:2], cr[:2],
                                             pcm[:2756], device="cpu")]
    got = PB.decode_many(datas, device="cpu")
    want = jax_batch.decode_many(datas)
    assert len(got) == 3
    for g, x in zip(got, want):
        assert (g.info.width, g.info.height) == (x.info.width, x.info.height)
        for k in ("y", "cb", "cr", "pcm"):
            np.testing.assert_array_equal(getattr(g, k), getattr(x, k))
    with pytest.raises(TypeError):
        PB.decode_many(datas)                      # no default device


def _run(*argv):
    return cli.main([*map(str, argv), "--device", "cpu"])


def test_cli_decode_routes(clip, tmp_path):
    data = clip[4]
    src = tmp_path / "in.amv"
    src.write_bytes(data)
    dec = jax_decode.decode_bytes(data)
    assert _run("-i", src, tmp_path / "out.yuv") == 0
    raw = np.fromfile(tmp_path / "out.yuv", np.uint8).reshape(N, -1)
    np.testing.assert_array_equal(raw, np.concatenate(
        [p.reshape(N, -1) for p in (dec.y, dec.cb, dec.cr)], axis=1))
    assert _run("-i", src, tmp_path / "out.wav") == 0
    pcm, rate = wav.read_pcm(str(tmp_path / "out.wav"), device="cpu")
    assert rate == 22050
    np.testing.assert_array_equal(pcm.numpy(), dec.pcm)
    # --seek and -t (frames = t * the file's fps) as amv_tpu's CLI
    assert _run("-i", src, "--seek", 1, "-t", 0.25, tmp_path / "cut.yuv") == 0
    cut = jax_decode.decode_bytes(data, start_frame=1, max_frames=4)
    raw = np.fromfile(tmp_path / "cut.yuv", np.uint8).reshape(4, -1)
    np.testing.assert_array_equal(raw[:, :W * H], cut.y.reshape(4, -1))


def test_cli_encode_route(clip, tmp_path):
    y, cb, cr, pcm, data = clip
    yuv, wv = tmp_path / "in.yuv", tmp_path / "in.wav"
    np.concatenate([p.reshape(N, -1) for p in (y, cb, cr)],
                   axis=1).tofile(yuv)
    wav.write_pcm(str(wv), pcm, 22050)
    out = tmp_path / "out.amv"
    assert _run("-i", yuv, "-i", wv, "-f", "amv", "-s", f"{W}x{H}", "-r", 16,
                "-ar", 22050, out) == 0
    assert out.read_bytes() == data
    assert _run("-i", yuv, "-f", "amv", "-s", f"{W}x{H}", "-qscale", 4,
                "--max-frames", 3, out) == 0
    want = jax_encode.encode_to_bytes(y[:3], cb[:3], cr[:3],
                                      np.zeros(3 * 22050 // 16, np.int16),
                                      qscale=4)
    assert out.read_bytes() == want
    # AMV -> AMV with -s of the same size: the full decode and re-encode
    src = tmp_path / "in.amv"
    src.write_bytes(data)
    assert _run("-i", src, "-f", "amv", "-s", f"{W}x{H}", out) == 0
    dec = jax_decode.decode_bytes(data)
    assert out.read_bytes() == jax_encode.encode_to_bytes(
        dec.y, dec.cb, dec.cr, dec.pcm)


def test_cli_q60_routes(clip, tmp_path):
    """-amv_quant q60 on the encode and the transcode routes."""
    y, cb, cr, pcm, data = clip
    yuv, src, out = tmp_path / "in.yuv", tmp_path / "in.amv", \
        tmp_path / "out.amv"
    np.concatenate([p.reshape(N, -1) for p in (y, cb, cr)],
                   axis=1).tofile(yuv)
    src.write_bytes(data)
    assert _run("-i", yuv, "-f", "amv", "-s", f"{W}x{H}", "-amv_quant",
                "q60", out) == 0
    assert out.read_bytes() == PE.encode_to_bytes(
        y, cb, cr, np.zeros(N * 22050 // 16, np.int16), quant="q60",
        device="cpu")
    assert _run("-i", src, "-f", "amv", "-amv_quant", "q60", out) == 0
    assert out.read_bytes() == jax_transcode.transcode_bytes(data,
                                                             quant="q60")


def _progressive_frames(y, cb, cr):
    """The clip as progressive (SOF2) frames of the port's encoder: the
    coefficients of its baseline encode (qscale 2), DC made absolute."""
    mb_w, mb_h = (W + 15) // 16, (H + 15) // 16
    blocks = MJ.extract_blocks_topdown(
        *(torch.from_numpy(p) for p in (y, cb, cr)), "420", mb_w, mb_h)
    lv = fdct_quantize(blocks.contiguous(), MJ.T.encoder_qmat(2))
    lv = lv[..., torch.as_tensor(MJ.T.ZIGZAG).long()].numpy().copy()
    lv[..., 0] -= 128
    return [PP.encode_progressive(f, (W, H)) for f in lv]


@pytest.mark.parametrize("argv", [
    ["-i", "{amv}", "{tmp}/out.bmp"],
    ["-i", "{amv}", "-pix_fmt", "rgb565", "{tmp}/out.rgb"],
    ["-i", "{amv}", "-pix_fmt", "bgr24", "{tmp}/out.raw"],
    ["-i", "{sof2}", "-f", "amv", "{tmp}/out.amv"],
    ["-i", "{sof2}", "-f", "amv", "-s", "48x32", "{tmp}/out.amv"],
    ["-i", "{sof3}", "-f", "amv", "{tmp}/out.amv"],
    ["-i", "{sof3rgb}", "-f", "amv", "-s", "32x24", "{tmp}/out.amv"],
])
def test_cli_unported_routes_exit_nonzero(clip, tmp_path, argv):
    """The routes refused until their slice landed write `amv_tpu.cli`'s
    bytes: progressive (SOF2) and lossless (SOF3, YUV and RGB mode) MJPEG
    AVIs made by the port's encoders, through -f amv; the .bmp and
    -pix_fmt .rgb/.raw outputs (kernel Y)."""
    y, cb, cr, pcm, data = clip
    paths = {"amv": tmp_path / "in.amv", "tmp": tmp_path}
    paths["amv"].write_bytes(data)
    frames = {
        "sof2": _progressive_frames(y, cb, cr),
        "sof3": [PL.encode_lossless([y[i], cb[i], cr[i]], predictor=1 + i)
                 for i in range(N)],
        "sof3rgb": [PL.encode_lossless([y[i], y[i][::-1], y[i][:, ::-1]],
                                       predictor=4, rgb=True, rct=i % 2 == 0)
                    for i in range(N)]}
    for key, chunks in frames.items():
        paths[key] = tmp_path / f"{key}.avi"
        paths[key].write_bytes(avi.mux(
            y, cb, cr, pcm, fps=16, sample_rate=22050, video_chunks=chunks))
    out = argv[-1].format(**paths)
    assert _run(*(a.format(**paths) for a in argv)) == 0
    want = str(tmp_path / "jax") + os.path.splitext(out)[1]
    assert jcli.main([a.format(**paths) for a in argv[:-1]] + [want]) == 0
    with open(out, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


def test_explicit_device_contract(clip, tmp_path):
    y, cb, cr, pcm, data = clip
    with pytest.raises(TypeError):
        PD.decode_bytes(data)                      # no default device
    with pytest.raises(TypeError):
        G.init_state(2)
    with pytest.raises(TypeError):
        T.wrap_index(16, 2)
    assert G.init_state(2, device="cpu")["exc"].device.type == "cpu"
    assert T.wrap_index(16, 2, device="cpu").device.type == "cpu"
    with pytest.raises(TypeError):
        PE.encode_to_bytes(y, cb, cr, pcm)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PD.decode_bytes(data, device="cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PE.encode_to_bytes(y, cb, cr, pcm, device="cuda")
    assert PE.encode_to_bytes(y, cb, cr, pcm, quant="q60", device="cpu") == \
        jax_encode.encode_to_bytes(y, cb, cr, pcm, quant="q60")
    p8 = tmp_path / "u8.wav"
    p8.write_bytes(b"RIFF" + (36 + 4).to_bytes(4, "little") + b"WAVEfmt " +
                   (16).to_bytes(4, "little") +
                   bytes([1, 0, 1, 0, 0x22, 0x56, 0, 0, 0x22, 0x56, 0, 0, 1,
                          0, 8, 0]) + b"data" + (4).to_bytes(4, "little") +
                   b"\x80\x80\x80\x80")
    with pytest.raises(TypeError):
        wav.read_pcm(str(p8))                      # no default device
    pcm, rate = wav.read_pcm(str(p8), device="cpu")    # 8-bit PCM
    assert rate == 22050 and pcm.tolist() == [0, 0, 0, 0]


@pytest.mark.parametrize("quant", ["ffmpeg", "q60"])
@pytest.mark.parametrize("n_pcm", [0, 700])
def test_zero_frame_encode_matches_jax(quant, n_pcm):
    """No frames (and no audio, or less than a chunk of it): the port's
    file equals the JAX package's (324 bytes without audio)."""
    y = np.zeros((0, 120, 160), np.uint8)
    c = np.zeros((0, 60, 80), np.uint8)
    pcm = fixtures.audiogen(1.0, seed=3)[:n_pcm]
    got = PE.encode_to_bytes(y, c, c, pcm, quant=quant, device="cpu")
    assert got == jax_encode.encode_to_bytes(y, c, c, pcm, quant=quant)
    if n_pcm == 0:
        assert len(got) == 324


def test_unescape_no_frames():
    rows, lens = native.unescape_frames([])
    assert rows.shape == (0, 0) and rows.dtype == np.uint8
    assert lens.shape == (0,) and lens.dtype == np.int64
