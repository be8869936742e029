"""amvlib's decoder and API in the port (kernel W's plain version, kernel
D's plain version, `amvlib_api`) against the JAX package's
`amv_tpu.codecs.amvlib_video` and `amv_tpu.amvlib_api`.

The JAX API tests read a vendored device file that this repository lacks;
these run both APIs on a seeded fixture .amv written to tmp_path, at
device="cpu".  Every comparison is exact (array or byte equality).
"""

import os
import re

import numpy as np
import pytest
import torch

from amv_tpu import amvlib_api as JA
from amv_tpu.bitstream import jpeg_tables as JT
from amv_tpu.bitstream.entropy import huffman_decode_frames
from amv_tpu.codecs import amvlib_video as JV
from amv_tpu.pipeline import encode as jax_encode
from amv_tpu.verify import fixtures
from amv_tpu_torch import amvlib_api as A
from amv_tpu_torch import native
from amv_tpu_torch.codecs import amvlib_video as V
from amv_tpu_torch.codecs import jpeg_tables as PT
from amv_tpu_torch.kernels import entropy_decode as D

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: one intra-op thread beside the suite's
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tables_equal_jax():
    """The amvlib tables are the JAX package's: the ~Q75 pair, the zigzag
    with its 37/31 bug, and kernel W's copy of that zigzag."""
    np.testing.assert_array_equal(PT.AMVLIB_QUANT_LUMA, JT.AMVLIB_QUANT_LUMA)
    np.testing.assert_array_equal(PT.AMVLIB_QUANT_CHROMA,
                                  JT.AMVLIB_QUANT_CHROMA)
    np.testing.assert_array_equal(V.AMVLIB_ZIGZAG, JV.AMVLIB_ZIGZAG)
    assert (V.AMVLIB_ZIGZAG == 37).sum() == 2 and 31 not in V.AMVLIB_ZIGZAG
    src = open(os.path.join(ROOT, "amv_tpu_torch", "csrc",
                            "amvlib_idct.cu")).read()
    body = re.search(r"#define AMVLIB_ZIGZAG\s*\\\s*\{([^}]*)\}", src)
    table = [int(v) for v in re.findall(r"\d+", body.group(1))]
    assert table == V.AMVLIB_ZIGZAG.tolist()


def _levels(rng, f, m, large=False):
    lv = np.zeros((f, m, 6, 64), np.int16)
    mask = rng.random(lv.shape) < 0.2
    lv[mask] = rng.integers(-60, 61, mask.sum())
    lv[..., 0] = rng.integers(-200, 201, lv.shape[:3])
    if large:
        # cumulative DCs near 2^31 / 2^11 and wide ACs: the row pass's
        # c0 << 11 and its products wrap in int32
        lv[..., 0] = rng.integers(30000, 32768, lv.shape[:3])
        lv[..., 1:9] = rng.integers(-32768, 32768, lv[..., 1:9].shape)
    return lv


@pytest.mark.parametrize("w,h,f,large", [(48, 32, 2, False),
                                         (160, 120, 3, False),
                                         (25, 33, 2, False),
                                         (48, 32, 2, True)])
def test_transform_matches_jax(w, h, f, large):
    rng = np.random.default_rng(w * h + large)
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    lv = _levels(rng, f, mb_w * mb_h, large)
    got = V.decode_transform_amvlib(torch.from_numpy(lv), mb_w, mb_h, w, h)
    want = JV.decode_transform_amvlib(lv, mb_w, mb_h, w, h)
    for g, x in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    assert int(got[0].min()) >= -128 and int(got[0].max()) <= 383
    for c in got[1:]:
        assert int(c.min()) >= -256 and int(c.max()) <= 255


def test_transform_refuses_wrong_geometry():
    lv = torch.zeros((1, 6, 6, 64), dtype=torch.int16)
    with pytest.raises(ValueError, match="MCUs"):
        V.decode_transform_amvlib(lv, 3, 2, 64, 32)
    with pytest.raises(ValueError, match="int16"):
        V.decode_transform_amvlib(lv.int(), 3, 2, 48, 32)


def _payloads(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    y, cb, cr = fixtures.rotozoom(n, h, w)
    y = np.clip(y.astype(np.int16) + rng.integers(-8, 9, y.shape), 0,
                255).astype(np.uint8)
    return [native.ref_encode_frame(y[i], cb[i], cr[i], 2) for i in range(n)]


@pytest.mark.parametrize("w,h,n", [(48, 32, 3), (160, 120, 2)])
def test_levels_equal_huffman_decode_frames(w, h, n):
    """Kernel D's plain version gives amvlib's decoder the levels of
    `amv_tpu.bitstream.entropy.huffman_decode_frames`."""
    pays = _payloads(n, h, w, seed=w)
    n_mcu = ((w + 15) // 16) * ((h + 15) // 16)
    rows, lens = native.unescape_frames(pays)
    lv, ok = D.decode_scans(torch.from_numpy(rows), torch.from_numpy(lens),
                            n_mcu * 6)
    assert ok.all()
    np.testing.assert_array_equal(lv.view(n, n_mcu, 6, 64).numpy(),
                                  huffman_decode_frames(pays, n_mcu))


@pytest.mark.parametrize("w,h,n", [(48, 32, 3), (160, 120, 2)])
def test_rgb_matches_jax(w, h, n):
    pays = _payloads(n, h, w, seed=h)
    got = V.decode_frames_amvlib_rgb(pays, w, h, device="cpu")
    want = JV.decode_frames_amvlib_rgb(pays, w, h)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (n, h, w, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_rgb_malformed_frame_raises():
    pays = _payloads(2, 32, 48)
    garbage = b"\xff\xd8" + b"\xff\x00" * 40 + b"\xff\xd9"
    with pytest.raises(ValueError, match=r"frame\(s\) \[1\]"):
        V.decode_frames_amvlib_rgb([pays[0], garbage], 48, 32, device="cpu")


def test_entry_points_need_a_device():
    with pytest.raises(TypeError):
        V.decode_frames_amvlib_rgb(_payloads(1, 32, 48), 48, 32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            V.decode_frames_amvlib_rgb(_payloads(1, 32, 48), 48, 32,
                                       device="cuda")


# ---------------------------------------------------------------- the API

N_FRAMES = 5


@pytest.fixture(scope="module")
def amv_path(tmp_path_factory):
    """A 5-frame 48x32 .amv with audio, written by the JAX package."""
    rng = np.random.default_rng(4)
    y, cb, cr = fixtures.rotozoom(N_FRAMES, 32, 48)
    y = np.clip(y.astype(np.int16) + rng.integers(-7, 8, y.shape), 0,
                255).astype(np.uint8)
    path = tmp_path_factory.mktemp("amvlib") / "clip.amv"
    path.write_bytes(jax_encode.encode_to_bytes(
        y, cb, cr, fixtures.audiogen(N_FRAMES / 16, seed=4)))
    return str(path)


def _open(path):
    return A.AmvOpen(path, device="cpu"), JA.AmvOpen(path)


def test_open_close_and_bad_path(amv_path, tmp_path):
    amv, jamv = _open(amv_path)
    assert amv is not None and amv.opened
    assert amv.device == torch.device("cpu")
    assert amv.totalframe == jamv.totalframe
    assert vars(amv.amvinfo) == vars(jamv.amvinfo)
    A.AmvClose(amv)
    assert not amv.opened and amv.videobuf is None
    missing = str(tmp_path / "missing.amv")
    assert A.AmvOpen(missing, device="cpu") is None
    assert JA.AmvOpen(missing) is None
    bad = tmp_path / "bad.amv"
    bad.write_bytes(b"RIFF" + b"\0" * 40)
    assert (A.AmvOpen(str(bad), device="cpu") is None) == \
        (JA.AmvOpen(str(bad)) is None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            A.AmvOpen(amv_path)                 # device="cuda" by default


def test_frame_walk_and_end_of_stream(amv_path):
    amv, jamv = _open(amv_path)
    n = 0
    while True:
        assert A.AmvReadNextFrame(amv) == JA.AmvReadNextFrame(jamv) == 0
        fb, jfb = amv.framebuf, jamv.framebuf
        assert (fb.framenum, fb.videobuff, fb.audiobuff) == \
            (jfb.framenum, jfb.videobuff, jfb.audiobuff)
        if fb.framenum < 0:                      # AMV_END_
            assert fb.videobufflen == fb.audiobufflen == 0
            assert A.AmvVideoDecode(amv) == JA.AmvVideoDecode(jamv) == -1
            assert A.AmvAudioDecode(amv) == JA.AmvAudioDecode(jamv) == -1
            break
        n += 1
    assert n == N_FRAMES
    assert A.AmvRewindFrameStart(amv) == 0
    assert A.AmvReadNextFrame(amv) == 0 and amv.framebuf.framenum == 0
    A.AmvClose(amv)
    JA.AmvClose(jamv)
    for fn in (A.AmvReadNextFrame, A.AmvRewindFrameStart, A.AmvVideoDecode,
               A.AmvAudioDecode):
        assert fn(amv) == -1 and fn(None) == -1
    assert A.AmvCreateJpegFileFromFrameBuffer(amv, "/nonexistent") == -1
    assert A.AmvCreateWavFileFromAmvFile(None, 0, "x.wav") == -1


def test_video_and_audio_buffers_match_jax(amv_path):
    amv, jamv = _open(amv_path)
    for _ in range(N_FRAMES):
        A.AmvReadNextFrame(amv)
        JA.AmvReadNextFrame(jamv)
        assert A.AmvVideoDecode(amv) == JA.AmvVideoDecode(jamv) == 0
        assert A.AmvAudioDecode(amv) == JA.AmvAudioDecode(jamv) == 0
        assert amv.videobuf.shape == (32, 48, 3)
        np.testing.assert_array_equal(amv.videobuf, jamv.videobuf)
        np.testing.assert_array_equal(amv.audiobuf, jamv.audiobuf)
    # videobuf is the batch decode's frame, bottom-up BGR
    rgb = V.decode_frames_amvlib_rgb([amv.framebuf.videobuff], 48, 32,
                                     device="cpu")[0].numpy()
    np.testing.assert_array_equal(amv.videobuf, rgb[::-1, :, ::-1])


def test_jpeg_exports_and_bmp_converter_match_jax(amv_path, tmp_path):
    amv, jamv = _open(amv_path)
    for d in ("p", "j"):
        (tmp_path / d).mkdir()
    A.AmvReadNextFrame(amv)
    A.AmvReadNextFrame(amv)
    JA.AmvReadNextFrame(jamv)
    JA.AmvReadNextFrame(jamv)
    assert A.AmvCreateJpegFileFromFrameBuffer(amv, str(tmp_path / "p")) == \
        JA.AmvCreateJpegFileFromFrameBuffer(jamv, str(tmp_path / "j")) == 0
    jpg = (tmp_path / "p" / "1.jpg").read_bytes()
    assert jpg == (tmp_path / "j" / "1.jpg").read_bytes()
    assert jpg[:2] == b"\xFF\xD8" and jpg[-2:] == b"\xFF\xD9"
    one = tmp_path / "one.jpg"
    assert A.AmvCreateJpegFileFromBuffer(amv.amvinfo, amv.framebuf,
                                         str(one)) == 0
    assert one.read_bytes() == jpg
    assert A.AmvCreateJpegFileFromBuffer(amv.amvinfo, A.FrameBuff(),
                                         str(one)) == -1
    assert A.AmvCreateJpegFileFromBuffer(
        amv.amvinfo, amv.framebuf, str(tmp_path / "no" / "x.jpg")) == -2
    got, want = tmp_path / "p.bmp", tmp_path / "j.bmp"
    assert A.AmvConvertJpegFileToBmpFile(str(tmp_path / "p" / "1.jpg"),
                                         str(got), device="cpu") == 0
    assert JA.AmvConvertJpegFileToBmpFile(str(tmp_path / "j" / "1.jpg"),
                                          str(want)) == 0
    assert got.read_bytes() == want.read_bytes()
    assert got.read_bytes()[:2] == b"BM"
    assert A.AmvConvertJpegFileToBmpFile(str(tmp_path / "none.jpg"),
                                         str(got), device="cpu") == -1
    junk = tmp_path / "junk.jpg"
    junk.write_bytes(b"\xFF\xD8\xFF\xD9")
    assert A.AmvConvertJpegFileToBmpFile(str(junk), str(got),
                                         device="cpu") == \
        JA.AmvConvertJpegFileToBmpFile(str(junk), str(want)) == -1


def test_wav_exports_match_jax(amv_path, tmp_path):
    amv, jamv = _open(amv_path)
    for kind in (A.AUDIO_FILE_TYPE_PCM, A.AUDIO_FILE_TYPE_ADPCM_IMA):
        got, want = tmp_path / f"p{kind}.wav", tmp_path / f"j{kind}.wav"
        assert A.AmvCreateWavFileFromAmvFile(amv, kind, str(got)) == \
            JA.AmvCreateWavFileFromAmvFile(jamv, kind, str(want)) == 0
        assert got.read_bytes() == want.read_bytes()
    assert A.AUDIO_FILE_TYPE_PCM == JA.AUDIO_FILE_TYPE_PCM
    assert A.AmvCreateWavFileFromAmvFile(amv, 9, str(tmp_path / "x.wav")) \
        == JA.AmvCreateWavFileFromAmvFile(jamv, 9, "x.wav") == -1
    assert A.AmvCreateWavFileFromAmvFile(
        amv, 0, str(tmp_path / "no" / "x.wav")) == -2
