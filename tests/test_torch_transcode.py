"""The port's complete AMV->AMV transcode on the CPU (plain versions of
kernels D, T and E) against the JAX package and the C reference.

* frames under 4,096 bytes: byte-identical to `amv_tpu`'s transcode_bytes
  (whose CPU route packs into at most 4,096 bytes a frame);
* larger frames: byte-identical to the single-core C reference transcode
  `ref_encode_frame(*ref_decode_frame(p, w, h), qscale)`;
* the CLI, the JAX-free import and the explicit-device contract.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from amv_tpu.containers import riff  # noqa: E402
from amv_tpu.native import entropy_native as native  # noqa: E402
from amv_tpu.pipeline import transcode as jax_transcode  # noqa: E402
from amv_tpu.verify import fixtures, ref_adpcm  # noqa: E402
from amv_tpu_torch.pipeline import transcode as P  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clip(kind, n, h, w, seed=0, qscale=2, audio=True):
    """(payloads, .amv bytes): C-encoded frames plus ADPCM audio."""
    rng = np.random.default_rng(seed)
    y, cb, cr = (fixtures.videogen(n, h, w, seed=seed) if kind == "videogen"
                 else fixtures.rotozoom(n, h, w))
    cb, cr = cb[:, :h // 2, :w // 2], cr[:, :h // 2, :w // 2]
    y = np.clip(y.astype(np.int16) + rng.integers(-2, 3, y.shape), 0,
                255).astype(np.uint8)
    pays = [native.ref_encode_frame(y[i], cb[i], cr[i], qscale)
            for i in range(n)]
    chunks = (ref_adpcm.encode(fixtures.audiogen(n / 16, seed=seed), 1378,
                               22050) if audio else [])
    return pays, riff.mux(pays, chunks, width=w, height=h, fps=16)


def _c_reference(pays, w, h, qscale=2):
    return [native.ref_encode_frame(*native.ref_decode_frame(p, w, h), qscale)
            for p in pays]


def test_matches_jax_transcode_bytes():
    pays, data = _clip("videogen", 4, 120, 160)
    assert max(len(p) for p in pays) < 4096
    want = jax_transcode.transcode_bytes(data, qscale=2)
    got = P.transcode_bytes(data, qscale=2, device="cpu")
    assert got == want
    s = riff.demux(got)
    assert s.audio_chunks == riff.demux(data).audio_chunks
    assert s.video_chunks == _c_reference(pays, 160, 120)


@pytest.mark.parametrize("qscale", [2, 5])
def test_large_frames_match_c_reference(qscale):
    pays, data = _clip("rotozoom", 3, 120, 160, qscale=qscale, audio=False)
    assert max(len(p) for p in pays) > 4096
    got = riff.demux(P.transcode_bytes(data, qscale=qscale, device="cpu"))
    assert got.video_chunks == _c_reference(pays, 160, 120, qscale)


@pytest.mark.parametrize("kind,w,h", [("rotozoom", 40, 24),
                                      ("videogen", 40, 32),
                                      ("rotozoom", 36, 20),
                                      ("videogen", 33, 25),
                                      ("rotozoom", 34, 17)])
def test_width_padding_matches_c_reference(kind, w, h):
    """Widths that are not whole MCUs: right-hand pad columns in luma, and
    chroma planes 20 and 18 pixels wide, edge-replicated by kernel T; odd
    sizes (34x17 has a chroma pad MCU row with no picture row) through the
    two-stage route, kernels U and V."""
    pays, data = _clip(kind, 3, h, w, seed=1, audio=False)
    got = riff.demux(P.transcode_bytes(data, qscale=2, device="cpu"))
    assert got.video_chunks == _c_reference(pays, w, h)


def test_complete_trims_words_to_the_longest_reencode():
    pays, _ = _clip("videogen", 3, 48, 64, audio=False)
    rows, lens = native.unescape_frames(pays)
    rows = torch.from_numpy(rows)
    words, bits, ok = P.transcode_complete(rows, torch.from_numpy(lens), 12,
                                           2, (64, 48))
    assert ok.all()
    assert words.shape[1] == (int(bits.max()) + 31) // 32
    assert words.shape[1] < P.word_budget(rows)
    assert native.escape_frames(words.numpy(), bits.numpy()) == \
        _c_reference(pays, 64, 48)


def test_reencode_outgrowing_the_first_word_budget():
    """Input blocks with one +-1023 coefficient in slot 63 decode to
    clipped high-frequency patterns whose qscale-1 re-encode is many times
    the input scan: the encoder runs again with the exact budget."""
    from amv_tpu.bitstream.entropy import huffman_encode_frame
    rng = np.random.default_rng(4)
    lv = np.zeros((2, 4, 6, 64), np.int16)
    lv[..., 0] = rng.integers(60, 200, (2, 4, 6))
    lv[..., 63] = rng.choice([-1023, 1023], (2, 4, 6))
    pays = [huffman_encode_frame(lv[f]) for f in range(2)]
    data = riff.mux(pays, [], width=32, height=32, fps=16)
    got = riff.demux(P.transcode_bytes(data, qscale=1, device="cpu"))
    want = _c_reference(pays, 32, 32, qscale=1)
    stride = native.unescape_frames(pays)[0].shape[1]
    assert min(len(x) for x in want) > 4 * P.word_budget(
        torch.zeros((1, stride)))
    assert got.video_chunks == want


def test_malformed_frame_takes_host_route():
    """A frame the Huffman decoder rejects raises ValueError naming it, as
    the JAX package's host route raises there (the C decoder rejects it
    too); the port keeps no host-entropy route."""
    pays, data = _clip("videogen", 3, 32, 32, audio=False)
    garbage = b"\xff\xd8" + b"\xff\x00" * 40 + b"\xff\xd9"
    bad = pays[:1] + [garbage] + pays[1:]
    data = riff.mux(bad, [], width=32, height=32, fps=16)
    with pytest.raises(ValueError, match=r"frame\(s\) \[1\]"):
        P.transcode_bytes(data, qscale=2, device="cpu")
    with pytest.raises(ValueError):
        native.ref_decode_frame(garbage, 32, 32)
    assert not hasattr(P, "HOST_FALLBACKS")


def test_cli_matches_library(tmp_path):
    pays, data = _clip("videogen", 3, 48, 64, seed=2)
    src, dst = tmp_path / "in.amv", tmp_path / "out.amv"
    src.write_bytes(data)
    res = subprocess.run(
        [sys.executable, "-m", "amv_tpu_torch", "-i", str(src), "-f", "amv",
         "-qscale", "3", str(dst), "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert dst.read_bytes() == P.transcode_bytes(data, qscale=3, device="cpu")
    bmp = tmp_path / "out.bmp"
    res = subprocess.run(
        [sys.executable, "-m", "amv_tpu_torch", "-i", str(src), str(bmp),
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout == "wrote 1 BMP frame(s)\n"
    h, w = 48, 64
    assert bmp.read_bytes()[:2] == b"BM" and \
        len(bmp.read_bytes()) == 54 + h * ((w * 3 + 3) & ~3)


def _port_sources():
    """The port's Python sources and chip_smoke.py."""
    for d, _, files in os.walk(os.path.join(ROOT, "amv_tpu_torch")):
        yield from (os.path.join(d, f) for f in sorted(files)
                    if f.endswith(".py"))
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_never_imports_jax():
    """Every module of the port, and chip_smoke.py's imports, load without
    JAX and without anything of amv_tpu; no source names amv_tpu in an
    import."""
    mods = []
    for f in _port_sources():
        rel = os.path.relpath(f, ROOT)[:-3].replace(os.sep, ".")
        if rel.startswith("amv_tpu_torch.") and not rel.endswith("__main__"):
            mods.append(rel.removesuffix(".__init__"))
    code = "\n".join([
        "import importlib, sys",
        f"for m in {mods!r}: importlib.import_module(m)",
        "import chip_smoke",
        "chip_smoke.import_port()",
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'amv_tpu'))",
        "assert not bad, bad"])
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(mods) > 20 and "amv_tpu_torch.pipeline.serving" in mods
    assert {"amv_tpu_torch.containers.avi", "amv_tpu_torch.kernels.color",
            "amv_tpu_torch.kernels.scale", "amv_tpu_torch.kernels.resample",
            "amv_tpu_torch.codecs.wav_audio",
            "amv_tpu_torch.verify.ref_wav_audio",
            "amv_tpu_torch.codecs.adpcm_trellis",
            "amv_tpu_torch.kernels.adpcm_trellis",
            "amv_tpu_torch.verify.ref_trellis",
            "amv_tpu_torch.codecs.mjpeg",
            "amv_tpu_torch.bitstream.jpeg_parse",
            "amv_tpu_torch.amvlib_api", "amv_tpu_torch.codecs.amvlib_video",
            "amv_tpu_torch.kernels.yuv2rgb_dither",
            "amv_tpu_torch.verify.ref_yuv2rgb",
            "amv_tpu_torch.verify.compare",
            "amv_tpu_torch.utils.profiling"} <= set(mods)
    pat = re.compile(r"^\s*(import amv_tpu\b|from amv_tpu(\.|\s+import\b))",
                     re.M)
    hits = [f for f in _port_sources() if pat.search(open(f).read())]
    assert not hits, hits


def test_device_contract():
    _, data = _clip("videogen", 1, 32, 32, audio=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.transcode_bytes(data, qscale=2, device="cuda")
    with pytest.raises(TypeError):
        P.transcode_bytes(data, qscale=2)          # no default device
    assert P.transcode_bytes(data, quant="q60", device="cpu") == \
        jax_transcode.transcode_bytes(data, quant="q60")
    _, odd = _clip("videogen", 2, 25, 33)
    assert P.transcode_bytes(odd, qscale=3, device="cpu") == \
        jax_transcode.transcode_bytes(odd, qscale=3)
