"""The port's WAV audio ingest (`amv_tpu_torch.codecs.wav_audio`, kernel A's
IMA-WAV route and `kernels.adpcm.decode_ms_nibbles`) and `containers.wav.
read_pcm` on the CPU against the JAX package and the scalar oracles of
`verify/ref_wav_audio.py` (the port's copy): every `decode_pcm_bytes`
format, mono and stereo, a short trailing IMA block, and MS-ADPCM's
extremes (negative idelta, full-scale samples, an idelta that wraps).
Inputs are made with numpy from seeds.  Tolerance: exact equality.
"""

import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from amv_tpu.codecs import wav_audio as jax_wav_audio  # noqa: E402
from amv_tpu.containers import wav as jax_wav  # noqa: E402
from amv_tpu.kernels import adpcm as jax_adpcm  # noqa: E402
from amv_tpu.verify import ref_wav_audio as jax_ref  # noqa: E402
from amv_tpu_torch.codecs import wav_audio  # noqa: E402
from amv_tpu_torch.containers import wav  # noqa: E402
from amv_tpu_torch.kernels import adpcm as A  # noqa: E402
from amv_tpu_torch.verify import ref_wav_audio as ref  # noqa: E402


def _ima_block(rng, channels, n_groups):
    hdr = b"".join(struct.pack("<hBB", int(rng.integers(-32768, 32768)),
                               int(rng.integers(0, 100)), 0)  # > 88 clamps
                   for _ in range(channels))
    return hdr + bytes(rng.integers(0, 256, 4 * channels * n_groups,
                                    dtype=np.uint8))


def _ms_block(rng, channels, n_data):
    hdr = bytes(int(rng.integers(0, 8)) for _ in range(channels))
    for _ in range(channels):  # idelta
        hdr += struct.pack("<h", int(rng.integers(-200, 4000)))
    for _ in range(2 * channels):  # sample1, sample2
        hdr += struct.pack("<h", int(rng.integers(-32768, 32768)))
    return hdr + bytes(rng.integers(0, 256, n_data, dtype=np.uint8))


# the MS-ADPCM block of tests/test_wav_audio.py's extremes test: negative
# idelta, full-scale samples, nibbles 7 and 8 that grow |idelta| until it
# wraps in int32
MS_EXTREMES = (bytes([6]) + struct.pack("<hhh", -32768, 32767, -32768) +
               bytes([0x7F, 0x88, 0xF0, 0x08] * 6))


def _same(got: torch.Tensor, want: np.ndarray):
    assert got.dtype == torch.int16 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)


def test_oracle_copy_matches_jax():
    for name in ("ALAW_TABLE", "ULAW_TABLE", "MS_ADAPTATION_TABLE",
                 "MS_ADAPT_COEFF1", "MS_ADAPT_COEFF2"):
        assert np.array_equal(getattr(ref, name), getattr(jax_ref, name))
    data = _ima_block(np.random.default_rng(0), 2, 3)
    for kind, d, ch in (("ima", data, 2), ("ms", MS_EXTREMES, 1)):
        assert np.array_equal(ref.decode_blocks(d, ch, len(d), kind),
                              jax_ref.decode_blocks(d, ch, len(d), kind))
    assert ref._w32(0x7FFFFFFF + 1) == -0x80000000


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("fmt,bits", [(1, 8), (1, 16), (1, 24), (1, 32),
                                      (6, 8), (7, 8)])
def test_pcm_formats_match_jax(fmt, bits, channels):
    """PCM u8/s16/s24/s32, A-law and mu-law; 301 bytes, so each width
    leaves a partial sample or frame to drop."""
    data = bytes(np.random.default_rng(fmt + bits).integers(
        0, 256, 301, dtype=np.uint8))
    _same(wav_audio.decode_pcm_bytes(data, fmt, bits, channels,
                                     device="cpu"),
          jax_wav_audio.decode_pcm_bytes(data, fmt, bits, channels))


def test_unsupported_formats_raise():
    for fmt, bits in ((1, 12), (0x55, 16)):
        with pytest.raises(ValueError):
            jax_wav_audio.decode_pcm_bytes(b"\0" * 8, fmt, bits, 1)
        with pytest.raises(ValueError):
            wav_audio.decode_pcm_bytes(b"\0" * 8, fmt, bits, 1, device="cpu")


@pytest.mark.parametrize("channels", [1, 2])
def test_ima_wav_matches_jax_and_oracle(channels):
    rng = np.random.default_rng(3 + channels)
    ba = 4 * channels + 4 * channels * 5
    data = b"".join(_ima_block(rng, channels, 5) for _ in range(4))
    got = wav_audio.decode_ima_wav(data, channels, ba, device="cpu")
    _same(got, jax_wav_audio.decode_ima_wav(data, channels, ba))
    want = ref.decode_blocks(data, channels, ba, "ima")
    _same(got, want if channels > 1 else want[:, 0])


@pytest.mark.parametrize("channels,tail", [(1, 7), (1, 0), (2, 9), (2, 3)])
def test_ima_wav_short_trailing_block(channels, tail):
    """A last block shorter than block_align (its lanes shorter than the
    others': padded, then cropped), or too short for its headers."""
    rng = np.random.default_rng(9 + tail)
    ba = 4 * channels + 20 * channels
    data = b"".join(_ima_block(rng, channels, 5) for _ in range(3))
    data += _ima_block(rng, channels, 5)[:4 * channels + tail]
    got = wav_audio.decode_ima_wav(data, channels, ba, device="cpu")
    _same(got, jax_wav_audio.decode_ima_wav(data, channels, ba))
    want = ref.decode_blocks(data, channels, ba, "ima")
    _same(got, want if channels > 1 else want[:, 0])


@pytest.mark.parametrize("channels", [1, 2, 3])
def test_ms_matches_jax_and_oracle(channels):
    rng = np.random.default_rng(17 + channels)
    ba = 7 * channels + 24
    data = b"".join(_ms_block(rng, channels, 24) for _ in range(4))
    data += _ms_block(rng, channels, 10)                # a short last block
    got = wav_audio.decode_ms(data, channels, ba, device="cpu")
    _same(got, jax_wav_audio.decode_ms(data, channels, ba))
    if channels < 3:                 # the oracle knows one or two channels
        want = ref.decode_blocks(data, channels, ba, "ms")
        _same(got, want if channels > 1 else want[:, 0])


def test_ms_extremes_wrap_as_jax_and_oracle():
    data = MS_EXTREMES + MS_EXTREMES[:7] + bytes([0x88] * 40)
    for ba in (len(MS_EXTREMES), 0):
        got = wav_audio.decode_ms(data, 1, ba, device="cpu")
        _same(got, jax_wav_audio.decode_ms(data, 1, ba))
        _same(got, ref.decode_blocks(data, 1, ba or len(data), "ms")[:, 0])


def test_decode_ms_nibbles_matches_jax():
    """The lane loop alone, at states that overflow int32: the predictor
    product, idelta's growth and the sum all wrap as lax.scan's do."""
    rng = np.random.default_rng(5)
    b, n = 9, 40
    nib = rng.integers(0, 16, (b, n)).astype(np.int32)
    nib[:3] = 8                                   # |idelta| x 3 a sample
    st = [np.asarray(v, np.int32) for v in (
        rng.choice([256, 512, 0, 192, 240, 460, 392], b),
        rng.choice([0, -256, 0, 64, 0, -208, -232], b),
        np.r_[[2 ** 30, -2 ** 31, 2 ** 31 - 1], rng.integers(-300, 5000,
                                                              b - 3)],
        rng.integers(-32768, 32768, b), rng.integers(-32768, 32768, b))]
    got = A.decode_ms_nibbles(*(torch.from_numpy(a) for a in (nib, *st)))
    want = np.asarray(jax_adpcm.decode_ms_nibbles(
        *(jnp.asarray(a) for a in (nib, *st))))
    _same(got, want)


def test_empty_inputs_match_jax():
    for ch in (1, 2):
        for dec, jdec, n in ((wav_audio.decode_ima_wav,
                              jax_wav_audio.decode_ima_wav, 4),
                             (wav_audio.decode_ms, jax_wav_audio.decode_ms,
                              7)):
            short = b"\0" * (n * ch - 1)
            _same(dec(short, ch, 64, device="cpu"), jdec(short, ch, 64))


def _wav_file(path, fmt, channels, rate, bits, block_align, payload):
    hdr = b"fmt " + struct.pack("<IHHIIHH", 16, fmt, channels, rate,
                                rate * max(block_align, 1), block_align, bits)
    hdr += b"LIST" + struct.pack("<I", 3) + b"abc\0"    # a chunk to skip
    hdr += b"data" + struct.pack("<I", len(payload)) + payload
    path.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(hdr)) + b"WAVE" +
                     hdr)
    return str(path)


@pytest.mark.parametrize("fmt,bits,ch", [(1, 16, 1), (1, 16, 2), (1, 8, 2),
                                         (1, 24, 1), (1, 32, 2), (6, 8, 1),
                                         (7, 8, 2), (0x11, 4, 1),
                                         (0x11, 4, 2), (2, 4, 2)])
def test_read_pcm_matches_jax(tmp_path, fmt, bits, ch):
    rng = np.random.default_rng(fmt * 7 + bits + ch)
    if fmt == 0x11:
        ba = 4 * ch + 16 * ch
        payload = b"".join(_ima_block(rng, ch, 4) for _ in range(5))
    elif fmt == 2:
        ba = 7 * ch + 20
        payload = b"".join(_ms_block(rng, ch, 20) for _ in range(5))
    else:
        ba = ch * bits // 8
        payload = bytes(rng.integers(0, 256, 600, dtype=np.uint8))
    path = _wav_file(tmp_path / "in.wav", fmt, ch, 8000, bits, ba, payload)
    got, rate = wav.read_pcm(path, device="cpu")
    want, want_rate = jax_wav.read_pcm(path)
    assert rate == want_rate == 8000
    _same(got, want)


def test_read_pcm_needs_a_device(tmp_path):
    path = _wav_file(tmp_path / "in.wav", 1, 1, 8000, 16, 2, b"\1\0" * 8)
    with pytest.raises(TypeError):
        wav.read_pcm(path)                            # no default device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            wav.read_pcm(path, device="cuda")


@pytest.mark.parametrize("ch", [2, 3])
def test_downmix_truncates_like_numpy_mean(ch):
    """The channels' mean truncated toward zero, at odd negative sums and
    at full scale."""
    rng = np.random.default_rng(ch)
    pcm = rng.integers(-32768, 32768, (500, ch)).astype(np.int16)
    pcm[:4] = [[-32768] * ch, [32767] * ch, [-1] + [0] * (ch - 1),
               [-32768] + [32767] * (ch - 1)]
    _same(wav_audio.downmix(torch.from_numpy(pcm)),
          pcm.mean(axis=1).astype(np.int16))
