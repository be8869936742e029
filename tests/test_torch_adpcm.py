"""Kernels A and Q's plain versions (the port's CPU path) and the port's
audio codec against the JAX package and the scalar oracle.

Kernel A (IMA-ADPCM decode) is held against `amv_tpu`'s Pallas decoder in
interpret mode and its XLA scan; kernel Q (encode) against the Pallas
encoder in interpret mode, the XLA scan encoder and a naive serial loop;
`codecs.amv_audio` against `amv_tpu.codecs.amv_audio` and
`amv_tpu.verify.ref_adpcm`.  Inputs are made with numpy from seeds.
Tolerance: exact equality (integer codec, bit-exact contract).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from amv_tpu.codecs import amv_audio as jax_audio  # noqa: E402
from amv_tpu.kernels import adpcm as KA  # noqa: E402
from amv_tpu.kernels.adpcm_encode_pallas import encode_streams_pallas  # noqa: E402
from amv_tpu.kernels.adpcm_pallas import decode_chunks_pallas  # noqa: E402
from amv_tpu.verify import fixtures, ref_adpcm  # noqa: E402
from amv_tpu_torch.codecs import amv_audio  # noqa: E402
from amv_tpu_torch.kernels import adpcm as A  # noqa: E402


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _decode_inputs(case, c=37, nb=150, seed=0):
    rng = np.random.default_rng(seed)
    pay = rng.integers(0, 256, (c, nb)).astype(np.uint8)
    pred = rng.integers(-32768, 32768, c).astype(np.int32)
    sidx = rng.integers(0, 89, c).astype(np.int32)
    if case == "0x77":          # the largest positive step every nibble
        pay[:] = 0x77
    elif case == "0xff_sidx88":  # the largest negative step from the top
        pay[:] = 0xFF
        sidx[:] = 88
        pred[:] = -32000
    return pay, pred, sidx


@pytest.mark.parametrize("case", ["random", "0x77", "0xff_sidx88"])
def test_decode_matches_jax(case):
    pay, pred, sidx = _decode_inputs(case)
    want = np.asarray(decode_chunks_pallas(
        jnp.asarray(pay), jnp.asarray(pred), jnp.asarray(sidx),
        interpret=True))
    got = A.decode_chunks(*_t(pay, pred, sidx))
    assert got.dtype == torch.int16 and got.shape == (37, 300)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(KA.decode_chunks(
        jnp.asarray(pay), jnp.asarray(pred), jnp.asarray(sidx))))


def test_decode_wrap_matches_tiled_copy():
    pay, pred, sidx = _decode_inputs("random", c=11, nb=64, seed=1)
    got = A.decode_chunks(*_t(pay, pred, sidx), repeat=4)
    tiled = (np.tile(pay, (4, 1)), np.tile(pred, 4), np.tile(sidx, 4))
    assert torch.equal(got, A.decode_chunks(*_t(*tiled)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(KA.decode_chunks(
        *(jnp.asarray(a) for a in tiled))))


def _naive_encode(x, reset, sidx0):
    """The serial adpcm_ima_compress_sample walk of one stream."""
    p, s, nib, before = 0, min(max(int(sidx0), 0), 88), [], []
    for t, v in enumerate(x):
        if reset[t]:
            p = int(v)
        before.append(s)
        n, p, s = ref_adpcm.compress_sample(p, s, int(v))
        nib.append(n)
    nib = np.array(nib)
    return (((nib[0::2] << 4) | nib[1::2]).astype(np.uint8),
            np.array(before[0::2], np.uint8))


def _encode_inputs(case):
    rng = np.random.default_rng(3)
    b, n = 5, 600
    x = rng.integers(-32768, 32768, (b, n)).astype(np.int16)
    x[1] = np.cumsum(rng.integers(-400, 400, n)).clip(-32768, 32767)
    reset = np.zeros((b, n), bool)
    reset[:, 0] = True
    reset[:, 250] = True            # mid-stream chunk boundaries
    reset[2, 418] = True
    sidx0 = rng.integers(0, 89, b).astype(np.int32)
    if case == "extremes":
        x[0], x[1] = 32767, -32768
        x[2, ::2], x[2, 1::2] = 30000, -30000
        x[3] = 0
        sidx0 = np.array([0, 88, 44, 0, 88], np.int32)
    elif case == "no_reset_at_0":
        reset[:, 0] = False
    return x, reset, sidx0


@pytest.mark.parametrize("case", ["random", "extremes", "no_reset_at_0"])
def test_encode_matches_jax(case):
    x, reset, sidx0 = _encode_inputs(case)
    got_b, got_s = A.encode_streams(*_t(x, reset, sidx0))
    want_b, want_s = encode_streams_pallas(
        jnp.asarray(x), jnp.asarray(reset), jnp.asarray(sidx0),
        interpret=True)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    nib, sb = KA.encode_samples(jnp.asarray(x.astype(np.int32)),
                                jnp.asarray(reset), jnp.asarray(sidx0))
    nib, sb = np.asarray(nib), np.asarray(sb)
    np.testing.assert_array_equal(
        got_b.numpy(), ((nib[:, 0::2] << 4) | nib[:, 1::2]).astype(np.uint8))
    np.testing.assert_array_equal(got_s.numpy(), sb[:, 0::2])


@pytest.mark.parametrize("resets", ["chunks", "odd", "none"])
def test_segment_parallel_matches_serial_loop(resets):
    """The three-pass segment-parallel encoder equals the serial walk: at
    even resets (segments), odd ones (applied inside a segment) and none
    (one segment)."""
    rng = np.random.default_rng(5)
    x = np.cumsum(rng.integers(-2000, 2000, 1200)).clip(
        -32768, 32767).astype(np.int16)[None]
    reset = np.zeros_like(x, bool)
    if resets == "chunks":
        reset[0, ::276] = True
    elif resets == "odd":
        reset[0, [0, 101, 555, 1001]] = True
    for s0 in (0, 37, 88):
        got_b, got_s = A.encode_streams(*_t(x, reset, np.array([s0],
                                                               np.int32)))
        want_b, want_s = _naive_encode(x[0], reset[0], s0)
        np.testing.assert_array_equal(got_b[0].numpy(), want_b)
        np.testing.assert_array_equal(got_s[0].numpy(), want_s)


def test_encode_wrap_matches_tiled_copy():
    x, reset, sidx0 = _encode_inputs("random")
    got = A.encode_streams(*_t(x, reset, sidx0), repeat=3)
    want = A.encode_streams(*_t(np.tile(x, (3, 1)), np.tile(reset, (3, 1)),
                                np.tile(sidx0, 3)))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_segments_table():
    reset = torch.zeros((2, 12), dtype=torch.bool)
    reset[0, [0, 4, 7]] = True
    reset[1, [6, 10]] = True
    stream, start, end, off = A.segments(reset)
    assert stream.tolist() == [0, 0, 1, 1, 1]
    assert start.tolist() == [0, 4, 0, 6, 10]
    assert end.tolist() == [4, 12, 6, 10, 12]
    assert off.tolist() == [0, 2, 5]


@pytest.mark.parametrize("fps,seconds", [(16, 1.3), (20, 0.9), (15, 0.7)])
def test_codec_matches_jax_and_oracle(fps, seconds):
    """frame_size 1378 (even), 1103 and 1470: the odd one exercises the
    odd-frame carry, and every rate the second-boundary padding."""
    frame_size = (2 * 22050 + fps) // (2 * fps)
    pcm = fixtures.audiogen(seconds, 22050, seed=fps)
    chunks = amv_audio.encode_stream(pcm, frame_size, 22050, device="cpu")
    assert chunks == ref_adpcm.encode(pcm, frame_size, 22050)
    assert chunks == jax_audio.encode_stream(pcm, frame_size, 22050)
    got = amv_audio.decode_chunks(chunks, device="cpu")
    np.testing.assert_array_equal(got, jax_audio.decode_chunks(chunks))
    np.testing.assert_array_equal(got, np.concatenate(
        [ref_adpcm.decode_chunk(c) for c in chunks]))


def test_decode_chunks_header_edge_cases():
    """A short chunk decodes to nothing; a header step index past 88 is
    clamped; chunks of different lengths are sliced to their own."""
    rng = np.random.default_rng(9)
    body = rng.integers(0, 256, 40).astype(np.uint8).tobytes()
    chunks = [b"\x10\x00\x5a\x00\x00\x00\x00\x00" + body,   # sidx 90
              b"\x01\x02", b"\x00\x80\x03\x00\x00\x00\x00\x00" + body[:7]]
    got = amv_audio.decode_chunks(chunks, device="cpu")
    np.testing.assert_array_equal(got, jax_audio.decode_chunks(chunks))
    np.testing.assert_array_equal(got, np.concatenate(
        [ref_adpcm.decode_chunk(c) for c in chunks]))
    assert amv_audio.decode_chunks([], device="cpu").shape == (0,)


def test_rejects_bad_inputs():
    x = torch.zeros((1, 7), dtype=torch.int16)
    with pytest.raises(ValueError, match="even"):
        A.encode_streams(x, torch.zeros((1, 7), dtype=torch.bool),
                         torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        A.decode_chunks(torch.zeros((2, 4), dtype=torch.uint8),
                        torch.zeros(2, dtype=torch.int64),
                        torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="init_step must be in 0..88"):
        amv_audio.encode_stream(np.zeros(100, np.int16), 1378, trellis=True,
                                init_step_index=89, device="cpu")
