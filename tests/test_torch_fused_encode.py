"""Kernel V's plain version (the port's CPU path) against the JAX package.

* `encode_fused` (JAX's contract) against `amv_tpu`'s Pallas
  `encode_fused` in interpret mode on 16 frames of 32x32 at qscale 2 (one
  compile);
* `encode_planes` / `encode_transform` (the encode path's entry) against
  `amv_tpu.codecs.amv_video.encode_transform` with quant "ffmpeg" and
  "q60" at 32x32, 40x24 (chroma 20 wide) and 33x25 (odd), and the q60 DC
  chain on flat frames at the luma extremes;
* `encode_frames` at an odd size against the C encoder, and with q60
  against the JAX package's bytes.
Inputs are made with numpy from seeds.  Tolerance: exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from amv_tpu.codecs import amv_video as jax_video  # noqa: E402
from amv_tpu.kernels.encode_fused_pallas import (  # noqa: E402
    encode_fused as jax_encode_fused)
from amv_tpu.verify import fixtures  # noqa: E402
from amv_tpu_torch import native  # noqa: E402
from amv_tpu_torch.codecs import amv_video  # noqa: E402
from amv_tpu_torch.kernels import encode_fused as V  # noqa: E402


def _pictures(n, h, w, seed):
    rng = np.random.default_rng(seed)
    y, cb, cr = fixtures.rotozoom(n, h, w)
    y = np.clip(y.astype(np.int16) + rng.integers(-6, 7, y.shape), 0,
                255).astype(np.uint8)
    return y, cb, cr


def test_encode_fused_matches_jax_interpret():
    rng = np.random.default_rng(0)
    f, mb_w, mb_h = 16, 2, 2
    y = rng.integers(0, 256, (f, 32, 32)).astype(np.uint8)
    cb = rng.integers(0, 256, (f, 16, 16)).astype(np.uint8)
    cr = rng.integers(0, 256, (f, 16, 16)).astype(np.uint8)
    y[:2] = np.array([0, 255] * 16, np.uint8)           # extreme patterns
    cb[2] = 255
    qk = tuple(int(v) for v in amv_video.encoder_qmat(2))
    want = np.asarray(jax_encode_fused(jnp.asarray(y), jnp.asarray(cb),
                                       jnp.asarray(cr), mb_w, mb_h, qk,
                                       interpret=True))
    got = V.encode_fused(*(torch.from_numpy(p) for p in (y, cb, cr)), mb_w,
                         mb_h, 2)
    assert tuple(got.shape) == (f, 4, 6, 64) and got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    part = V.encode_fused(*(torch.from_numpy(p[:3]) for p in (y, cb, cr)),
                          mb_w, mb_h, qk)
    np.testing.assert_array_equal(part.numpy(), want[:3])


@pytest.mark.parametrize("quant", ["ffmpeg", "q60"])
@pytest.mark.parametrize("w,h", [(32, 32), (40, 24), (33, 25)])
def test_encode_transform_matches_jax(w, h, quant):
    y, cb, cr = _pictures(3, h, w, seed=w + h)
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    for qscale in (1, 5):
        want = jax_video.encode_transform(
            jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), mb_w, mb_h,
            qscale, quant=quant)
        got = amv_video.encode_transform(
            *(torch.from_numpy(p) for p in (y, cb, cr)), mb_w, mb_h, qscale,
            quant)
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_q60_flat_frame_extremes_match_jax():
    """The q60 DC chain at the clip rails (tests/test_q60_mode.py's flat
    frames): levels and bytes equal to the JAX package's."""
    w, h = 48, 32
    for val in (0, 255, 128, 13):
        y = np.full((2, h, w), val, np.uint8)
        cb = np.full((2, h // 2, w // 2), 255 - val, np.uint8)
        cr = np.full((2, h // 2, w // 2), val, np.uint8)
        want = jax_video.encode_transform(jnp.asarray(y), jnp.asarray(cb),
                                          jnp.asarray(cr), 3, 2, quant="q60")
        got = amv_video.encode_transform(
            *(torch.from_numpy(p) for p in (y, cb, cr)), 3, 2, quant="q60")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert amv_video.encode_frames(y, cb, cr, quant="q60",
                                       device="cpu") == \
            jax_video.encode_frames(y, cb, cr, quant="q60")


@pytest.mark.parametrize("w,h", [(33, 25), (34, 17)])
def test_encode_frames_odd_size(w, h):
    """Odd sizes: ffmpeg bytes equal the C encoder's, q60 bytes the JAX
    package's, and the q60 payloads decode through the C decoder to the
    port's decode."""
    y, cb, cr = _pictures(3, h, w, seed=7)
    pays = amv_video.encode_frames(y, cb, cr, 2, device="cpu")
    assert pays == [native.ref_encode_frame(y[i], cb[i], cr[i], 2)
                    for i in range(3)]
    q60 = amv_video.encode_frames(y, cb, cr, quant="q60", device="cpu")
    assert q60 == jax_video.encode_frames(y, cb, cr, quant="q60")
    dec = amv_video.decode_frames(q60, w, h, device="cpu")
    for i, p in enumerate(q60):
        for k, ref in enumerate(native.ref_decode_frame(p, w, h)):
            np.testing.assert_array_equal(dec[k][i], ref)


def test_encode_planes_rejects_bad_inputs():
    y = torch.zeros((2, 16, 16), dtype=torch.uint8)
    c = torch.zeros((2, 8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="quant"):
        V.encode_planes(y, c, c, 2, "q50")
    with pytest.raises(ValueError, match="cb"):
        V.encode_planes(y, c[:, :4], c, 2)
    with pytest.raises(ValueError, match="two rows"):
        V.encode_planes(y[:, :1], c[:, :0], c[:, :0], 2)
    with pytest.raises(ValueError):
        V.encode_fused(y.int(), c, c, 1, 1, 2)


def test_q60_reciprocals_divide_exactly():
    """Kernel V's q60 multipliers give (n + den/2) // den for every n below
    2^17 and every den = 8 * Q60 of both tables."""
    from amv_tpu_torch.codecs.jpeg_tables import Q60_CHROMA, Q60_LUMA
    den = 8 * np.concatenate([Q60_LUMA, Q60_CHROMA]).astype(np.uint64)
    mul = V.q60_reciprocals()
    assert mul.dtype == np.uint32 and mul.shape == (128,)
    n = np.arange(1 << 17, dtype=np.uint64)
    for d, m in zip(den, mul):
        got = ((n + d // 2) * np.uint64(m)) >> np.uint64(32)   # __umulhi
        assert np.array_equal(got, (n + d // 2) // d), int(d)
