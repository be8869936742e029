"""The port's rescaling (`amv_tpu_torch.kernels.scale`), resampling
(`kernels.resample`) and colour conversion (`kernels.color`) on the CPU
against the JAX package: `resize_plane` for each filter at identity, x2
down, 640x480 -> 160x120, 176x144 -> 160x120 and an upscale;
`resize_yuv420` with 'bicublin'; `resample_pcm` at 44,100 / 48,000 /
8,000 -> 22,050 and 22,050 -> 8,000, on an empty input, one under 16
samples and at +-32,767; the three colour conversions.  Inputs are made
with numpy from seeds.  Tolerance: exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from amv_tpu.kernels import color as jax_color  # noqa: E402
from amv_tpu.kernels import resample as jax_resample  # noqa: E402
from amv_tpu.kernels import scale as jax_scale  # noqa: E402
from amv_tpu_torch.kernels import color, resample, scale  # noqa: E402

FILTERS = ["bilinear", "bicubic", "point", "area", "lanczos", "gauss",
           "sinc", "spline", "experimental"]
SIZES = {"identity": ((24, 32), (24, 32)), "half": ((24, 32), (12, 16)),
         "640x480": ((480, 640), (120, 160)),
         "176x144": ((144, 176), (120, 160)), "up": ((10, 14), (24, 36))}


def _same(got: torch.Tensor, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert got.numpy().dtype == want.dtype and np.array_equal(got.numpy(),
                                                              want)


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("filt", FILTERS)
def test_resize_plane_matches_jax(filt, size):
    (sh, sw), (dh, dw) = SIZES[size]
    n = 1 if sh * sw > 30000 else 3
    x = np.random.default_rng(sh + dw).integers(0, 256, (n, sh, sw),
                                                dtype=np.uint8)
    _same(scale.resize_plane(torch.from_numpy(x), dh, dw, filt),
          jax_scale.resize_plane(jnp.asarray(x), dh, dw, filt))


def test_build_taps_match_jax():
    """The host weights are the same integers (numpy float64 on both
    sides), every row summing to 2^14."""
    for filt in FILTERS:
        for (sh, sw), (dh, dw) in SIZES.values():
            for a, b in ((sw, dw), (sh, dh)):
                idx, w = scale._build_taps(a, b, filt)
                jidx, jw = jax_scale._build_taps(a, b, filt)
                assert np.array_equal(idx, jidx) and np.array_equal(w, jw)
                assert (w.sum(axis=1) == 1 << 14).all()


@pytest.mark.parametrize("filt", ["bicublin", "bicubic", "area"])
def test_resize_yuv420_matches_jax(filt, monkeypatch):
    """Batched frames, BATCH_PLANES at a time (2 here: three batches)."""
    rng = np.random.default_rng(7)
    planes = [rng.integers(0, 256, (5, 48, 64), dtype=np.uint8)] + [
        rng.integers(0, 256, (5, 24, 32), dtype=np.uint8) for _ in range(2)]
    monkeypatch.setattr(scale, "BATCH_PLANES", 2)
    got = scale.resize_yuv420(*map(torch.from_numpy, planes), 24, 40,
                              filt=filt)
    want = jax_scale.resize_yuv420(*map(jnp.asarray, planes), 24, 40,
                                   filt=filt)
    for g, w in zip(got, want):
        _same(g, w)
    with pytest.raises(ValueError):
        scale.resize_yuv420(*map(torch.from_numpy, planes), 23, 40)


@pytest.mark.parametrize("rates", [(44100, 22050), (48000, 22050),
                                   (8000, 22050), (22050, 8000),
                                   (22050, 22050)])
@pytest.mark.parametrize("n", [0, 11, 3001])
def test_resample_matches_jax(rates, n):
    x = np.random.default_rng(n).integers(-32768, 32768, n).astype(np.int16)
    got = resample.resample_pcm(x, *rates, device="cpu")
    _same(got, jax_resample.resample_pcm(x, *rates))
    assert got.shape[0] == n * rates[1] // rates[0]


@pytest.mark.parametrize("rates", [(44100, 22050), (8000, 22050)])
def test_resample_extremes_match_jax(rates):
    """Full-scale alternation and runs: the int32 sums' clip to int16."""
    x = np.full(500, 32767, np.int16)
    x[::2] = -32767
    x[200:260] = -32768
    x[300:360] = 32767
    _same(resample.resample_pcm(torch.from_numpy(x), *rates, device="cpu"),
          jax_resample.resample_pcm(x, *rates))


def test_color_matches_jax():
    rng = np.random.default_rng(11)
    rgb = rng.integers(0, 256, (3, 10, 14, 3), dtype=np.uint8)
    rgb[0] = 0
    rgb[1] = 255
    for g, w in zip(color.rgb_to_yuv420_bt601(torch.from_numpy(rgb)),
                    jax_color.rgb_to_yuv420_bt601(jnp.asarray(rgb))):
        _same(g, w)
    y = rng.integers(0, 256, (2, 10, 14), dtype=np.uint8)
    cb, cr = (rng.integers(0, 256, (2, 5, 7), dtype=np.uint8)
              for _ in range(2))
    for mode in ("bt601", "amvlib"):
        _same(color.yuv420_to_rgb(*map(torch.from_numpy, (y, cb, cr)),
                                  mode=mode),
              jax_color.yuv420_to_rgb(y, cb, cr, mode=mode))
