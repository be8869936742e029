"""Kernel U's plain version (the port's CPU path) against the JAX package.

* `decode_fused` (JAX's contract) against `amv_tpu`'s Pallas
  `decode_fused` in interpret mode on 16 frames of 32x32 (one compile);
* `decode_planes` / `decode_transform` (the decode path's entry) against
  `amv_tpu.codecs.amv_video.decode_transform` at 32x32, 40x24 (chroma 20
  wide) and 33x25 (odd), with and without the un-sort;
* `decode_frames` at an odd size against the C decoder and the JAX
  package.
Inputs are made with numpy from seeds.  Tolerance: exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from amv_tpu.codecs import amv_video as jax_video  # noqa: E402
from amv_tpu.kernels.decode_fused_pallas import (  # noqa: E402
    decode_fused as jax_decode_fused)
from amv_tpu.verify import fixtures  # noqa: E402
from amv_tpu_torch import native  # noqa: E402
from amv_tpu_torch.codecs import amv_video  # noqa: E402
from amv_tpu_torch.kernels import decode_fused as U  # noqa: E402


def _levels(rng, shape, dense=0.2):
    """Sparse levels in +-1023 with small values in slot 0."""
    lv = np.where(rng.random(shape) < dense,
                  rng.integers(-1023, 1024, shape), 0)
    lv[..., 0] = rng.integers(-40, 41, shape[:-1])
    return lv.astype(np.int16)


def test_decode_fused_matches_jax_interpret():
    rng = np.random.default_rng(0)
    f, mb_w, mb_h = 16, 2, 2
    lv = _levels(rng, (f, 4, 6, 64))
    lv[:3, :, :, 1:] = 0                                   # DC-only blocks
    lv[3:5, :, :, 1:] = 1023                               # wrapping sums
    dc = rng.integers(-40000, 40000, (f, 4, 6)).astype(np.int32)
    want = jax_decode_fused(jnp.asarray(lv), jnp.asarray(dc), mb_w, mb_h,
                            f_t=16, interpret=True)
    got = U.decode_fused(torch.from_numpy(lv), torch.from_numpy(dc), mb_w,
                         mb_h)
    for g, w, shape in zip(got, want, ((f, 32, 32), (f, 16, 16),
                                       (f, 16, 16))):
        assert tuple(g.shape) == shape and g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # any F: frames are independent, so 5 frames give JAX's first 5
    part = U.decode_fused(torch.from_numpy(lv[:5]), torch.from_numpy(dc[:5]),
                          mb_w, mb_h)
    for g, w in zip(part, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:5])


@pytest.mark.parametrize("w,h", [(32, 32), (40, 24), (33, 25)])
def test_decode_transform_matches_jax(w, h):
    rng = np.random.default_rng(w * h)
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    f = 5
    lv = _levels(rng, (f, mb_w * mb_h, 6, 64))
    want = jax_video.decode_transform(jnp.asarray(lv), mb_w, mb_h, w, h)
    got = amv_video.decode_transform(torch.from_numpy(lv), mb_w, mb_h, w, h)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    # the path entry's un-sort: batch frame i lands on frame perm[i]
    perm = rng.permutation(f)
    lvt = torch.from_numpy(lv)
    dc = amv_video.resolve_dc(lvt).reshape(-1)
    moved = U.decode_planes(lvt.reshape(-1, 64), dc, w, h,
                            dst=torch.from_numpy(perm))
    for g, x in zip(moved, want):
        np.testing.assert_array_equal(g.numpy()[perm], np.asarray(x))


def test_decode_frames_odd_size_matches_c_and_jax():
    w, h = 33, 25
    rng = np.random.default_rng(3)
    y, cb, cr = fixtures.videogen(4, h, w, seed=3)
    cb, cr = cb[:, :h // 2, :w // 2], cr[:, :h // 2, :w // 2]
    y = np.clip(y.astype(np.int16) + rng.integers(-4, 5, y.shape), 0,
                255).astype(np.uint8)
    pays = [native.ref_encode_frame(y[i], cb[i], cr[i], 2) for i in range(4)]
    got = amv_video.decode_frames(pays, w, h, device="cpu")
    want = jax_video.decode_frames(pays, w, h)
    for i in range(4):
        ref = native.ref_decode_frame(pays[i], w, h)
        for k in range(3):
            np.testing.assert_array_equal(got[k][i], ref[k])
            np.testing.assert_array_equal(got[k][i], want[k][i])


def test_decode_planes_rejects_bad_inputs():
    lv = torch.zeros((12, 64), dtype=torch.int16)
    dc = torch.zeros(12, dtype=torch.int32)
    with pytest.raises(ValueError, match="dst"):
        U.decode_planes(lv, dc, 16, 16, dst=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="dst"):
        U.decode_planes(lv, dc, 16, 16, dst=torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="whole"):
        U.decode_planes(lv, dc, 48, 16)
    with pytest.raises(ValueError, match="two rows"):
        U.decode_planes(lv[:6], dc[:6], 16, 1)
    with pytest.raises(ValueError):
        U.decode_fused(lv.reshape(2, 1, 6, 64), dc.long().reshape(2, 1, 6),
                       1, 1)
