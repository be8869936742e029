"""Kernel T's plain version (the port's CPU path) against the JAX package.

`amv_tpu_torch`'s block transcode (dequant + IDCT + FDCT + requant) is
held against `amv_tpu.pipeline.transcode.transcode_levels_fused`, which
runs the Pallas `transcode_zz` kernel in interpret mode on the CPU, on
both outputs.  One static qscale keeps to one interpret compile.
Tolerance: exact equality (integer codec, bit-exact contract).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from amv_tpu.bitstream.entropy import huffman_decode_frames  # noqa: E402
from amv_tpu.codecs.amv_video import _encoder_quant_qmat_np  # noqa: E402
from amv_tpu.native import entropy_native as native  # noqa: E402
from amv_tpu.pipeline import transcode as jax_transcode  # noqa: E402
from amv_tpu.verify import fixtures  # noqa: E402
from amv_tpu_torch.codecs.amv_video import encoder_qmat  # noqa: E402
from amv_tpu_torch.kernels import transcode as T  # noqa: E402
from amv_tpu_torch.pipeline import transcode as P  # noqa: E402

QSCALE = 1   # the widest products: qmat reaches 2^18, coef * qmat wraps


@pytest.fixture(scope="module")
def case():
    """3 frames x 4 MCUs: a real decoded 32x32 frame, then random sparse
    levels with +-1023 and wide DC differences; with the JAX outputs."""
    rng = np.random.default_rng(0)
    y, cb, cr = fixtures.videogen(1, 32, 32)
    real = huffman_decode_frames(
        [native.ref_encode_frame(y[0], cb[0], cr[0], 2)], 4)
    rnd = np.where(rng.random((2, 4, 6, 64)) < 0.2,
                   rng.integers(-1023, 1024, (2, 4, 6, 64)), 0)
    rnd[:, :, :, 0] = rng.integers(-2047, 2048, (2, 4, 6))
    rnd[1, 2, 3, 1:] = 1023
    rnd[1, 3, 4, 1:] = -1023
    levels = np.concatenate([real, rnd]).astype(np.int16)
    lv2, pix = jax_transcode.transcode_levels_fused(jnp.asarray(levels),
                                                    QSCALE)
    return levels, np.asarray(lv2), np.asarray(pix)


def test_fused_matches_jax(case):
    levels, want_lv2, want_pix = case
    lv2, pix = P.transcode_levels_fused(torch.from_numpy(levels), QSCALE)
    assert lv2.dtype == torch.int16 and pix.dtype == torch.uint8
    np.testing.assert_array_equal(lv2.numpy(), want_lv2)
    np.testing.assert_array_equal(pix.numpy(), want_pix)


def test_layout_entry_matches_jax(case):
    levels, want_lv2, _ = case
    lt = torch.from_numpy(levels)
    dc = P.resolve_dc(lt).reshape(-1)
    qkey = tuple(int(v) for v in _encoder_quant_qmat_np(QSCALE))
    lv2 = T.transcode_blocks(lt.reshape(-1, 64), dc, encoder_qmat(qkey))
    np.testing.assert_array_equal(lv2.numpy().reshape(want_lv2.shape),
                                  want_lv2)


def test_pixel_entry_keeps_decoded_pad(case):
    """size=None keeps every decoded pixel; with a picture size the pixels
    are the same and only the re-encode of the pad blocks may differ."""
    levels, want_lv2, want_pix = case
    lt = torch.from_numpy(levels)
    dc = P.resolve_dc(lt).reshape(-1)
    q = encoder_qmat(QSCALE)
    lv_a, pix_a = T.transcode_blocks_pix(lt.reshape(-1, 64), dc, q)
    lv_b, pix_b = T.transcode_blocks_pix(lt.reshape(-1, 64), dc, q,
                                         size=(32, 24))
    assert torch.equal(pix_a, pix_b)
    np.testing.assert_array_equal(pix_a.numpy().reshape(want_pix.shape),
                                  want_pix)
    # 32x24: MCUs 2, 3 hold the pad rows; MCUs 0, 1 are untouched
    a, b = lv_a.reshape(3, 4, 6, 64), lv_b.reshape(3, 4, 6, 64)
    assert torch.equal(a[:, :2], b[:, :2])
    assert not torch.equal(a[:, 2:], b[:, 2:])


@pytest.mark.parametrize("qscale", range(1, 32))
def test_encoder_qmat_matches_jax(qscale):
    want = _encoder_quant_qmat_np(qscale)
    got = encoder_qmat(qscale)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(encoder_qmat(tuple(int(v) for v in want)),
                                  want)


def test_rejects_bad_inputs():
    lv = torch.zeros((12, 64), dtype=torch.int16)
    dc = torch.zeros(12, dtype=torch.int32)
    q = encoder_qmat(2)
    with pytest.raises(ValueError):
        T.transcode_blocks(lv[:7], dc[:7], q)
    with pytest.raises(ValueError):
        T.transcode_blocks(lv, dc.long(), q)
    with pytest.raises(ValueError):
        T.transcode_blocks(lv, dc, q, size=(48, 48))
    with pytest.raises(NotImplementedError):
        T.transcode_blocks(lv, dc, q, size=(15, 16))
    with pytest.raises(ValueError):
        encoder_qmat(0)
