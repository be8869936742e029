"""Kernels I and F's plain versions (the port's CPU path) and the port's
video codec against the JAX package and the C reference.

* I (Q60 dequant + IDCT) against `amv_tpu`'s Pallas `decode_mcu_layout`
  in interpret mode on one slab of 1,024 one-MCU frames, and its raw
  `idct_put` entry against `amv_tpu.kernels.idct.idct_put`;
* F (FDCT + quantize) against Pallas `encode_mcu_layout` in interpret mode
  on one slab, and its raster entry against `amv_tpu.kernels.fdct.
  fdct_quantize`;
* `codecs.amv_video` (extract_blocks, assemble_planes, decode_frames,
  encode_frames) against `amv_tpu.codecs.amv_video` and the C reference
  decoder and encoder, at 160x120 and at 40x24, a width that is not whole
  MCUs.
Inputs are made with numpy from seeds.  Tolerance: exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from amv_tpu.codecs import amv_video as jax_video  # noqa: E402
from amv_tpu.kernels import fdct as jax_fdct  # noqa: E402
from amv_tpu.kernels import idct as jax_idct  # noqa: E402
from amv_tpu.kernels.transcode_layout_pallas import (  # noqa: E402
    decode_mcu_layout, encode_mcu_layout)
from amv_tpu.native import entropy_native as jax_native  # noqa: E402
from amv_tpu.verify import fixtures  # noqa: E402
from amv_tpu_torch import native  # noqa: E402
from amv_tpu_torch.codecs import amv_video  # noqa: E402
from amv_tpu_torch.codecs.jpeg_tables import ZIGZAG  # noqa: E402
from amv_tpu_torch.kernels import fdct as F  # noqa: E402
from amv_tpu_torch.kernels import idct as I  # noqa: E402
from amv_tpu_torch.kernels.entropy_encode import count_bits  # noqa: E402

SLAB = 8 * 128        # frames in one (8, 128) slab of the TPU layout


def _to_slab(a):
    """[F = SLAB, M, 6, ...] frame-major -> the TPU slab layout
    [1, M, 6, ..., 8, 128]."""
    a = np.moveaxis(a, 0, -1)
    return a.reshape(1, *a.shape[:-1], 8, 128)


def _from_slab(a):
    a = a.reshape(*a.shape[1:-2], SLAB)
    return np.moveaxis(a, -1, 0)


def test_idct_plain_matches_decode_mcu_layout():
    rng = np.random.default_rng(0)
    lv = np.where(rng.random((SLAB, 1, 6, 64)) < 0.2,
                  rng.integers(-1023, 1024, (SLAB, 1, 6, 64)), 0)
    lv[:64, :, :, 1:] = 0                                  # DC-only blocks
    lv[64:70, :, :, 1:] = 1023
    lv = lv.astype(np.int16)
    dc = rng.integers(-40000, 40000, (SLAB, 1, 6)).astype(np.int32)
    want = np.asarray(decode_mcu_layout(jnp.asarray(_to_slab(lv)),
                                        jnp.asarray(_to_slab(dc)),
                                        interpret=True))
    got = I.idct_blocks(torch.from_numpy(lv.reshape(-1, 64)),
                        torch.from_numpy(dc.reshape(-1)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy().reshape(SLAB, 1, 6, 64),
                                  _from_slab(want))


def test_idct_put_matches_jax():
    rng = np.random.default_rng(1)
    blocks = rng.integers(-2048, 2048, (3, 50, 8, 8)).astype(np.int16)
    blocks[0, :10, :, 1:] = 0                              # DC-only rows
    blocks[1, :5] = rng.integers(-32768, 32768, (5, 8, 8))  # wrapping sums
    got = I.idct_put(torch.from_numpy(blocks))
    assert got.shape == (3, 50, 8, 8) and got.dtype == torch.uint8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_idct.idct_put(jnp.asarray(blocks))))


@pytest.mark.parametrize("qscale", [1])
def test_fdct_plain_matches_encode_mcu_layout(qscale):
    rng = np.random.default_rng(2)
    pix = rng.integers(0, 256, (SLAB, 1, 6, 64)).astype(np.uint8)
    pix[:8] = np.array([0, 255] * 32, np.uint8)            # checkerboards
    pix[8:12] = 255
    q = amv_video.encoder_qmat(qscale)
    want = np.asarray(encode_mcu_layout(
        jnp.asarray(_to_slab(pix)), tuple(int(v) for v in q),
        interpret=True))
    got = F.fdct_quant_blocks(torch.from_numpy(pix.reshape(-1, 64)), q)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy().reshape(SLAB, 1, 6, 64),
                                  _from_slab(want))


@pytest.mark.parametrize("qscale", [1, 2, 13, 31])
def test_fdct_quantize_matches_jax(qscale):
    rng = np.random.default_rng(qscale)
    blocks = rng.integers(0, 256, (2, 40, 8, 8)).astype(np.uint8)
    blocks[0, :4] = 255
    q = amv_video.encoder_qmat(qscale)
    got = F.fdct_quantize(torch.from_numpy(blocks), q)
    assert got.shape == (2, 40, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax_fdct.fdct_quantize(jnp.asarray(blocks), jnp.asarray(q))))
    zz = F.fdct_quant_blocks(torch.from_numpy(blocks.reshape(-1, 64)), q)
    np.testing.assert_array_equal(zz.numpy(), got.numpy().reshape(-1, 64)[
        :, ZIGZAG])


def _pictures(n, h, w, seed):
    rng = np.random.default_rng(seed)
    y, cb, cr = fixtures.videogen(n, h, w, seed=seed)
    y = np.clip(y.astype(np.int16) + rng.integers(-4, 5, y.shape), 0,
                255).astype(np.uint8)
    return y, cb, cr


@pytest.mark.parametrize("w,h", [(160, 120), (40, 24)])
def test_codec_matches_jax_and_c(w, h):
    y, cb, cr = _pictures(3, h, w, seed=w)
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    blocks = amv_video.extract_blocks(*(torch.from_numpy(p)
                                        for p in (y, cb, cr)), mb_w, mb_h)
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(
        jax_video.extract_blocks(jnp.asarray(y), jnp.asarray(cb),
                                 jnp.asarray(cr), mb_w, mb_h)))
    planes = amv_video.assemble_planes(blocks, mb_w, mb_h, w, h)
    for got, want in zip(planes, jax_video.assemble_planes(
            jnp.asarray(blocks.numpy()), mb_w, mb_h, w, h)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    pays = amv_video.encode_frames(y, cb, cr, 3, device="cpu")
    assert pays == [native.ref_encode_frame(y[i], cb[i], cr[i], 3)
                    for i in range(3)]
    assert pays == jax_video.encode_frames(y, cb, cr, qscale=3)
    got = amv_video.decode_frames(pays, w, h, device="cpu")
    want = jax_video.decode_frames(pays, w, h)
    for i in range(3):
        ref = native.ref_decode_frame(pays[i], w, h)
        for k in range(3):
            np.testing.assert_array_equal(got[k][i], ref[k])
            np.testing.assert_array_equal(got[k][i], want[k][i])


def test_native_copy_matches_jax_native():
    """The port's own host C library computes what `amv_tpu/native` does."""
    y, cb, cr = _pictures(2, 24, 40, seed=4)
    pays = [jax_native.ref_encode_frame(y[i], cb[i], cr[i], 2)
            for i in range(2)]
    assert pays == [native.ref_encode_frame(y[i], cb[i], cr[i], 2)
                    for i in range(2)]
    for a, b in zip(native.ref_decode_frame(pays[0], 40, 24),
                    jax_native.ref_decode_frame(pays[0], 40, 24)):
        np.testing.assert_array_equal(a, b)
    rows, lens = native.unescape_frames(pays)
    rows_j, lens_j = jax_native.unescape_frames(pays)
    np.testing.assert_array_equal(rows, rows_j)
    np.testing.assert_array_equal(lens, lens_j)
    words = np.random.default_rng(5).integers(-2**31, 2**31, (2, 9),
                                              dtype=np.int64).astype(np.int32)
    bits = np.array([250, 288])
    assert native.escape_frames(words, bits) == \
        jax_native.escape_frames(words, bits)
    assert native.ref_adpcm_decode(pays[0][:50], 100, 30).tolist() == \
        jax_native.ref_adpcm_decode(pays[0][:50], 100, 30).tolist()


def test_decode_rejects_malformed_frames():
    y, cb, cr = _pictures(3, 32, 32, seed=6)
    pays = [native.ref_encode_frame(y[i], cb[i], cr[i], 2) for i in range(3)]
    pays[2] = b"\xff\xd8" + b"\xff\x00" * 40 + b"\xff\xd9"
    with pytest.raises(ValueError, match=r"frame\(s\) \[2\]"):
        amv_video.decode_frames(pays, 32, 32, device="cpu")


def test_pack_levels_repacks_on_overflow():
    """No frame overflows: kernel E's count entry gives the exact budget
    before the one pack, and the words are trimmed to the longest frame."""
    y, cb, cr = _pictures(2, 32, 48, seed=7)
    blocks = amv_video.extract_blocks(*(torch.from_numpy(p)
                                        for p in (y, cb, cr)), 3, 2)
    lv = F.fdct_quant_blocks(blocks.reshape(-1, 64),
                             amv_video.encoder_qmat(2)).reshape(2, 36, 64)
    words, bits = amv_video.pack_levels(lv)
    assert words.shape[1] == (int(bits.max()) + 31) // 32
    assert torch.equal(bits, count_bits(lv))
    assert native.escape_frames(words.numpy(), bits.numpy()) == \
        [native.ref_encode_frame(y[i], cb[i], cr[i], 2) for i in range(2)]
