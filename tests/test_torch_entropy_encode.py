"""Kernel E's plain version (the port's CPU path) against the host C
encoder: its words and bits, framed by `native.escape_frames`, must be the
bytes `huffman_encode_frame` gives for every frame.  Its count entry's
plain version against the scan lengths of the JAX device encoder and the C
encoder, and `pack_levels` (count, then one pack at the exact budget)
against a pack at a first budget with a re-pack on overflow, at the
port's picture sizes.
Tolerance: exact equality (integer codec, bit-exact contract).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from amv_tpu.bitstream.entropy import huffman_encode_frame  # noqa: E402
from amv_tpu.kernels.entropy_encode import encode_frames_device  # noqa: E402
from amv_tpu.native import entropy_native as native  # noqa: E402
from amv_tpu_torch.codecs.amv_video import pack_levels  # noqa: E402
from amv_tpu_torch.kernels.encode_fused import encode_planes  # noqa: E402
from amv_tpu_torch.kernels.entropy_encode import (  # noqa: E402
    count_bits, encode_levels)
from amv_tpu_torch.verify import fixtures  # noqa: E402


def _frames(case: str, rng) -> np.ndarray:
    """int16 [5 frames, 4 MCUs, 6, 64] zigzag levels, slot 0 = DC."""
    lv = np.where(rng.random((5, 4, 6, 64)) < 0.2,
                  rng.integers(-60, 61, (5, 4, 6, 64)), 0)
    lv[..., 0] = rng.integers(0, 256, (5, 4, 6))
    if case == "slot63":
        lv[:, :, :, 63] = rng.choice([-3, 1, 7], (5, 4, 6))
    elif case == "long_runs":
        lv[..., 1:] = 0
        lv[:, :, :, 17] = 5          # run 16: one ZRL
        lv[:, :, :, 50] = -2         # run 32: two ZRLs
        lv[:, 1, :, 1:] = 0
        lv[:, 1, :, 63] = 1          # run 62: three ZRLs, no EOB
    elif case == "extremes":
        lv[..., 1:] = np.where(rng.random((5, 4, 6, 63)) < 0.5, 1023, -1023)
    elif case == "dc_swings":
        lv[..., 0] = np.where(rng.random((5, 4, 6)) < 0.5, 1023, -1023)
    elif case == "empty":
        lv[..., 1:] = 0
        lv[..., 0] = 128
    return lv.astype(np.int16)


CASES = ["mixed", "slot63", "long_runs", "extremes", "dc_swings", "empty"]


@pytest.mark.parametrize("case", CASES)
def test_matches_host_encoder(case):
    lv = _frames(case, np.random.default_rng(CASES.index(case)))
    words, bits, ok = encode_levels(
        torch.from_numpy(lv.reshape(5, 24, 64)), 2048)
    assert words.dtype == torch.int32 and bits.dtype == torch.int32
    assert ok.tolist() == [1] * 5
    got = native.escape_frames(words.numpy(), bits.numpy())
    assert got == [huffman_encode_frame(lv[f]) for f in range(5)]


def test_overflow_sets_ok_and_keeps_counting():
    lv = _frames("extremes", np.random.default_rng(9))
    lt = torch.from_numpy(lv.reshape(5, 24, 64))
    full_words, full_bits, _ = encode_levels(lt, 4096)
    w_out = int(full_bits.min()) // 32          # too small for every frame
    words, bits, ok = encode_levels(lt, w_out)
    assert ok.tolist() == [0] * 5
    assert torch.equal(bits, full_bits)
    assert torch.equal(words, full_words[:, :w_out])
    with pytest.raises(ValueError):
        native.escape_frames(words.numpy(), bits.numpy())


def test_rejects_bad_inputs():
    with pytest.raises(ValueError):
        encode_levels(torch.zeros((2, 7, 64), dtype=torch.int16), 64)
    with pytest.raises(ValueError):
        encode_levels(torch.zeros((2, 6, 64), dtype=torch.int32), 64)
    with pytest.raises(ValueError):
        encode_levels(torch.zeros((2, 6, 64), dtype=torch.int16), 0)


def _pictures(n, h, w, seed):
    """n seeded rotozoom pictures with +-3 luma noise; chroma planes of
    h // 2 x w // 2, as the C encoder reads them."""
    rng = np.random.default_rng(seed)
    y, cb, cr = fixtures.rotozoom(n, h, w)
    y = np.clip(y.astype(np.int16) + rng.integers(-3, 4, y.shape), 0,
                255).astype(np.uint8)
    return y, cb[:, :h // 2, :w // 2].copy(), cr[:, :h // 2, :w // 2].copy()


@pytest.mark.parametrize("case", ["pictures"] + CASES)
def test_count_bits_matches_jax_and_c(case):
    """ceil(bits / 8) is the length of the unescaped scan the C encoder
    gives, and the JAX device encoder's below 4,096 bytes (above, JAX's
    encoder truncates: the "extremes" frames)."""
    if case == "pictures":
        y, cb, cr = _pictures(3, 32, 48, seed=8)
        lv = encode_planes(*(torch.from_numpy(p) for p in (y, cb, cr)), 2)
        c_pays = [native.ref_encode_frame(y[i], cb[i], cr[i], 2)
                  for i in range(3)]
        lv = lv.reshape(3, 6, 6, 64)
    else:
        lv = torch.from_numpy(_frames(case, np.random.default_rng(
            CASES.index(case))))
        c_pays = [huffman_encode_frame(lv[f].numpy())
                  for f in range(lv.shape[0])]
    f = lv.shape[0]
    bits = count_bits(lv.reshape(f, -1, 64))
    out, lengths = encode_frames_device(jnp.asarray(lv.numpy()), 4096)
    below = [i for i in range(f) if int(lengths[i]) < 4096]
    assert len(below) == (0 if case == "extremes" else f)
    jax_pays = [bytes(np.asarray(out)[i, :int(lengths[i])]) for i in below]
    for pays, idx in ((jax_pays, below), (c_pays, range(f))):
        if pays:
            _, scan_lens = native.unescape_frames(pays)
            assert ((bits[idx] + 7) // 8).tolist() == scan_lens.tolist()
    assert torch.equal(bits, encode_levels(lv.reshape(f, -1, 64), 1)[1])


@pytest.mark.parametrize("quant", ["ffmpeg", "q60"])
@pytest.mark.parametrize("w,h", [(160, 120), (168, 120), (175, 97),
                                 (320, 240)])
def test_pack_levels_same_words_as_before(w, h, quant):
    """The count-first pack gives the words and bits of a pack at the JAX
    package's first word budget, packed again at the exact budget on an
    overflow, the words trimmed to the longest frame."""
    y, cb, cr = _pictures(2, h, w, seed=w + h)
    lv = encode_planes(*(torch.from_numpy(p) for p in (y, cb, cr)), 2, quant)
    words, bits = pack_levels(lv)
    n_mcu = lv.shape[1] // 6
    w_first = min(1664, 1024 * ((n_mcu + 47) // 48))
    old_w, old_b, _ = encode_levels(lv, w_first)
    w_used = (int(old_b.max()) + 31) // 32
    if w_used > w_first:
        old_w, old_b, _ = encode_levels(lv, w_used)
    assert torch.equal(words, old_w[:, :w_used])
    assert torch.equal(bits, old_b)
    if quant == "ffmpeg":
        assert native.escape_frames(words.numpy(), bits.numpy()) == \
            [native.ref_encode_frame(y[i], cb[i], cr[i], 2) for i in range(2)]
