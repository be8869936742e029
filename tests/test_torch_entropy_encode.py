"""Kernel E's plain version (the port's CPU path) against the host C
encoder: its words and bits, framed by `native.escape_frames`, must be the
bytes `huffman_encode_frame` gives for every frame.
Tolerance: exact equality (integer codec, bit-exact contract).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from amv_tpu.bitstream.entropy import huffman_encode_frame  # noqa: E402
from amv_tpu.native import entropy_native as native  # noqa: E402
from amv_tpu_torch.kernels.entropy_encode import encode_levels  # noqa: E402


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
