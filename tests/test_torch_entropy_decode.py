"""Kernel D's plain version (the port's CPU path) against the JAX package
and the host C decoder.

Inputs are `native.unescape_frames` rows of C-encoded frames, plus
malformed rows; `ok` must be 0 exactly where the C decoder fails.
Tolerance: exact equality (integer codec, bit-exact contract).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from amv_tpu.bitstream.entropy import huffman_decode_frames  # noqa: E402
from amv_tpu.kernels.entropy_decode import decode_scans_device  # noqa: E402
from amv_tpu.native import entropy_native as native  # noqa: E402
from amv_tpu.verify import fixtures  # noqa: E402
from amv_tpu_torch.kernels.entropy_decode import decode_scans  # noqa: E402


def _payloads(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    y, cb, cr = fixtures.videogen(n, h, w, seed=seed)
    y = np.clip(y.astype(np.int16) + rng.integers(-8, 9, y.shape), 0,
                255).astype(np.uint8)
    return [native.ref_encode_frame(y[i], cb[i], cr[i], 1 + i % 4)
            for i in range(n)]


def _framed(row, ln):
    """An unescaped scan re-framed as a payload whose C unescape gives the
    same bytes back (every 0xFF escaped as 0xFF 0x00)."""
    return b"\xff\xd8" + bytes(row[:ln]).replace(b"\xff", b"\xff\x00") + \
        b"\xff\xd9"


def _c_ok(row, ln, n_mcu):
    """Whether the C decoder accepts an unescaped scan."""
    try:
        native.decode_frames([_framed(row, ln)], n_mcu)
    except ValueError:
        return False
    return True


def _bits_to_row(bits: str, width: int) -> np.ndarray:
    bits = bits + "0" * (-len(bits) % 8)
    row = np.zeros(width, np.uint8)
    data = [int(bits[i:i + 8], 2) for i in range(0, len(bits), 8)]
    row[:len(data)] = data
    return row


def test_matches_jax_and_host():
    pays = _payloads(6, 32, 48)
    n_mcu = 6
    rows, lens = native.unescape_frames(pays)
    levels, ok = decode_scans(torch.from_numpy(rows), torch.from_numpy(lens),
                              n_mcu * 6)
    assert ok.tolist() == [1] * 6
    host = huffman_decode_frames(pays, n_mcu)
    np.testing.assert_array_equal(levels.numpy().reshape(host.shape), host)
    dev = np.asarray(decode_scans_device(jnp.asarray(rows), n_mcu))
    np.testing.assert_array_equal(levels.numpy().reshape(dev.shape), dev)


DAMAGES = ["truncated", "random", "bad_code", "past_63", "empty"]


@pytest.mark.parametrize("damage", DAMAGES)
def test_malformed_ok_matches_c(damage):
    rng = np.random.default_rng(DAMAGES.index(damage))
    pays = _payloads(8, 32, 32, seed=3)
    n_mcu = 4
    rows, lens = native.unescape_frames(pays)
    rows, lens = rows.copy(), lens.copy()
    for f in range(0, 8, 2):
        if damage == "truncated":
            lens[f] = rng.integers(0, lens[f])
        elif damage == "random":
            rows[f, :lens[f]] = rng.integers(0, 256, lens[f])
        elif damage == "bad_code":
            at = rng.integers(0, lens[f] - 8)
            rows[f, at:at + 6] = 0xFF          # 16 ones: no K.3 code
        elif damage == "past_63":
            # DC '00', four ZRLs (slot 64), then run 0 / size 1: slot 65
            rows[f] = _bits_to_row("00" + "11111111001" * 4 + "001",
                                   rows.shape[1])
        else:
            lens[f] = 0
    levels, ok = decode_scans(torch.from_numpy(rows), torch.from_numpy(lens),
                              n_mcu * 6)
    want = [_c_ok(rows[f], lens[f], n_mcu) for f in range(8)]
    assert ok.bool().tolist() == want
    if damage in ("bad_code", "past_63"):
        assert not any(want[0::2])
    # frames the C decoder accepts decode to its levels
    good = [f for f in range(8) if want[f]]
    host = native.decode_frames([_framed(rows[f], lens[f]) for f in good],
                                n_mcu)
    np.testing.assert_array_equal(
        levels.numpy()[good].reshape(host.shape), host)


def test_rejects_bad_inputs():
    rows = torch.zeros((2, 8), dtype=torch.uint8)
    lens = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError):
        decode_scans(rows, lens.int(), 6)
    with pytest.raises(ValueError):
        decode_scans(rows, lens, 7)
    with pytest.raises(ValueError):
        decode_scans(rows.short(), lens, 6)
