"""The record encoder (tokenizer + kernel P) against the JAX package.

The port's `tokenize_levels` is held against `amv_tpu.kernels.
entropy_encode_async_pallas.tokenize_levels_layout` (records, totals,
block offsets, ok), and `encode_scans_async` (kernel P's plain version on
the CPU) against JAX's `encode_scans_async` in interpret mode and against
kernel E.  Inputs: re-encode levels of C-encoded frames and seeded sparse
levels, with out-of-range values where JAX's int32 arithmetic wraps.
Tolerance: exact equality (integer codec, bit-exact contract).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from amv_tpu.kernels import entropy_encode_async_pallas as JA  # noqa: E402
from amv_tpu.native import entropy_native as native  # noqa: E402
from amv_tpu.verify import fixtures  # noqa: E402
from amv_tpu_torch.kernels import entropy_encode as E  # noqa: E402
from amv_tpu_torch.kernels import entropy_records as R  # noqa: E402
from amv_tpu_torch.kernels import record_pack as RP  # noqa: E402
from amv_tpu_torch.pipeline import transcode as P  # noqa: E402

N_MCU = 4
NB = 6 * N_MCU


@pytest.fixture(scope="module")
def levels():
    """[6, 24, 64]: the re-encode levels of 3 C-encoded 32x32 frames, then
    sparse seeded levels (a dense +-1023 block, a last-slot coefficient
    with no EOB, a ZRL run, an empty frame)."""
    rng = np.random.default_rng(0)
    y, cb, cr = fixtures.videogen(3, 32, 32, seed=1)
    pays = [native.ref_encode_frame(y[i], cb[i], cr[i], 2) for i in range(3)]
    rows, lens = native.unescape_frames(pays)
    lv, _ = P.decode_scans(torch.from_numpy(rows), torch.from_numpy(lens),
                           NB)
    dc = P.resolve_dc(lv.reshape(3, N_MCU, 6, 64)).reshape(-1)
    real = P.transcode_blocks(lv.reshape(-1, 64), dc, P.encoder_qmat(2))
    rnd = np.where(rng.random((3, NB, 64)) < 0.1,
                   rng.integers(-1023, 1024, (3, NB, 64)), 0)
    rnd[:, :, 0] = rng.integers(0, 2048, (3, NB))
    rnd[0, 3, 1:] = 1023
    rnd[1, 5, 63] = -7
    rnd[1, 6, 1:] = 0
    rnd[1, 6, 40] = 2
    rnd[2] = 0
    return np.concatenate([real.numpy().reshape(3, NB, 64),
                           rnd]).astype(np.int16)


def _slab(lv):
    """[F, NB, 64] -> JAX's [1, NB, 64, 8, 128] (frames padded with 0s)."""
    p = np.zeros((1024, NB, 64), np.int16)
    p[:len(lv)] = lv
    return jnp.asarray(p.reshape(8, 128, NB, 64).transpose(2, 3, 0, 1)[None])


def _frames(x, f):
    """JAX [1, T, 8, 128] -> [f, T]."""
    x = np.asarray(x)
    return x[0].reshape(x.shape[1], 1024).T[:f]


@pytest.mark.parametrize("case", ["levels", "wrapping"])
def test_tokenizer_matches_jax(levels, case):
    """Records, totals, block offsets and ok; "wrapping" takes values past
    the codec's range (AC +-32767, DC differences beyond int16) whose
    codes JAX's int32 arithmetic wraps; t_max 120 is overflowed."""
    lv = levels.copy()
    t_max = R.default_t_max_enc(NB)
    if case == "wrapping":
        lv[3, 2, 5] = -32768
        lv[3, 7, 9] = 32767
        lv[4, 0, 0], lv[4, 6, 0] = -32768, 32767
        t_max = 120
    want = JA.tokenize_levels_layout(_slab(lv), N_MCU, t_max)
    recs, totals, block_off, ok = R.tokenize_levels(torch.from_numpy(lv),
                                                    t_max)
    w_tot = _frames(want[1], 6)[:, 0]
    np.testing.assert_array_equal(totals.numpy(), w_tot)
    np.testing.assert_array_equal(
        block_off.numpy(), np.asarray(want[2])[0].reshape(NB + 1, 1024).T[:6])
    assert bool(ok.all()) == bool(want[3])
    w_recs = _frames(want[0], 6)
    for f in range(6):
        n = min(w_tot[f], t_max)
        np.testing.assert_array_equal(recs[f, :n].numpy(), w_recs[f, :n])
        assert not recs[f, n:].any()
    if case == "wrapping":
        assert ok.tolist() == (w_tot <= 120).tolist() and not ok.all()
        assert ok.any()


def test_encode_scans_async_matches_jax_and_e(levels):
    """Words (w_out rounded up to 128) and bits equal JAX's and kernel E's;
    a budget of 128 words that the dense frames overflow drops their words
    past it but counts their bits, as JAX does (ok is the record budget)."""
    lz = levels.reshape(6, N_MCU, 6, 64)
    for w_out in (1000, 128):
        want_w, want_b, want_ok = JA.encode_scans_async(
            jnp.asarray(lz), w_out, interpret=True)
        words, bits, ok = R.encode_scans_async(torch.from_numpy(lz), w_out)
        assert words.shape == (6, max(128, (w_out + 127) // 128 * 128))
        np.testing.assert_array_equal(words.numpy(), np.asarray(want_w))
        np.testing.assert_array_equal(bits.numpy(), np.asarray(want_b))
        assert bool(want_ok) and ok.all()
        ew, eb, _ = E.encode_levels(torch.from_numpy(levels),
                                    words.shape[1])
        assert torch.equal(words, ew) and torch.equal(bits, eb)
    assert (bits > 32 * 128).any()


def test_pack_plain_appends_records():
    """code << 5 | len records appended MSB-first, zero-filled tail, bits
    the sum of the lengths, records past the lane's total ignored."""
    recs = torch.tensor([[(0b101 << 5) | 3, (0x3FFFFFF << 5) | 26,
                          (1 << 5) | 1, (7 << 5) | 3]], dtype=torch.int32)
    words, bits = RP.pack_records(recs, torch.tensor([3], dtype=torch.int32),
                                  2)
    stream = "101" + "1" * 26 + "1"
    want = int(stream.ljust(64, "0"), 2)
    got = (int(words[0, 0]) & 0xFFFFFFFF) << 32 | \
        (int(words[0, 1]) & 0xFFFFFFFF)
    assert bits.tolist() == [30] and got == want
    with pytest.raises(ValueError):
        RP.pack_records(recs, torch.tensor([3]), 2)
