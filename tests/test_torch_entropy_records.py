"""Kernels R and X (the record-IR decode) against the JAX package.

The port's plain versions (its CPU path) of `decode_records`,
`expand_records` and `decode_scans_async` are held against
`amv_tpu.kernels.entropy_async_pallas._decode_records` and
`decode_scans_async`, run in interpret mode, and against kernel D; on
C-encoded frames, malformed scans (JAX's semantics there, not the C
decoder's) and record budgets that overflow.  Tolerance: exact equality
(integer codec, bit-exact contract).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from amv_tpu.kernels import entropy_async_pallas as JA  # noqa: E402
from amv_tpu.kernels.entropy_decode_pallas import scan_words_layout  # noqa: E402,E501
from amv_tpu.native import entropy_native as native  # noqa: E402
from amv_tpu.verify import fixtures  # noqa: E402
from amv_tpu_torch.kernels import entropy_decode as D  # noqa: E402
from amv_tpu_torch.kernels import entropy_records as R  # noqa: E402

N_MCU = 6                 # 48x32 frames
NB = 6 * N_MCU


def _rows(n=5, seed=0):
    """Unescaped rows of n C-encoded 48x32 frames at qscale 1..4 (record
    counts 196..865 at seed 0)."""
    rng = np.random.default_rng(seed)
    y, cb, cr = fixtures.videogen(n, 32, 48, seed=seed)
    y = np.clip(y.astype(np.int16) + rng.integers(-8, 9, y.shape), 0,
                255).astype(np.uint8)
    pays = [native.ref_encode_frame(y[i], cb[i], cr[i], 1 + i % 4)
            for i in range(n)]
    return native.unescape_frames(pays)


def _jax_records(rows, t_max):
    """JAX's records [F, T] and status [F, 2], frame-major."""
    recs, status = JA._decode_records(scan_words_layout(jnp.asarray(rows)),
                                      NB, t_max, interpret=True)
    f, t = rows.shape[0], recs.shape[1]
    recs = np.asarray(recs).transpose(0, 2, 3, 1).reshape(-1, t)[:f]
    status = np.asarray(status).transpose(0, 2, 3, 1).reshape(-1, 2)[:f]
    return recs, status


def test_records_match_jax_on_valid_and_malformed_scans():
    """Records and status equal JAX's where the C decoder would fail too:
    random bytes, a run of 0xFF (no K.3 code: JAX reads length 16 and the
    table's last symbol) and a truncated scan; valid frames finish."""
    rows, lens = _rows()
    rng = np.random.default_rng(1)
    rows = np.concatenate([rows, rows[:3]])
    lens = np.concatenate([lens, lens[:3]])
    rows[5, :lens[5]] = rng.integers(0, 256, lens[5])
    rows[6, 30:40] = 0xFF
    rows[7, lens[7] // 3:] = 0
    lens[7] //= 3
    t_max = R.default_t_max(NB, rows.shape[1])
    want_r, want_s = _jax_records(rows, t_max)
    got_r, got_s = R.decode_records(torch.from_numpy(rows),
                                    torch.from_numpy(lens), NB, t_max)
    assert got_r.shape == want_r.shape == (8, R.record_rows(t_max))
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    for f, n in enumerate(want_s[:, 1]):
        np.testing.assert_array_equal(got_r[f, :n].numpy(), want_r[f, :n])
        assert not got_r[f, n:].any()
    assert (want_s[:5, 0] == NB).all()


def test_decode_scans_async_matches_jax_and_d():
    rows, lens = _rows(seed=2)
    rt, lt = torch.from_numpy(rows), torch.from_numpy(lens)
    levels, ok = R.decode_scans_async(rt, lt, NB)
    want, want_ok = JA.decode_scans_async(
        jnp.asarray(rows), N_MCU, R.default_t_max(NB, rows.shape[1]),
        interpret=True)
    assert bool(want_ok) and ok.tolist() == [1] * 5
    np.testing.assert_array_equal(levels.numpy(),
                                  np.asarray(want).reshape(5, NB, 64))
    d_levels, d_ok = D.decode_scans(rt, lt, NB)
    assert torch.equal(levels, d_levels) and d_ok.all()


def test_record_budget_overflow_matches_jax():
    """t_max 300 is a budget of 512 records (JAX runs whole 256-row grid
    steps): the frames of 196, 278 and 431 records finish, those of 852
    and 865 do not; ok, status and the finished frames' levels equal
    JAX's.  The levels of a frame that is not ok are garbage by JAX's
    contract (its bit-descent searchsorted cannot return T, so there a
    frame's last record lands in its last block); the port's hold the
    records its blocks reached."""
    rows, lens = _rows()
    rt, lt = torch.from_numpy(rows), torch.from_numpy(lens)
    levels, ok = R.decode_scans_async(rt, lt, NB, t_max=300)
    want, want_ok = JA.decode_scans_async(jnp.asarray(rows), N_MCU, 300,
                                          interpret=True)
    want_r, want_s = _jax_records(rows, 300)
    assert not bool(want_ok) and not bool(ok.all())
    assert ok.tolist() == (want_s[:, 0] == NB).astype(int).tolist() == \
        [0, 1, 1, 1, 0]
    assert sorted(want_s[:, 1]) == [196, 278, 431, 512, 512]
    np.testing.assert_array_equal(levels.numpy()[1:4],
                                  np.asarray(want).reshape(5, NB, 64)[1:4])
    full, _ = R.decode_scans_async(rt, lt, NB)
    done = int(want_s[0, 0])                 # frame 0: blocks 0..done-1
    assert torch.equal(levels[0, :done], full[0, :done])
    assert not levels[0, done + 1:].any()


def test_expand_plain_scatters_written_levels():
    """X writes a record's level at (cumsum of is_dc - 1, wpos) when its
    write bit is set, and nothing else; records past the count are not
    read."""
    rec = lambda level, dc, w, pos: (level << 16) | (dc << 7) | (w << 6) | pos  # noqa: E731,E501
    recs = torch.tensor([[rec(-5, 1, 1, 0), rec(7, 0, 1, 3), rec(0, 0, 0, 9),
                          rec(2, 1, 1, 0), rec(-1, 0, 1, 63), rec(4, 0, 1, 5)]],
                        dtype=torch.int32)
    lv = R.expand_records(recs, torch.tensor([5], dtype=torch.int32), 6)
    want = torch.zeros((1, 6, 64), dtype=torch.int16)
    want[0, 0, 0], want[0, 0, 3], want[0, 1, 0], want[0, 1, 63] = -5, 7, 2, -1
    assert torch.equal(lv, want)          # the record past the count unread


def test_rejects_bad_inputs():
    rows = torch.zeros((2, 8), dtype=torch.uint8)
    lens = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError):
        R.decode_records(rows, lens.int(), 6, 64)
    with pytest.raises(ValueError):
        R.decode_records(rows, lens, 7, 64)
    with pytest.raises(ValueError):
        R.decode_records(rows, lens, 6, 0)
    counts = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        R.expand_records(torch.zeros((2, 8), dtype=torch.int64), counts, 6)
    with pytest.raises(ValueError):
        R.expand_records(torch.zeros((2, 8), dtype=torch.int32),
                         counts.long(), 6)
