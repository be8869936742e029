"""The parallel and rechunk encoders against the JAX package.

The port's `encode_layout_parallel` and `encode_layout_rechunk` (kernel
P's plain version on the CPU) are held against `amv_tpu.kernels.
entropy_encode_parallel`'s, on levels that fit JAX's default windows and
on levels that overflow a window, where JAX drops the words outside it:
the port must drop the same and agree on ok (per frame here, one flag for
the batch there).  Tolerance: exact equality (integer codec, bit-exact
contract).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from amv_tpu.kernels import entropy_encode_parallel as JP  # noqa: E402
from amv_tpu_torch.kernels import entropy_encode as E  # noqa: E402
from amv_tpu_torch.kernels import entropy_parallel as EP  # noqa: E402

NB = 24


def _levels(dense):
    """[5, 24, 64] seeded levels; frame 3 empty, frame 4 sparse; past 10%
    density a block of 63 +-1023 (1,638 bits, over 16 words)."""
    rng = np.random.default_rng(3)
    lv = np.where(rng.random((5, NB, 64)) < dense,
                  rng.integers(-300, 300, (5, NB, 64)), 0)
    lv[:, :, 0] = rng.integers(0, 2048, (5, NB))
    if dense > 0.1:
        lv[1, 3, 1:] = 1023
    lv[2, 5, 63] = -7
    lv[2, 6, 40] = 2
    lv[3] = 0
    lv[4, :, 1:] = np.where(rng.random((NB, 63)) < 0.03, 1, 0)
    return lv.astype(np.int16)


def _slab(lv):
    p = np.zeros((1024, NB, 64), np.int16)
    p[:len(lv)] = lv
    return jnp.asarray(p.reshape(8, 128, NB, 64).transpose(2, 3, 0, 1)[None])


def _frames(x, f):
    x = np.asarray(x)
    return x[0].reshape(x.shape[1], 1024).T[:f]


def _same(got, want, bits_want):
    words, bits, ok = got
    np.testing.assert_array_equal(words.numpy(), _frames(want[0], 5))
    np.testing.assert_array_equal(bits.numpy(), bits_want)
    assert bool(ok.all()) == bool(want[2])
    return ok


# windows JAX's defaults hold (sparse), a block window (wl 2), a group
# window, a supergroup window, and the w_out budget
PARALLEL = [(0.03, 256, {}), (0.03, 256, {"wl": 2}),
            (0.25, 256, {"wl": 16, "wg": 24}),
            (0.25, 512, {"grp": 3, "wg": 40, "grp2": 2, "ws": 70}),
            (0.25, 64, {})]


@pytest.mark.parametrize("dense,w_out,kw", PARALLEL)
def test_parallel_matches_jax(dense, w_out, kw):
    lv = _levels(dense)
    want = JP.encode_layout_parallel(_slab(lv), w_out, **kw)
    got = EP.encode_layout_parallel(torch.from_numpy(lv), w_out, **kw)
    ok = _same(got, want, np.asarray(want[1])[0].reshape(1024)[:5])
    assert ok[3]                               # the empty frame always fits
    if not kw and w_out == 256:
        assert ok.all()
        ew, eb, _ = E.encode_levels(torch.from_numpy(lv), w_out)
        assert torch.equal(got[0], ew) and torch.equal(got[1], eb)
    else:
        assert not ok.all()


@pytest.mark.parametrize("dense,wl", [(0.03, 16), (0.25, 4)])
def test_rechunk_matches_jax(dense, wl):
    """JAX's default wl 16 holds the sparse frames; wl 4 (R = 5 records a
    block) drops the dense blocks' words past 128 bits."""
    lv = _levels(dense)
    want = JP.encode_layout_rechunk(_slab(lv), 512, wl=wl, interpret=True)
    got = EP.encode_layout_rechunk(torch.from_numpy(lv), 512, wl)
    ok = _same(got, want, _frames(want[1], 5)[:, 0])
    assert ok.all() == (wl == 16)


def test_budgets_that_fit_any_input():
    """wl=None and FITTING_WINDOWS hold the densest blocks of the codec's
    range (63 AC tokens of 26 bits, DC differences of 11 bits): both
    equal kernel E."""
    lv = _levels(0.25)
    lv[0, 7, 1:] = -1023
    lv[0, 7, 0], lv[0, 8, 0] = 0, 2047
    lv[0, 8, 1:] = 1023
    lt = torch.from_numpy(lv)
    ew, eb, _ = E.encode_levels(lt, 4096)
    for words, bits, ok in (
            EP.encode_layout_rechunk(lt, 4096, None),
            EP.encode_layout_parallel(lt, 4096, **EP.FITTING_WINDOWS)):
        assert ok.all()
        assert torch.equal(words, ew) and torch.equal(bits, eb)
