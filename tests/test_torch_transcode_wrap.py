"""Kernel T's wrap entry (`repeat=`) against the JAX package.

`transcode_blocks_pix(..., repeat=k)` (its plain version on the CPU) is
held against `amv_tpu.kernels.transcode_pallas.transcode_zz_wrap` in
interpret mode: base zigzag levels logically tiled k times along the m
axis of JAX's [64, 8, nm] view, the DC of the full length.  One interpret
compile.  Tolerance: exact equality (integer codec, bit-exact contract).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from amv_tpu.codecs.amv_video import _encoder_quant_qmat_np  # noqa: E402
from amv_tpu.kernels import transcode_pallas as JT  # noqa: E402
from amv_tpu_torch.codecs.jpeg_tables import ZIGZAG  # noqa: E402
from amv_tpu_torch.kernels import transcode as T  # noqa: E402

QK = tuple(int(v) for v in _encoder_quant_qmat_np(2))


def test_wrap_matches_jax():
    """nm_base 96 at JAX's tile 512: pf 16, repeat 16, 12,288 blocks.
    Output block s * nm_full + m reads base block s * nm_base + m %
    nm_base, not n % n_base."""
    rng = np.random.default_rng(7)
    nm_base, repeat = 96, 16
    n_base = 8 * nm_base
    base = np.where(rng.random((n_base, 64)) < 0.2,
                    rng.integers(-64, 64, (n_base, 64)), 0).astype(np.int16)
    dc = rng.integers(-2048, 4096, n_base * repeat).astype(np.int32)
    pix, lv = JT.transcode_zz_wrap(jnp.asarray(base.T), jnp.asarray(dc), QK,
                                   repeat=repeat, interpret=True)
    got_lv, got_pix = T.transcode_blocks_pix(
        torch.from_numpy(base), torch.from_numpy(dc), np.array(QK),
        repeat=repeat)
    np.testing.assert_array_equal(got_pix.numpy(), np.asarray(pix).T)
    np.testing.assert_array_equal(got_lv.numpy(),
                                  np.asarray(lv).T[:, ZIGZAG])
    idx = T.wrap_index(n_base, repeat)
    assert idx[nm_base * repeat] == nm_base        # row s = 1 starts there
    assert not torch.equal(idx, torch.arange(n_base * repeat) % n_base)


def test_wrap_keeps_jax_checks():
    lv = torch.zeros((8 * 64, 64), dtype=torch.int16)    # 6 does not divide
    with pytest.raises(ValueError, match="6 \\| n_base/8"):
        T.transcode_blocks_pix(lv, torch.zeros(8 * 64 * 2, dtype=torch.int32),
                               np.array(QK), repeat=2)
    lv = torch.zeros((8 * 192, 64), dtype=torch.int16)   # pf 8 at tile 512
    with pytest.raises(ValueError, match="alignment pretile pf=8"):
        T.transcode_blocks_pix(lv, torch.zeros(8 * 192 * 4, dtype=torch.int32),
                               np.array(QK), repeat=4)
    with pytest.raises(ValueError, match="full"):
        T.transcode_blocks_pix(lv, torch.zeros(8 * 192, dtype=torch.int32),
                               np.array(QK), repeat=8)
    with pytest.raises(ValueError, match="no picture size"):
        T.transcode_blocks_pix(lv, torch.zeros(8 * 192 * 8, dtype=torch.int32),
                               np.array(QK), size=(16, 16), repeat=8)
