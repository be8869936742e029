"""Kernel T's dequantized entry against the JAX package.

`amv_tpu_torch.kernels.transcode.transcode_deq` (its plain version on the
CPU) is held against `amv_tpu.kernels.transcode_pallas.transcode_soa`, run
in interpret mode: raster blocks already dequantized (DC included) in,
decoded pixels and raster re-quantized levels out.  One interpret compile
(`transcode_soa3`, bit-identical to it, is held in
test_torch_transcode_soa3.py, so that the two compiles run apart).
Tolerance: exact equality (integer codec, bit-exact contract).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from amv_tpu.codecs.amv_video import _encoder_quant_qmat_np  # noqa: E402
from amv_tpu.kernels import transcode_pallas as JT  # noqa: E402
from amv_tpu_torch.kernels import transcode as T  # noqa: E402

QSCALE = 1   # the widest products: qmat reaches 2^18, coef * qmat wraps


def deq_blocks():
    """512 dequantized blocks [512, 64] raster: Q60-range coefficients, a
    few full-range int16 blocks, DC-only blocks."""
    rng = np.random.default_rng(0)
    d = np.where(rng.random((512, 64)) < 0.3,
                 rng.integers(-600, 600, (512, 64)), 0)
    d[:, 0] = rng.integers(-1024, 3072, 512)
    d[:16] = rng.integers(-32768, 32768, (16, 64))
    d[16:32, 1:] = 0
    return d.astype(np.int16)


def check_deq_entry(jax_entry, **kw):
    """transcode_deq equals a JAX dequantized entry at qscale 1."""
    deq = deq_blocks()
    qk = tuple(int(v) for v in _encoder_quant_qmat_np(QSCALE))
    pix, lv = jax_entry(jnp.asarray(deq.T), qk, interpret=True, **kw)
    got_pix, got_lv = T.transcode_deq(torch.from_numpy(deq), np.array(qk))
    assert got_pix.dtype == torch.uint8 and got_lv.dtype == torch.int16
    np.testing.assert_array_equal(got_pix.numpy(), np.asarray(pix).T)
    np.testing.assert_array_equal(got_lv.numpy(), np.asarray(lv).T)


def test_deq_entry_matches_transcode_soa():
    check_deq_entry(JT.transcode_soa)


def test_deq_entry_rejects_bad_inputs():
    deq = deq_blocks()
    q = np.asarray(_encoder_quant_qmat_np(2), np.int32)
    with pytest.raises(ValueError):
        T.transcode_deq(torch.from_numpy(deq).int(), q)
    with pytest.raises(ValueError):
        T.transcode_deq(torch.from_numpy(deq).reshape(-1, 8, 8), q)
    with pytest.raises(ValueError):
        T.transcode_deq(torch.from_numpy(deq), q[:32])
