"""Kernel T's dequantized entry against `transcode_soa3`.

`amv_tpu_torch.kernels.transcode.transcode_deq` (its plain version on the
CPU) is held against `amv_tpu.kernels.transcode_pallas.transcode_soa3` in
interpret mode (tile 64: 512 blocks), the 3-D twin of `transcode_soa`;
the inputs and the check are test_torch_transcode_soa.py's.  One interpret
compile.  Tolerance: exact equality (integer codec, bit-exact contract).
"""

import pytest

pytest.importorskip("torch")

from amv_tpu.kernels import transcode_pallas as JT  # noqa: E402
from test_torch_transcode_soa import check_deq_entry  # noqa: E402


def test_deq_entry_matches_transcode_soa3():
    check_deq_entry(JT.transcode_soa3, tile=64)
