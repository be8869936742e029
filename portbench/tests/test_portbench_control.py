"""The control (the reference in the program's place, in the precision
below the configuration's) fails every cell's check, here at a size the
CPU holds; on the card, `portbench/control.py` runs it at the cell's own
size."""

import pytest

from portbench import control as C
from portbench import run as R

from test_portbench_faults import TINY


@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_control_is_not_correct(cell):
    spec = R.cell_spec(cell)
    spec["traffic"]["params"].update(TINY[cell])
    out = C.control(spec, 2**31 + 17, device="cpu")
    assert out["correct"] is False
    assert all(c["value"] > c["limit"] for c in out["checks"].values())
