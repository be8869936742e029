"""On the card: every cell runs short and comes out correct.  Skips
without a CUDA card (decided inside the test).  Run on the GPU machine:

    python -m pytest -m cuda portbench/tests/test_portbench_card.py
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 77), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
