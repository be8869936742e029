"""The import guard: top-level names compared whole."""

import json
import os
import subprocess
import sys

import pytest

from portbench import run as R
from portbench.guard import forbidden_modules

from test_portbench_faults import TINY

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib.xla_client",
                                  "flax.linen", "amv_tpu",
                                  "amv_tpu.codecs.g729a"])
def test_guard_fails_on_jax_and_the_jax_package(name):
    assert forbidden_modules([name, "numpy"]) == [name]


@pytest.mark.parametrize("name", ["amv_tpu_torch", "amv_tpu_torch.cli",
                                  "jaxtyping", "flaxen", "amv_tpux",
                                  "portbench.run"])
def test_guard_passes_other_names(name):
    assert forbidden_modules([name]) == []


def test_nothing_the_benchmark_loads_is_forbidden():
    """Import every module a run loads, in a fresh process, and look."""
    code = (
        "import sys, glob, os, importlib\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import portbench.run, portbench.control, portbench.trace\n"
        "for f in glob.glob(os.path.join('portbench', 'drivers', '*.py')):\n"
        "    importlib.import_module('portbench.drivers.' +\n"
        "                            os.path.basename(f)[:-3])\n"
        "for n in ('amv', 'g729'):\n"
        "    importlib.import_module('portbench.reference.' + n)\n"
        "for m in json.load(open('BENCHMARK.json'))['per_layer']:\n"
        "    portbench.run.reader(m['name'])\n"
        "import amv_tpu_torch.cli, amv_tpu_torch.pipeline.transcode\n"
        "import amv_tpu_torch.codecs.g729a, amv_tpu_torch.containers.act\n"
        "from portbench.guard import forbidden_modules\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", "import json\n" + code],
                         cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _tiny(cell):
    spec = R.cell_spec(cell)
    spec["traffic"]["params"].update(TINY[cell])
    return spec


def test_a_run_that_loaded_jax_fails_without_a_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", sys.modules["json"])
    with pytest.raises(SystemExit) as e:
        R.run(_tiny("act.library_decode"), 5, 0.1, False, device="cpu")
    assert e.value.code == 3


def test_a_clean_run_passes_the_guard():
    out = R.run(_tiny("act.library_decode"), 5, 0.1, False, device="cpu")
    assert out["correct"] and "device" not in out


def test_no_card_means_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "act.one_file",
         "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert not out.stdout.strip()
    with pytest.raises(json.JSONDecodeError):
        json.loads(out.stdout or "x")
