"""Time the transcode end to end, `cli.main(["-i", in.amv, "-f", "amv",
out.amv])`, of the amv_tpu_torch package that comes first on sys.path, on
`chip_smoke.py`'s 4,800-frame 160x120 corpus, on one GPU.

    PYTHONPATH=<tree> python3 amv_tpu_torch/tools/time_transcode.py CORPUS

CORPUS is an .amv path; if it does not exist, it is written first with
`chip_smoke.py`'s corpus (this checkout's port builds it).  Prints one
JSON line: the tree, the card's name and power limit, and the median and
every wall time in seconds of 5 passes after a warm-up.  To compare two
trees, run it from each in turns inside one command (the host clock
spreads by +-15% between calls).
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def write_corpus(path: str) -> None:
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    m = smoke.import_port()
    pays = smoke.c_encode(m, smoke.pictures(m, smoke.N_FRAMES, smoke.H,
                                            smoke.W, seed=0))
    second = m.ref_adpcm.encode(m.fixtures.audiogen(1.0, smoke.RATE, seed=0),
                                round(smoke.RATE / smoke.FPS), smoke.RATE)
    with open(path, "wb") as f:
        f.write(m.riff.mux(pays, second * (smoke.N_FRAMES // smoke.FPS),
                           width=smoke.W, height=smoke.H, fps=smoke.FPS,
                           sample_rate=smoke.RATE))


def main(corpus: str, runs: int = 5) -> None:
    if not os.path.exists(corpus):
        write_corpus(corpus)
    import amv_tpu_torch
    from amv_tpu_torch import cli
    walls = []
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["-i", corpus, "-f", "amv", os.path.join(tmp, "out.amv"),
                "--device", "cuda"]
        for k in range(runs + 1):
            t0 = time.perf_counter()
            assert cli.main(argv) == 0
            if k:
                walls.append(time.perf_counter() - t0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"tree": os.path.dirname(os.path.dirname(
        os.path.abspath(amv_tpu_torch.__file__))), "card": card,
        "s": statistics.median(walls), "s_all": walls}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
