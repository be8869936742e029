"""Time kernel T (the block transcode) of the amv_tpu_torch package that
comes first on sys.path, through its layout entry (`transcode_blocks`)
and its pixel entry (`transcode_blocks_pix`), at the transcode's shape on
the corpus of `chip_smoke.py` (4,800 frames of 160x120, 2,304,000
blocks), on one GPU.

    PYTHONPATH=<tree> python3 amv_tpu_torch/tools/time_transcode_kernel.py

The levels are seeded sparse random ones (8% nonzero AC, DC differences
of corpus size) rather than decoded frames, so any tree of the port can
run it with nothing but its kernel.  Prints one JSON line: the tree, the
card's name and power limit, and per entry the median and every time in
ms (CUDA events, after a warm-up).  To compare two trees, run it from each in
turns (parent, change, change, parent) inside one command.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess

import numpy as np
import torch


def main(reps: int = 50) -> None:
    import amv_tpu_torch
    from amv_tpu_torch.codecs.amv_video import encoder_qmat
    from amv_tpu_torch.kernels import transcode as T

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    rng = np.random.default_rng(0)
    n = 4800 * 80 * 6
    lv = np.where(rng.random((n, 64)) < 0.08,
                  rng.integers(-60, 61, (n, 64)), 0).astype(np.int16)
    dc = rng.integers(0, 2048, n).astype(np.int32)
    lv_t = torch.from_numpy(lv).cuda()
    dc_t = torch.from_numpy(dc).cuda()
    q = encoder_qmat(2)
    out = {}
    for key, entry in (("ms", T.transcode_blocks),
                       ("ms_pix", T.transcode_blocks_pix)):
        entry(lv_t, dc_t, q, (160, 120))
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            entry(lv_t, dc_t, q, (160, 120))
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        out[key], out[key + "_all"] = statistics.median(times), times
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"tree": os.path.dirname(os.path.dirname(
        os.path.abspath(amv_tpu_torch.__file__))), "card": card,
        "blocks": n, **out}))


if __name__ == "__main__":
    main()
