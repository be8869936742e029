"""Time kernels R (record decode), X (record expand) and P (record pack) of
the amv_tpu_torch package that comes first on sys.path, and the record
routes they sit in, at the main paths' shapes on one GPU: 4,800 frames of
160x120 (seeded videogen and rotozoom pictures with +-3 luma noise,
C-encoded at qscale 2, as `chip_smoke.py` builds its corpus), and report
what the compiler made of them.

    PYTHONPATH=<tree> python3 amv_tpu_torch/tools/time_record_kernels.py

Kernels, as `chip_smoke.py` phase 4 runs them: D (R shares its source)
on the length-sorted scans, R on them in a budget of 64 records a block
(30,720 a frame), X on its records, P on the record encoder's tokens of
the transcode's re-encode
levels (`tokenize_levels`) at the transcode's word budget, and on the
rechunk encoder's 26-bit pieces.  Each: the
median of CUDA events over `reps` launches after a warm-up (they hold the
wrapper's host work when the card has nothing queued) and its device time
per call (torch.profiler: its kernels' time alone, `_device`); X's
device time also by kernel name (`X_kernels_ms`: an earlier tree's
fill of the levels apart from its expand kernel).  D's and
R's sync rounds per frame where the tree reports them.  Routes: the median
host-clock time, after a synchronize, of `decode_scans_async` (R, X) and
of `transcode_complete(enc="record")` and `enc="rechunk"` (D, T, the
tokenizer or the re-chunk, P).  Beside them: `nvcc -Xptxas -v` of
csrc/entropy_decode.cu, record_expand.cu and record_pack.cu (registers,
spills, shared memory) and the static SASS count of each of their kernels
(`cuobjdump -sass`, NOPs left out).  Prints one JSON line: the tree, the
card's name and power limit, and the readings.  To compare two trees, run
it from each in turns (parent, change, change, parent) inside one
command.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

N, W, H, QSCALE = 4800, 160, 120, 2
SOURCES = ("entropy_decode.cu", "record_expand.cu", "record_pack.cu")
KERNELS = ("decode_kernel", "decode_records_kernel", "decode_scans_kernel",
           "expand_records_kernel", "pack_records_kernel")


def main(reps: int = 20) -> None:
    import amv_tpu_torch
    from amv_tpu_torch import native
    from amv_tpu_torch.codecs import amv_video
    from amv_tpu_torch.kernels import _build
    from amv_tpu_torch.kernels import entropy_decode as D
    from amv_tpu_torch.kernels import entropy_parallel as EP
    from amv_tpu_torch.kernels import entropy_records as R
    from amv_tpu_torch.kernels import record_pack as RP
    from amv_tpu_torch.kernels import transcode as T
    from amv_tpu_torch.pipeline import transcode as P
    from amv_tpu_torch.tools import time_transcode_kernel as tk
    from amv_tpu_torch.tools.time_encode_kernels import kernel_split
    from amv_tpu_torch.tools.time_entropy_kernels import (corpus, cuda_ms,
                                                          host_ms)
    from amv_tpu_torch.verify import fixtures

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    ptxas = tk.ptxas_start(_build, SOURCES)
    _build.library()
    _, pays = corpus(native, fixtures)
    n_mcu = ((W + 15) // 16) * ((H + 15) // 16)
    nb = 6 * n_mcu
    t_rec = 64 * nb
    rows, lens = native.unescape_frames(pays)
    order = np.argsort([len(p) for p in pays], kind="stable")
    r = torch.from_numpy(rows[order]).to(dev)
    ln = torch.from_numpy(lens[order]).to(dev)
    qmat = amv_video.encoder_qmat(QSCALE)
    lv, ok = D.decode_scans(r, ln, nb)
    assert bool(ok.all())
    dc = amv_video.resolve_dc(lv.reshape(N, n_mcu, 6, 64)).reshape(-1)
    lv2 = T.transcode_blocks(lv.reshape(-1, 64), dc, qmat,
                             (W, H)).reshape(lv.shape)
    wb = P.word_budget(r)
    recs_p, tot_p, _, _ = R.tokenize_levels(lv2, t_rec)
    recs_c, _ = EP.rechunk_records(lv2, None)
    tot_c = torch.full((N,), recs_c.shape[1], dtype=torch.int32, device=dev)

    recs, status = R.decode_records(r, ln, nb, t_rec)
    cnt = status[:, 1].contiguous()
    assert bool((status[:, 0] == nb).all())
    fns = {"D": lambda: D.decode_scans(r, ln, nb),
           "R": lambda: R.decode_records(r, ln, nb, t_rec),
           "X": lambda: R.expand_records(recs, cnt, nb),
           "P": lambda: RP.pack_records(recs_p, tot_p, wb),
           "P_rechunk": lambda: RP.pack_records(recs_c, tot_c, wb)}
    got = RP.pack_records(recs_p[:64], tot_p[:64], wb)
    want = RP.pack_records_plain(recs_p[:64], tot_p[:64], wb)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    out = {}
    for key, fn in fns.items():
        out[key] = cuda_ms(fn, reps)
        out[f"{key}_device"] = tk.device_ms(fn, reps)
    D.decode_scans(r, ln, nb)
    R.decode_records(r, ln, nb, t_rec)
    for key, mod in (("D", D), ("R", R)):
        rounds = getattr(mod, "LAST_ROUNDS", None)
        if rounds is not None:
            out[f"{key}_rounds_mean"] = float(rounds.float().mean())
            out[f"{key}_rounds_max"] = int(rounds.max())
    out["X_kernels_ms"] = kernel_split(fns["X"], reps)
    out["records"] = int(cnt.sum())
    out["records_packed"] = int(tot_p.sum())
    out["route_decode_scans_async"] = host_ms(
        lambda: R.decode_scans_async(r, ln, nb, t_rec), reps)
    for enc in ("record", "rechunk"):
        out[f"route_transcode_{enc}"] = host_ms(lambda enc=enc: (
            P.transcode_complete(r, ln, n_mcu, QSCALE, (W, H), enc=enc)), 5)
    sass = {fn: cnt_ for fn, (cnt_, _) in tk.sass_counts(
        _build, KERNELS).items()}
    print(json.dumps({
        "tree": os.path.dirname(os.path.dirname(os.path.abspath(
            amv_tpu_torch.__file__))),
        "card": tk.smi("name,power.limit"), "frames": N, "t_rec": t_rec,
        "w_budget": wb, "ms": out, "ptxas": tk.ptxas_lines(ptxas),
        "sass": sass}))


if __name__ == "__main__":
    main()
