"""Time kernels D (Huffman decode) and E (Huffman encode) of the
amv_tpu_torch package that comes first on sys.path, and the three staged
device chains they sit in, at the main paths' shape on one GPU: 4,800
frames of 160x120 (seeded videogen and rotozoom pictures with +-3 luma
noise, C-encoded at qscale 2, as `chip_smoke.py` builds its corpus).

    PYTHONPATH=<tree> python3 amv_tpu_torch/tools/time_entropy_kernels.py

Kernels: the median of CUDA events over `reps` launches after a warm-up:
D on the length-sorted scans; E on the transcode's re-encode levels at
the transcode's word budget and at the exact one, and its count entry
where the tree has one; `pack_levels` (the encode path's entry to E) on
the same levels.  Chains: the median host-clock time, after a
synchronize, of the transcode's `transcode_complete` (D, cumsum, T, E),
the decode's D -> `resolve_dc` -> U (with the un-sort), and the encode's
V -> `pack_levels`.  Prints one JSON line: the tree, the card's name and
power limit, and the readings.  To compare two trees, run it from each
in turns (parent, change, change, parent) inside one command; a tree
from before the count entry packs with its first word budget.
"""

from __future__ import annotations

import inspect
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

N, W, H, QSCALE = 4800, 160, 120, 2


def corpus(native, fixtures):
    """(pictures (y, cb, cr), C-encoded payloads) of chip_smoke.py."""
    rng = np.random.default_rng(0)
    half = N // 2
    vg = fixtures.videogen(half, H, W, seed=0)
    rz = fixtures.rotozoom(N - half, H, W)
    y = np.empty((N, H, W), np.uint8)
    cb = np.empty((N, H // 2, W // 2), np.uint8)
    cr = np.empty_like(cb)
    for i in range(N):
        src = vg if (i // 16) % 2 == 0 else rz
        k = i // 32 * 16 + i % 16
        y[i] = np.clip(src[0][k].astype(np.int16) +
                       rng.integers(-3, 4, src[0][k].shape), 0, 255)
        cb[i] = src[1][k][:H // 2, :W // 2]
        cr[i] = src[2][k][:H // 2, :W // 2]
    pays = [native.ref_encode_frame(y[i], cb[i], cr[i], QSCALE)
            for i in range(N)]
    return (y, cb, cr), pays


def cuda_ms(fn, reps):
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return statistics.median(times)


def main(reps: int = 20) -> None:
    import amv_tpu_torch
    from amv_tpu_torch import native
    from amv_tpu_torch.codecs import amv_video
    from amv_tpu_torch.kernels import decode_fused as U
    from amv_tpu_torch.kernels import encode_fused as V
    from amv_tpu_torch.kernels import entropy_decode as D
    from amv_tpu_torch.kernels import entropy_encode as E
    from amv_tpu_torch.kernels import transcode as T
    from amv_tpu_torch.pipeline import transcode as P
    from amv_tpu_torch.verify import fixtures

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    pics, pays = corpus(native, fixtures)
    n_mcu = ((W + 15) // 16) * ((H + 15) // 16)
    nb = 6 * n_mcu
    rows, lens = native.unescape_frames(pays)
    order = np.argsort([len(p) for p in pays], kind="stable")
    r = torch.from_numpy(rows[order]).to(dev)
    ln = torch.from_numpy(lens[order]).to(dev)
    order_t = torch.from_numpy(order).to(dev)
    planes = [torch.from_numpy(p).to(dev) for p in pics]
    qmat = amv_video.encoder_qmat(QSCALE)
    if "w_first" in inspect.signature(amv_video.pack_levels).parameters:
        w_first = amv_video.first_word_budget(n_mcu)
        pack = lambda lv: amv_video.pack_levels(lv, w_first)  # noqa: E731
    else:
        pack = amv_video.pack_levels

    lv, ok = D.decode_scans(r, ln, nb)
    assert bool(ok.all())
    dc = amv_video.resolve_dc(lv.reshape(N, n_mcu, 6, 64)).reshape(-1)
    lv2 = T.transcode_blocks(lv.reshape(-1, 64), dc, qmat,
                             (W, H)).reshape(lv.shape)
    wb = P.word_budget(r)
    bits = E.encode_levels(lv2, wb)[1]
    w_used = (int(bits.max()) + 31) // 32
    out = {"D": cuda_ms(lambda: D.decode_scans(r, ln, nb), reps),
           "E": cuda_ms(lambda: E.encode_levels(lv2, wb), reps),
           "E_exact": cuda_ms(lambda: E.encode_levels(lv2, w_used), reps),
           "pack_levels": cuda_ms(lambda: pack(lv2), reps)}
    if hasattr(E, "count_bits"):
        out["E_count"] = cuda_ms(lambda: E.count_bits(lv2), reps)
    if "rounds" in inspect.signature(D.decode_scans).parameters:
        rounds = D.decode_scans(r, ln, nb, rounds=True)[2]
    else:                        # a tree from before the per-call rounds
        rounds = getattr(D, "LAST_ROUNDS", None)
    if rounds is not None:
        out["D_rounds_mean"] = float(rounds.float().mean())
        out["D_rounds_max"] = int(rounds.max())

    def decode_chain():
        lv, _ = D.decode_scans(r, ln, nb)
        dc = amv_video.resolve_dc(lv.reshape(N, n_mcu, 6, 64))
        return U.decode_planes(lv.reshape(-1, 64), dc.reshape(-1), W, H,
                               dst=order_t)

    out["chain_transcode"] = host_ms(lambda: P.transcode_complete(
        r, ln, n_mcu, QSCALE, (W, H)), reps)
    out["chain_decode"] = host_ms(decode_chain, reps)
    out["chain_encode"] = host_ms(lambda: pack(V.encode_planes(
        *planes, QSCALE)), reps)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"tree": os.path.dirname(os.path.dirname(
        os.path.abspath(amv_tpu_torch.__file__))), "card": card,
        "frames": N, "w_budget": wb, "w_used": w_used,
        "ms": {k: v for k, v in out.items()}}))


if __name__ == "__main__":
    main()
