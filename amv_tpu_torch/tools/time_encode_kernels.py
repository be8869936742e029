"""Time kernels Q (IMA-ADPCM encode), V (encode transform) and F (FDCT +
quantize) of the amv_tpu_torch package that comes first on sys.path, and
the encode path's staged device chains, at the main path's shapes on one
GPU: 300 s of seeded audiogen PCM at 22,050 Hz in the encoder's chunk
layout (one stream, 4,800 chunks of 1,378 samples), and 4,800 seeded
160x120 pictures (videogen and rotozoom with +-3 luma noise, as
`chip_smoke.py` makes them).

    PYTHONPATH=<tree> python3 amv_tpu_torch/tools/time_encode_kernels.py

Kernels: the median of CUDA events over `reps` launches after a warm-up:
Q on the stream (`encode_streams`), its wrap entry 8 times over, one
chunk alone (one segment: the latency of one segment's walk) and the
stream with no reset but at sample 0 (one 6.6 M-sample segment: the
serial floor, 3 launches); V's path entry with each quantizer and its
contract entry (`encode_fused`) on the coded planes; F's two entries on
the pictures' 2,304,000 blocks (`extract_blocks`, as `chip_smoke.py`
phase 4 takes them): zigzag out (`fdct_quant_blocks`) and raster out
(`fdct_quantize`), each held bit-exact against the plain version, with
its device time (`torch.profiler`, `_device`), `nvcc -Xptxas -v` of
csrc/fdct.cu and the static SASS count of its kernels (`cuobjdump`, NOPs
left out; F's API is the same in every tree of the port, so the tool
times an earlier tree's F too).  Q's launch split
by device kernel (`torch.profiler`, device time per launch of
`encode_streams`), and the segment table `segments()` where the tree's
`encode_streams` builds one (before kernel Q's windows).
Chains: the median host-clock time, after a synchronize, of
`encode_streams` on the stream ("device_Q") and of V -> `pack_levels`
with each quantizer.  Prints one JSON line: the tree, the card's name and
power limit, and the readings.  To compare two trees, run it from each in
turns (parent, change, change, parent) inside one command.
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

N, W, H, QSCALE, FPS, RATE = 4800, 160, 120, 2, 16, 22050
Q_WRAP = 8


def pictures(fixtures):
    """chip_smoke.py's 4,800 pictures (y, cb, cr)."""
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
    return y, cb, cr


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


def kernel_split(fn, reps):
    """Device milliseconds per call of fn by kernel name (torch.profiler),
    or None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if us > 0:
            split[ev.key[:60]] = us / 1e3 / reps
    return split or None


def main(reps: int = 20) -> None:
    import amv_tpu_torch
    from amv_tpu_torch.codecs import amv_audio, amv_video
    from amv_tpu_torch.codecs.jpeg_tables import ZIGZAG
    from amv_tpu_torch.kernels import _build, adpcm
    from amv_tpu_torch.kernels import fdct as F
    from amv_tpu_torch.kernels import decode_fused as U
    from amv_tpu_torch.kernels import encode_fused as V
    from amv_tpu_torch.tools import time_transcode_kernel as tk
    from amv_tpu_torch.verify import fixtures

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    ptxas = tk.ptxas_start(_build, ("fdct.cu",))
    pcm = fixtures.audiogen(N / FPS, RATE, seed=0)
    frame_size = (2 * RATE + FPS) // (2 * FPS)
    ns, _, padded, reset = amv_audio.stream_layout(pcm, frame_size, RATE)
    x = torch.from_numpy(padded[None]).to(dev)
    r = torch.from_numpy(reset[None]).to(dev)
    s0 = torch.zeros(1, dtype=torch.int32, device=dev)
    r_one = torch.zeros_like(r)
    r_one[:, 0] = True
    n1 = 2 * ns[0]
    out = {
        "Q": cuda_ms(lambda: adpcm.encode_streams(x, r, s0), reps),
        "Q_wrap8": cuda_ms(lambda: adpcm.encode_streams(x, r, s0,
                                                        repeat=Q_WRAP), reps),
        "Q_one_segment": cuda_ms(lambda: adpcm.encode_streams(
            x[:, :n1], r[:, :n1], s0), reps),
        "Q_no_resets": cuda_ms(lambda: adpcm.encode_streams(x, r_one, s0), 3),
        "device_Q": host_ms(lambda: adpcm.encode_streams(x, r, s0), reps)}
    if "segments(" in inspect.getsource(adpcm.encode_streams):
        out["Q_segments"] = cuda_ms(lambda: adpcm.segments(r), reps)
    split = {"Q": kernel_split(lambda: adpcm.encode_streams(x, r, s0), reps),
             "Q_one_segment": kernel_split(lambda: adpcm.encode_streams(
                 x[:, :n1], r[:, :n1], s0), reps)}

    pics = [torch.from_numpy(p).to(dev) for p in pictures(fixtures)]
    mb_w, mb_h = (W + 15) // 16, (H + 15) // 16
    n_mcu = mb_w * mb_h
    blocks = V.extract_blocks(*pics, mb_w, mb_h)
    coded = [p.contiguous() for p in U.coded_planes(
        blocks.view(N, n_mcu, 6, 8, 8), mb_w, mb_h)]
    out["V"] = cuda_ms(lambda: V.encode_planes(*pics, QSCALE), reps)
    out["V_q60"] = cuda_ms(lambda: V.encode_planes(*pics, QSCALE, "q60"),
                           reps)
    out["V_coded"] = cuda_ms(lambda: V.encode_fused(*coded, mb_w, mb_h,
                                                    QSCALE), reps)
    fb = blocks.reshape(-1, 64)
    qmat = amv_video.encoder_qmat(QSCALE)
    want = F.fdct_quantize_plain(fb, qmat)
    zz = torch.as_tensor(ZIGZAG, device=dev).long()
    for key, fn, ref in (
            ("F", lambda: F.fdct_quant_blocks(fb, qmat), want[:, zz]),
            ("F_raster", lambda: F.fdct_quantize(fb.view(-1, 8, 8), qmat),
             want)):
        assert torch.equal(fn(), ref), key
        out[key] = cuda_ms(fn, reps)
        out[f"{key}_device"] = tk.device_ms(fn, reps)
    del want
    out["chain_encode"] = host_ms(lambda: amv_video.pack_levels(
        V.encode_planes(*pics, QSCALE)), reps)
    out["chain_encode_q60"] = host_ms(lambda: amv_video.pack_levels(
        V.encode_planes(*pics, QSCALE, "q60")), reps)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"tree": os.path.dirname(os.path.dirname(
        os.path.abspath(amv_tpu_torch.__file__))), "card": card,
        "frames": N, "samples": int(padded.shape[0]), "chunks": len(ns),
        "F_blocks": fb.shape[0], "ms": out, "Q_kernels_ms": split,
        "ptxas": tk.ptxas_lines(ptxas),
        "sass": {fn: c for fn, (c, _) in tk.sass_counts(
            _build, ("fdct_quant_kernel",)).items()}}))


if __name__ == "__main__":
    main()
