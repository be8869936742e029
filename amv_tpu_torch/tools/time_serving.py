"""Time the served AMV->AMV transcode (`pipeline/serving.py:
AsyncTranscoder`) of the amv_tpu_torch package that comes first on
sys.path: the port's counterpart of `scripts/measure_pipeline.py`.

    PYTHONPATH=. python3 amv_tpu_torch/tools/time_serving.py [--parent DIR]

The file is `chip_smoke.py`'s corpus twice over: 9,600 frames of 160x120
(seeded videogen and rotozoom pictures with +-3 luma noise, C-encoded at
qscale 2) and one encoded second of 22,050 Hz audio repeated, over the
default AMV_SERVE_THRESHOLD (8,192).  It reports, on the device named in
the output:

* the sweep: `AsyncTranscoder(80, size=(160, 120), batch_frames=B,
  depth=K).transcode(video)` for K in 1, 2, 4, 8 and B in 1,024, 4,096:
  the median host-clock seconds of `reps` passes after a warm-up, and
  frames/s; every configuration's payloads equal the first's;
* the device's idle share in one more pass of each configuration: one
  minus the device's busy time (the union of the intervals of its
  kernels, copies and memsets in a torch.profiler trace) over the pass's
  wall time; "not measured" (null) on the CPU;
* `transcode_bytes` on the whole file through the served route with
  each batch size of the sweep (`pipeline.transcode.SERVE_BATCH_FRAMES`)
  and, with AMV_SERVE_THRESHOLD at the frame count, the whole-file route,
  in turns: median seconds and frames/s;
* the staged escape of the whole file's words: this tree's
  `native.escape_packed` (and the mux from its buffer) against
  `--parent`'s `native.escape_frames` (and the mux of its bytes), on the
  same words, in turns (parent, change, change, parent).

Prints one JSON line: the tree, the card's name and power limit, and the
readings.  `--frames`, `--size`, `--batches`, `--depths`, `--reps` and
`--device cpu` shrink it for a check on the CPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def corpus(frames: int, w: int, h: int):
    """(payloads, .amv bytes): `chip_smoke.py`'s corpus of frames // 2
    pictures, twice over, with its audio."""
    smoke = _load("chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    m = smoke.import_port()
    pays = smoke.c_encode(m, smoke.pictures(m, frames // 2, h, w, seed=0))
    pays = pays + pays
    second = m.ref_adpcm.encode(m.fixtures.audiogen(1.0, smoke.RATE, seed=0),
                                round(smoke.RATE / smoke.FPS), smoke.RATE)
    audio = second * max(1, frames // smoke.FPS)
    return pays, m.riff.mux(pays, audio, width=w, height=h, fps=smoke.FPS,
                            sample_rate=smoke.RATE)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def host_s(fn, reps, device):
    """(median host-clock seconds of fn() after a warm-up, the last
    result)."""
    out = fn()
    times = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def device_busy_s(prof) -> float:
    """Seconds the device was busy in a torch.profiler trace: the union of
    the intervals of its CUDA events (kernels, copies, memsets).  Raises
    when the trace holds none."""
    from torch.autograd import DeviceType
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA)
    if not spans:
        raise RuntimeError("torch.profiler saw no device events")
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def idle_share(fn, device):
    """(1 - device busy / wall, wall seconds) of one call of fn under
    torch.profiler; (None, wall) on the CPU, where it is not measured."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        fn()
        return None, time.perf_counter() - t0
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return 1.0 - device_busy_s(prof) / wall, wall


def smi(device) -> str:
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def staged_escape(native, parent, riff, words, bits, w, h, reps):
    """Median seconds of the escape alone and of escape + mux: this tree's
    escape_packed (memoryviews into its buffer to the mux) and, where a
    parent tree is given, its escape_frames (bytes to the mux), in turns
    (parent, change, change, parent)."""
    def change():
        buf, offsets, lens = native.escape_packed(words, bits)
        mv = memoryview(buf)
        return [mv[o:o + n] for o, n in zip(offsets.tolist(),
                                            lens.tolist())]

    fns = {"change": change}
    if parent is not None:
        fns["parent"] = lambda: parent.escape_frames(words, bits)
    want = [bytes(v) for v in change()]
    if parent is not None:
        assert fns["parent"]() == want, "the trees' escapes differ"
    out = {f"{k}_{s}": [] for k in fns for s in ("escape", "escape_mux")}
    turns = ["parent", "change", "change", "parent"] if parent else \
        ["change"] * 2
    for _ in range(reps):
        for k in turns:
            t0 = time.perf_counter()
            video = fns[k]()
            t1 = time.perf_counter()
            riff.mux(video, [], width=w, height=h, fps=16)
            t2 = time.perf_counter()
            out[f"{k}_escape"].append(t1 - t0)
            out[f"{k}_escape_mux"].append(t2 - t0)
    return {k: statistics.median(v) for k, v in out.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a parent tree, for its escape")
    ap.add_argument("--frames", type=int, default=9600)
    ap.add_argument("--size", default="160x120")
    ap.add_argument("--batches", type=int, nargs="+", default=[1024, 4096])
    ap.add_argument("--depths", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import amv_tpu_torch
    from amv_tpu_torch import native
    from amv_tpu_torch.containers import riff
    from amv_tpu_torch.pipeline import transcode as P
    from amv_tpu_torch.pipeline.serving import AsyncTranscoder
    dev = args.device
    if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("time_serving: no CUDA device")
    w, h = map(int, args.size.split("x"))
    n_mcu = ((w + 15) // 16) * ((h + 15) // 16)
    pays, data = corpus(args.frames, w, h)
    n = len(pays)
    out = {"sweep": {}}
    want = None
    for batch in args.batches:
        for depth in args.depths:
            def serve():
                return AsyncTranscoder(
                    n_mcu, 2, batch, depth, size=(w, h),
                    device=dev).transcode(pays)
            sec, got = host_s(serve, args.reps, dev)
            want = got if want is None else want
            assert got == want, (batch, depth)
            idle, wall = idle_share(serve, dev)
            out["sweep"][f"{batch}x{depth}"] = {
                "s": sec, "frames_s": n / sec, "idle_share": idle,
                "profiled_wall_s": wall}
    routes = {f"served_{b}": (str(n - 1), b) for b in args.batches}
    routes["whole"] = (str(n), P.SERVE_BATCH_FRAMES)
    times = {k: [] for k in routes}
    for rep in range(args.reps + 1):     # in turns; the first a warm-up
        for route in (list(routes) if rep % 2 else list(routes)[::-1]):
            os.environ["AMV_SERVE_THRESHOLD"], P.SERVE_BATCH_FRAMES = \
                routes[route]
            sync(dev)
            t0 = time.perf_counter()
            got = P.transcode_bytes(data, device=dev)
            sync(dev)
            times[route].append(time.perf_counter() - t0)
            assert riff.demux(got).video_chunks == want, route
    os.environ.pop("AMV_SERVE_THRESHOLD")
    P.SERVE_BATCH_FRAMES = routes["whole"][1]
    out["transcode_bytes"] = {
        k: {"s": statistics.median(v[1:]), "frames_s": n / statistics.median(
            v[1:]), "all_s": v[1:]} for k, v in times.items()}
    rows, lens = native.unescape_frames(pays)
    words, bits, ok = P.transcode_complete(
        torch.from_numpy(rows).to(dev), torch.from_numpy(lens).to(dev),
        n_mcu, 2, (w, h))
    assert bool(ok.all())
    parent = (_load("parent_native", os.path.join(
        args.parent, "amv_tpu_torch", "native", "__init__.py"))
        if args.parent else None)
    out["staged_escape_s"] = staged_escape(
        native, parent, riff, words.cpu().numpy(), bits.cpu().numpy(), w,
        h, args.reps)
    line = {"tree": os.path.dirname(os.path.dirname(os.path.abspath(
        amv_tpu_torch.__file__))), "card": smi(dev), "device": dev,
        "frames": n, "size": args.size, **out}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main(sys.argv[1:])
