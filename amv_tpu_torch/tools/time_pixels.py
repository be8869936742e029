"""Time kernel Y (`csrc/yuv2rgb_packed.cu`, the `-pix_fmt` packed
outputs) of this tree against a parent tree's, in turns.

    PYTHONPATH=. python3 amv_tpu_torch/tools/time_pixels.py --parent DIR

Both sources are built by nvcc with the port's flags into libraries of
their own under build/amv_tpu_torch/ (ptxas's registers and spills of
each kernel, and cuobjdump's static SASS counts), and called through
their C entry `amv_yuv2rgb_packed` with this tree's tables and geometry
(a parent's struct Packing is a prefix of this tree's).  The input is
`chip_smoke.py`'s 4,800 seeded pictures of 160x120 on the card.  For
each of the 15 formats at the default key: both outputs equal to
`yuv420_to_packed_plain` on the card, then bursts of `--reps` launches
between two CUDA events (the median of 3 bursts) in the order parent,
change, change, parent (`--variant NAME=PATH` adds other sources of the
same C entry, timed between them; `--general` adds this tree's source with
its whole-group path switched off); the device time of rgb24 from
torch.profiler; each format's bound (`utils/roofline.py`: its planes read
once and its pixels written once).  Without `--parent` only this tree is
timed.

Prints one JSON line (also written to chiprun_out/time_pixels.json):
the card's name and power limit, the shape, and the readings.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OPS_PIXEL = 30     # chip_smoke.py's count of a packed pixel's operations
# the C entry's choice of the whole-group path (kFull), which --general
# turns off
FULL_PICK = "const bool full ="


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(build_mod, sources):
    """{name: (CDLL, ptxas lines)} for sources {name: .cu path}, all
    compiled together with the port's flags and -Xptxas -v."""
    from amv_tpu_torch.tools import time_transcode_kernel as tk
    os.makedirs(build_mod.BUILD_DIR, exist_ok=True)
    sos = {n: os.path.join(build_mod.BUILD_DIR, f"libY_{n}.so")
           for n in sources}
    procs = [(n, subprocess.Popen(
        [build_mod._nvcc(), *build_mod.NVCC_FLAGS, "-shared", "-Xptxas",
         "-v", "-o", sos[n], path], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)) for n, path in sources.items()]
    lines = tk.ptxas_lines(procs)
    out = {}
    for n in sources:
        lib = ctypes.CDLL(sos[n])
        lib.amv_yuv2rgb_packed.argtypes = \
            build_mod._SIGNATURES["amv_yuv2rgb_packed"]
        lib.amv_yuv2rgb_packed.restype = ctypes.c_int
        out[n] = (lib, lines[n], sos[n])
    return out


def burst_ms(fn, reps):
    """Milliseconds a call of fn over reps calls issued back to back
    between two CUDA events: the median of 3 bursts, after one."""
    for _ in range(reps):
        fn()
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a parent tree (its csrc/ is built)")
    ap.add_argument("--frames", type=int, default=4800)
    ap.add_argument("--size", default="160x120")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=PATH: another yuv2rgb_packed.cu to time")
    ap.add_argument("--general", action="store_true",
                    help="also time this tree's source on its general path "
                         "alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_pixels: needs a CUDA device")
    from amv_tpu_torch.kernels import _build
    from amv_tpu_torch.kernels import yuv2rgb_dither as Y
    from amv_tpu_torch.tools import time_g729 as tg
    from amv_tpu_torch.tools import time_transcode_kernel as tk
    from amv_tpu_torch.tools import time_trellis as tt
    from amv_tpu_torch.utils.roofline import bound_ms
    smoke = _load("chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    m = smoke.import_port()
    w, h = (int(v) for v in args.size.split("x"))
    dev = torch.device("cuda")

    sources = {"change": os.path.join(tk._csrc(_build),
                                      "yuv2rgb_packed.cu")}
    if args.parent:
        sources["parent"] = os.path.join(args.parent, "amv_tpu_torch",
                                         "csrc", "yuv2rgb_packed.cu")
    if args.general:
        with open(sources["change"]) as f:
            src = f.read()
        assert src.count(FULL_PICK) == 1, FULL_PICK
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        sources["general"] = os.path.join(_build.BUILD_DIR,
                                          "yuv2rgb_general.cu")
        with open(sources["general"], "w") as f:
            f.write(src.replace(FULL_PICK, FULL_PICK + " false &&"))
    sources.update(v.split("=", 1) for v in args.variant)
    libs = build(_build, sources)
    planes = [torch.from_numpy(p).to(dev) for p in smoke.pictures(
        m, args.frames, h, w, seed=0)]
    px = args.frames * h * w
    runs, calls = {}, {}
    for fmt in Y._FORMATS:
        key = (fmt, True, True, 0, 65536, 65536)
        tab = torch.from_numpy(Y.kernel_tables(*key)).to(dev)
        geo = Y.kernel_geometry(key, args.frames, h, w)
        shape, dtype, _ = Y._out_shape(fmt, (args.frames,), h, w)
        want = Y.yuv420_to_packed_plain(*planes, fmt=fmt)
        for name, (lib, _, _) in libs.items():
            out = torch.empty(shape, dtype=dtype, device=dev)

            def call(lib=lib, out=out, tab=tab, geo=geo):
                with _build.on_device(*planes, tab, out) as (_, stream):
                    rc = lib.amv_yuv2rgb_packed(
                        *(p.data_ptr() for p in planes), tab.data_ptr(), geo,
                        out.data_ptr(), stream)
                assert rc == 0, rc
                return out

            call()
            torch.cuda.synchronize()
            assert torch.equal(out, want), f"{name} {fmt} differs from plain"
            calls[(name, fmt)] = call
        nbytes = px * 3 // 2 + want.numel() * want.element_size()
        runs[fmt] = {"bound_ms": bound_ms(nbytes, px * OPS_PIXEL)[0],
                     "bytes": nbytes, "turns": []}
        del want
    order = (["parent"] if args.parent else []) + [
        n for n in sources if n != "parent"]
    turns = order + order[::-1]
    for name in turns:
        for fmt in Y._FORMATS:
            runs[fmt]["turns"].append(
                (name, burst_ms(calls[(name, fmt)], args.reps)))
    device = {name: tt.device_ms(calls[(name, "rgb24")], 10, dev)
              for name in libs}
    result = {
        "tree": _ROOT, "card": tk.smi("name,power.limit"),
        "shape": f"{args.frames} frames {w}x{h}", "reps": args.reps,
        "turns": turns, "formats": runs, "device_rgb24": device,
        "ptxas": {n: v[1] for n, v in libs.items()},
        "sass": {n: tg.sass_ops(v[2], "yuv2rgb") for n, v in libs.items()},
    }
    for fmt, r in runs.items():
        by = {n: [t for k, t in r["turns"] if k == n] for n in libs}
        print(f"{fmt:10s} bound {r['bound_ms']:.4f} ms; " + "; ".join(
            f"{n} {', '.join(f'{t:.4f}' for t in ts)}"
            for n, ts in by.items()), file=sys.stderr)
    os.makedirs(os.path.join(_ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(_ROOT, "chiprun_out", "time_pixels.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
