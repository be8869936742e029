"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

BENCHMARK.json (at the checkout's root) names each cell's configuration
(portbench/configs/<config>.json) and traffic mix
(portbench/traffic/<mix>.json, which names its driver in
portbench/drivers/ and gives its parameters) and the metrics the cell
reports.  The run makes its inputs from the seed, warms the program
(`amv_tpu_torch`) up (set-up), drives it for `--seconds`, checks what it
produced against the plain reference, and prints one JSON line as the
last line of standard output: with --trace 0 the cell's end-to-end
metrics, with --trace 1 its per-layer metrics, each read by
portbench/metrics/<metric>.py from the torch.profiler trace of the
window.  The numbers compared are printed beside their limits as the last
lines of standard error and under "checks" in the JSON line.

Exits 2 without a result when no CUDA card (or fewer than the cell asks
for) is visible, and 3 when JAX or the JAX package (`amv_tpu`) was loaded.
"""

import time

T0 = time.perf_counter()

import argparse                                         # noqa: E402
import gc                                               # noqa: E402
import importlib                                        # noqa: E402
import importlib.util                                   # noqa: E402
import json                                             # noqa: E402
import os                                               # noqa: E402
import statistics                                       # noqa: E402
import subprocess                                       # noqa: E402
import sys                                              # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.guard import forbidden_modules           # noqa: E402


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(name: str) -> dict:
    """The cell's entry of BENCHMARK.json with its configuration, its
    traffic mix and the metrics it reports."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in e2e_names
                              else [])]
    return {"cell": w,
            "config": load_json(HERE, "configs", f"{w['config']}.json"),
            "traffic": load_json(HERE, "traffic", f"{w['traffic']}.json"),
            "end_to_end": e2e, "per_layer": layer}


def make_driver(spec: dict, seed: int, spans, device="cuda"):
    traffic = spec["traffic"]
    mod = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    return mod.Driver(spec["config"], traffic["params"], seed, spans,
                      device=device)


def reader(metric: str):
    """portbench/metrics/<metric>.py's read(view, work) -> value or None."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    s = importlib.util.spec_from_file_location(f"pb_metric_{metric}", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def card() -> dict:
    import torch
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1}
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.strip()
        dev["power_limit_w"] = float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        pass
    return dev


def run(spec: dict, seed: int, seconds: float, trace: bool,
        device="cuda") -> dict:
    """One run of a cell: set-up, the window, the check.  Returns the
    result's fields (without "device" on the CPU)."""
    import torch
    from portbench import trace as tr
    spans = tr.Spans(trace)
    drv = make_driver(spec, seed, spans, device)
    try:
        drv.setup()
        if device == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - T0
        held = {}
        if trace:
            with tr.profiled(held):
                with spans("window"):
                    drv.window(seconds)
        else:
            drv.window(seconds)
        res = drv.result()
        dev = None
        if device == "cuda":
            dev = card()
            dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
        drv.release()
        gc.collect()
        bad = forbidden_modules()
        if bad:
            print(f"forbidden modules loaded: {bad}", file=sys.stderr)
            raise SystemExit(3)
        checks = drv.check()
    finally:
        if hasattr(drv, "close"):
            drv.close()
    out = {"correct": all(v <= lim for _, v, lim in checks),
           "attempted": res["attempted"], "failed": res["failed"],
           "requests_s": res["requests_s"]}
    metrics = {}
    if trace:
        view = held["view"]
        for m in spec["per_layer"]:
            v = reader(m["name"])(view, res["work"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if dev is not None:
            dev["busy_s"] = tr.union_s(view.device())
            dev["window_s"] = view.window_s
        out["breakdown"] = tr.breakdown(view)
    else:
        for m in spec["end_to_end"]:
            v = setup_s if m["name"] == "setup_s" else res["e2e"][m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out["metrics"] = metrics
    if dev is not None:
        out["device"] = dev
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.pop("AMV_TRACE_DIR", None)   # the program's own trace: off
    spec = cell_spec(args.workload)
    import torch
    need = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: needs {need} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    out = run(spec, args.seed, args.seconds, bool(args.trace))
    req = out.pop("requests_s")
    q = statistics.quantiles(req, n=4) if len(req) > 1 else req * 3
    print(f"window: {len(req)} requests, seconds each: min {min(req):.4f} "
          f"q1 {q[0]:.4f} median {q[1]:.4f} q3 {q[2]:.4f} "
          f"max {max(req):.4f}", file=sys.stderr)
    if len(req) <= 64:
        print("window: seconds of each request: " +
              " ".join(f"{r:.4f}" for r in req), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
