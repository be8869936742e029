"""The control of a cell's correctness check: the plain reference put in
the program's place, computed in the precision below the one the
configuration states, on each seed given.  Every number it is compared
on should come out over its limit (the check fails).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3

Prints one JSON line a seed: {"seed", "checks": {name: {value, limit}},
"correct"}.  The benchmark's own runs never run it.  The program runs
only in the set-up's warm-up (the inputs are made as a run makes them).
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

from portbench.run import cell_spec, make_driver    # noqa: E402
from portbench.trace import Spans                   # noqa: E402


def control(spec: dict, seed: int, device="cuda") -> dict:
    drv = make_driver(spec, seed, Spans(False), device)
    try:
        drv.setup()
        drv.release()
        drv.control_window()
        checks = drv.check()
    finally:
        if hasattr(drv, "close"):
            drv.close()
    return {"seed": seed,
            "checks": {n: {"value": v, "limit": lim}
                       for n, v, lim in checks},
            "correct": all(v <= lim for _, v, lim in checks)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    args = ap.parse_args(argv)
    spec = cell_spec(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control(spec, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
