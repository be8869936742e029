"""Traffic drivers.  A traffic mix (portbench/traffic/<mix>.json) names
one of these modules under "driver" and gives its parameters; the module's
`Driver(cfg, params, seed, spans, device="cuda")` then

* `setup()`: `make_inputs()` (the inputs, from the seed alone), then the
  program warmed up on the shapes the window will use (both counted in
  setup_s);
* `window(seconds)`: drives the program's entry until `seconds` have
  passed, the last request run to its end;
* `result()`: {"attempted", "failed", "requests_s" (each request's
  seconds), "e2e": {metric: value}, "work": {count: value}} of the window
  (the work counts feed the per-layer readers);
* `release()`: drops the program's state;
* `control_window()`: in place of the window, the plain reference's
  control (computed in the precision below the configuration's) produces
  the outputs (portbench/control.py);
* `check()`: compares the outputs with the plain reference: a list of
  (name, value, limit), each value <= its limit when correct;
* `close()`, where a driver has it: removes what set-up wrote.
"""

import time


def clock() -> float:
    """The host clock every driver times with."""
    return time.perf_counter()


def balanced_order(k: int, rng) -> list:
    """An order of k sizes given shortest first: short and long in pairs
    (the shortest with the longest, and so on), the pairs and each pair's
    order drawn from rng, so that any run of whole pairs holds the same
    mix of sizes whatever the seed."""
    pairs = [(i, k - 1 - i) for i in range(k // 2)]
    order = []
    for j in rng.permutation(len(pairs)):
        a, b = pairs[j]
        order += [a, b] if rng.integers(2) else [b, a]
    return order + ([k // 2] if k % 2 else [])
