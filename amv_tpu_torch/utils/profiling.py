"""Timing and tracing utilities: the port of `amv_tpu/utils/profiling.py`.

The reference's only tooling is `ffmpeg -benchmark`'s utime line and ad-hoc
START_TIMER rdtsc macros (libavutil/common.h); here:

* `stage_timer`: per-stage wall-clock accumulation into a `StageTimes`;
* `trace(label)`: a torch.profiler trace (CPU, and CUDA where torch has a
  card) of the enclosed region, written as a Chrome trace under
  `$AMV_TRACE_DIR/<label>/` when that variable is set; nothing otherwise.
  The CLI runs every route under `trace("cli")`.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict


class StageTimes(OrderedDict):
    """name -> accumulated seconds; prints like the reference's bench line."""

    def report(self) -> str:
        total = sum(self.values())
        parts = " ".join(f"{k}={v:.3f}s" for k, v in self.items())
        return f"bench stages: {parts} total={total:.3f}s"


@contextlib.contextmanager
def stage_timer(times: StageTimes, name: str):
    """Accumulate the wall-clock of a pipeline stage into `times[name]`.

    Work on a card runs asynchronously: a caller that times device work
    synchronizes (or copies a result to the host) inside the region."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def trace(label: str = "amv_tpu_torch"):
    """Profile the region with torch.profiler and write its Chrome trace to
    $AMV_TRACE_DIR/<label>/trace_<pid>.json when the variable is set;
    otherwise do nothing."""
    trace_dir = os.environ.get("AMV_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = os.path.join(trace_dir, label)
    os.makedirs(out, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out, f"trace_{os.getpid()}.json"))
