"""The traced run (`--trace 1`): torch.profiler over the measured window,
its Chrome trace parsed into device intervals and the harness's own host
spans, and the arithmetic the per-layer readers share.

Spans are the harness's own `pb.*` record_function ranges around its
calls into the program (`span`); with tracing off they cost nothing.  The
union of device intervals is `amv_tpu_torch/tools/time_serving.py:
device_busy_s`'s, copied.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy",
               "gpu_memset": "memset"}
WINDOW = "pb.window"


class Spans:
    """Harness spans: record_function ranges when tracing, else none."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(f"pb.{name}")


@dataclass
class TraceView:
    """One traced window: seconds from the window's start."""
    window_s: float
    kernels: list = field(default_factory=list)   # (name, start, end)
    copies: list = field(default_factory=list)    # (name, start, end)
    memsets: list = field(default_factory=list)   # (name, start, end)
    spans: list = field(default_factory=list)     # (name, start, end)

    def device(self):
        return self.kernels + self.copies + self.memsets


def union_s(intervals) -> float:
    """Seconds covered by the union of (name, start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for _, a, b in sorted(intervals, key=lambda t: t[1]):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def parse_chrome_trace(path: str) -> TraceView:
    """The device intervals and harness spans of a Chrome trace holding one
    `pb.window` span, clipped to that window."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans, dev = [], {"kernel": [], "memcpy": [], "memset": []}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        a = float(ev["ts"]) * 1e-6
        b = a + float(ev.get("dur", 0.0)) * 1e-6
        if cat in DEVICE_CATS:
            dev[DEVICE_CATS[cat]].append((name, a, b))
        elif cat == "user_annotation" and name.startswith("pb."):
            spans.append((name[3:], a, b))
    wins = [s for s in spans if s[0] == WINDOW[3:]]
    if len(wins) != 1:
        raise RuntimeError(f"trace holds {len(wins)} window spans, not 1")
    _, w0, w1 = wins[0]

    def clip(items):
        return [(n, max(a, w0) - w0, min(b, w1) - w0) for n, a, b in items
                if b > w0 and a < w1]

    return TraceView(window_s=w1 - w0, kernels=clip(dev["kernel"]),
                     copies=clip(dev["memcpy"]), memsets=clip(dev["memset"]),
                     spans=clip(s for s in spans if s[0] != WINDOW[3:]))


@contextlib.contextmanager
def profiled(holder: dict):
    """Profile the block with torch.profiler (CPU and CUDA); on exit put
    its parsed TraceView under holder["view"].  The Chrome trace goes to
    a temporary file that is removed once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        holder["view"] = parse_chrome_trace(path)
    finally:
        os.remove(path)
    del prof
    torch.cuda.synchronize()


def idle_pct(view: TraceView) -> float:
    """The share of the window in which no kernel, copy or memset ran."""
    return 100.0 * (1.0 - union_s(view.device()) / view.window_s)


def kernel_s(view: TraceView, *parts: str) -> float:
    """Device seconds of the kernels whose name holds every one of parts
    (all kernels when none is given)."""
    return sum(b - a for n, a, b in view.kernels
               if all(p in n for p in parts))


def breakdown(view: TraceView, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps
    between device intervals summed by the innermost harness span that
    covers each gap's middle ("none" outside every span)."""
    by_op: dict = {}
    for n, a, b in view.device():
        by_op[n] = by_op.get(n, 0.0) + (b - a)
    gaps, end = [], 0.0
    for _, a, b in sorted(view.device(), key=lambda t: t[1]):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if end < view.window_s:
        gaps.append((end, view.window_s))
    by_span: dict = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inside = [s for s in view.spans if s[1] <= mid <= s[2]]
        name = min(inside, key=lambda s: s[2] - s[1])[0] if inside \
            else "none"
        by_span[name] = by_span.get(name, 0.0) + (b - a)

    def first(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]

    return {"device_ops": first(by_op), "idle_gaps": first(by_span)}
