"""Tracing of the port: spans and counters where the host work happens, and
the Chrome-trace exporter.

Tracing is on exactly while a torch profiler is active: the CLI's
`trace("cli")` under AMV_TRACE_DIR, or any caller's
`torch.profiler.profile`.  There is no other switch.

* `span(name, *, parent=None)`: a context manager.  Off, it returns one
  shared object that does nothing, after one read of the profiler's flag.
  On, it enters `torch.profiler.record_function("amv." + name)`, so the
  span lands in the profiler's Chrome trace on its own clock beside the
  kernels (on the threads the profiler follows: the one that started it),
  and keeps a `Span` in memory: its name, start and end from
  `time.perf_counter_ns()`, its thread, its parent (the innermost open span
  of the thread unless `parent=` names another, such as the span that
  issued a worker's job) and its request (the outermost span's id).
* `count(name, n=1)`: adds n to an in-memory counter, under the same
  switch.
* `recorded()` -> (spans, counters) kept so far; `reset()` forgets them.
  At most CAP spans are kept; past it a span is counted under DROPPED.
* `self_ns(spans)`: each span's duration less the union of its children
  within it.
* `trace(label)`: a torch.profiler trace (CPU, and CUDA where torch has a
  card) of the enclosed region, written as a Chrome trace under
  `$AMV_TRACE_DIR/<label>/` when that variable is set; nothing otherwise.
  The CLI runs every route under `trace("cli")`.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

CAP = 1 << 20
DROPPED = "profiling.dropped"


class Span(NamedTuple):
    """A closed span: times in perf_counter nanoseconds, `thread` the
    thread's ident, `parent` the parent's id (None for a request)."""
    id: int
    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: int | None
    request: int


_spans: list = []
_counters: dict = {}
_lock = threading.Lock()        # guards _spans and _counters
_ids = itertools.count(1)
_open = threading.local()       # .top: the thread's innermost open span


class _Off:
    """The span of an untraced run: enters and leaves doing nothing."""
    __slots__ = ()
    id = request = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    """A traced span between its enter and its exit."""
    __slots__ = ("name", "parent", "id", "request", "outer", "rf", "t0")

    def __init__(self, name: str, parent):
        self.name, self.parent = name, parent

    def __enter__(self):
        self.outer = getattr(_open, "top", None)
        if self.parent is None or self.parent.id is None:
            self.parent = self.outer
        self.id = next(_ids)
        self.request = self.id if self.parent is None else \
            self.parent.request
        _open.top = self
        self.rf = torch.profiler.record_function("amv." + self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        _open.top = self.outer
        rec = Span(self.id, self.name, self.t0, t1, threading.get_ident(),
                   None if self.parent is None else self.parent.id,
                   self.request)
        with _lock:
            if len(_spans) < CAP:
                _spans.append(rec)
            else:
                _counters[DROPPED] = _counters.get(DROPPED, 0) + 1
        return False


def span(name: str, *, parent=None):
    """A span named `name` (traced as "amv." + name) around the block, or
    the shared no-op when no profiler is active.  `parent` is the object
    another span's `with` gave (or None: the thread's innermost open
    span)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name, parent)


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` while a profiler is active."""
    if _profiler._is_profiler_enabled:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def recorded():
    """(spans, counters) kept so far: a list of `Span` in the order they
    closed, and a dict name -> count."""
    with _lock:
        return list(_spans), dict(_counters)


def reset() -> None:
    """Forget the spans and counters kept so far."""
    with _lock:
        _spans.clear()
        _counters.clear()


def self_ns(spans) -> dict:
    """span id -> its self time in ns: its duration less the union of its
    children's intervals clipped to it (a worker's child may outlive its
    parent)."""
    kids: dict = {}
    for s in spans:
        if s.parent is not None:
            kids.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    out = {}
    for s in spans:
        covered, end = 0, s.start_ns
        for a, b in sorted(kids.get(s.id, ())):
            a, b = max(a, end), min(b, s.end_ns)
            if b > a:
                covered += b - a
                end = b
        out[s.id] = s.end_ns - s.start_ns - covered
    return out


@contextlib.contextmanager
def trace(label: str = "amv_tpu_torch"):
    """Profile the region with torch.profiler and write its Chrome trace to
    $AMV_TRACE_DIR/<label>/trace_<pid>.json when the variable is set;
    otherwise do nothing."""
    trace_dir = os.environ.get("AMV_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = os.path.join(trace_dir, label)
    os.makedirs(out, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out, f"trace_{os.getpid()}.json"))
