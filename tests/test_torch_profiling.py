"""amv_tpu_torch.utils.profiling: the port's spans and counters, on the CPU.

Off (no torch profiler active) a span is one shared object that records
nothing, allocates nothing and builds no record_function.  On, spans nest
per thread, carry their request, take a parent across threads, land in
the profiler's Chrome trace as `amv.*` annotations, and stop at the cap;
self time is a span's duration less its children's union.  The served
transcode records its stages and counts its frames; the native library is
built once when four threads ask for it first.
"""

import itertools
import json
import threading
import tracemalloc
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from amv_tpu.verify import fixtures  # noqa: E402
from amv_tpu_torch import native  # noqa: E402
from amv_tpu_torch.containers import riff  # noqa: E402
from amv_tpu_torch.pipeline import transcode as P  # noqa: E402
from amv_tpu_torch.utils import profiling as prof  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh():
    prof.reset()
    yield
    prof.reset()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name(spans):
    return {s.name: s for s in spans}


def test_off_span_is_shared_and_records_nothing(monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled

    def refuse(*a, **k):
        raise AssertionError("record_function built with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first = prof.span("a")
    assert prof.span("b") is first
    assert prof.span("c", parent=first) is first
    with prof.span("a") as s:
        with prof.span("b"):
            prof.count("n", 3)
    assert s is first
    assert prof.recorded() == ([], {})


def test_off_span_allocates_nothing():
    span = prof.span

    def calls():
        for _ in itertools.repeat(None, 5000):
            span("x")

    def empty():
        for _ in itertools.repeat(None, 5000):
            pass

    peaks = {}
    for f in (calls, empty, calls, empty):
        f()
        tracemalloc.start()
        try:
            base, _ = tracemalloc.get_traced_memory()
            tracemalloc.reset_peak()
            f()
            now, peak = tracemalloc.get_traced_memory()
        finally:
            tracemalloc.stop()
        assert now == base, f.__name__
        peaks[f.__name__] = peak - base
    assert peaks["calls"] == peaks["empty"]


def test_on_nesting_parents_and_requests():
    with _profiled():
        with prof.span("req") as req:
            with prof.span("child") as child:
                with prof.span("grandchild"):
                    pass
            prof.count("n")
            prof.count("n", 4)
        with prof.span("other"):
            pass
    spans, counters = prof.recorded()
    got = _by_name(spans)
    assert [s.name for s in spans] == ["grandchild", "child", "req", "other"]
    assert got["req"].parent is None and got["req"].request == req.id
    assert got["child"].parent == req.id and got["child"].request == req.id
    assert got["grandchild"].parent == child.id
    assert got["grandchild"].request == req.id
    assert got["other"].parent is None
    assert got["other"].request == got["other"].id != req.id
    assert got["req"].start_ns <= got["child"].start_ns <= \
        got["grandchild"].start_ns <= got["grandchild"].end_ns <= \
        got["child"].end_ns <= got["req"].end_ns <= got["other"].start_ns
    assert {s.thread for s in spans} == {threading.get_ident()}
    assert counters == {"n": 5}
    # off again: nothing more is kept
    with prof.span("late"):
        prof.count("n")
    assert prof.recorded() == (spans, counters)


def test_on_worker_span_takes_its_parent():
    def job(parent):
        with prof.span("work", parent=parent):
            with prof.span("inner"):
                return threading.get_ident()

    with _profiled():
        with prof.span("req") as req:
            with prof.span("issue") as issued:
                pass
            with ThreadPoolExecutor(1) as ex:
                tid = ex.submit(job, issued).result()
            with ThreadPoolExecutor(1) as ex:
                ex.submit(job, None).result()
    spans, _ = prof.recorded()
    works = [s for s in spans if s.name == "work"]
    inners = [s for s in spans if s.name == "inner"]
    assert works[0].thread == tid != threading.get_ident()
    assert works[0].parent == issued.id and works[0].request == req.id
    assert inners[0].parent == works[0].id
    assert inners[0].request == req.id
    # no parent given: the worker thread has no open span, so a request
    assert works[1].parent is None and works[1].request == works[1].id
    assert inners[1].request == works[1].id


def test_on_spans_in_the_chrome_trace(tmp_path):
    with _profiled() as p:
        with prof.span("outer"):
            with prof.span("inner"):
                torch.ones(4).sum()
    path = tmp_path / "trace.json"
    p.export_chrome_trace(str(path))
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"amv.outer", "amv.inner"} <= names


def test_cap_and_dropped(monkeypatch):
    monkeypatch.setattr(prof, "CAP", 3)
    with _profiled():
        for _ in range(5):
            with prof.span("s"):
                pass
    spans, counters = prof.recorded()
    assert len(spans) == 3
    assert counters == {prof.DROPPED: 2}
    prof.reset()
    assert prof.recorded() == ([], {})


def test_self_time_is_duration_less_childrens_union():
    S = prof.Span
    spans = [S(1, "p", 100, 200, 0, None, 1),
             S(2, "a", 110, 140, 0, 1, 1),
             S(3, "b", 130, 150, 0, 1, 1),      # overlaps a: union 110-150
             S(4, "c", 190, 260, 9, 1, 1),      # outlives p: 190-200 counts
             S(5, "d", 115, 120, 0, 2, 1),      # a's child, not p's
             S(6, "q", 300, 310, 0, None, 6)]
    got = prof.self_ns(spans)
    assert got == {1: 100 - 40 - 10, 2: 30 - 5, 3: 20, 4: 70, 5: 5, 6: 10}


def _clip(n, h=32, w=48, seed=3):
    rng = np.random.default_rng(seed)
    y, cb, cr = fixtures.videogen(n, h, w, seed=seed)
    cb, cr = cb[:, :h // 2, :w // 2], cr[:, :h // 2, :w // 2]
    y = np.clip(y.astype(np.int16) + rng.integers(-2, 3, y.shape), 0,
                255).astype(np.uint8)
    pays = [native.ref_encode_frame(y[i], cb[i], cr[i], 2) for i in range(n)]
    audio = [bytes(8 + 4 * i) for i in range(n)]
    return riff.mux(pays, audio, width=w, height=h, fps=16)


def test_served_transcode_records_its_stages(monkeypatch):
    """Past AMV_SERVE_THRESHOLD on the CPU route (batches of 2, 4 in
    flight): every stage's span under the one request, the drains on the
    worker under their batches' issue, and the frames counted.  The CPU
    route has no CUDA events, so no serve.wait_count or wait_packed."""
    n = 9
    data = _clip(n)
    monkeypatch.setattr(P, "SERVE_BATCH_FRAMES", 2)
    monkeypatch.setenv("AMV_SERVE_THRESHOLD", "6")
    want = P.transcode_bytes(data, device="cpu")
    assert prof.recorded() == ([], {})
    with _profiled():
        got = P.transcode_bytes(data, device="cpu")
    assert got == want
    spans, counters = prof.recorded()
    assert counters == {"serve.frames": n}
    names = {s.name for s in spans}
    assert {"transcode_bytes", "riff.demux", "riff.mux", "serve.issue",
            "native.unescape", "serve.pack", "serve.drain", "native.escape",
            "serve.wait_slot"} <= names
    assert not names & {"serve.wait_count", "serve.wait_packed"}
    (req,) = [s for s in spans if s.parent is None]
    assert req.name == "transcode_bytes"
    assert all(s.request == req.id for s in spans)
    by_id = {s.id: s for s in spans}
    main = req.thread
    for s in spans:
        if s.name in ("riff.demux", "riff.mux", "serve.issue", "serve.pack",
                      "serve.wait_slot"):
            assert s.parent == req.id and s.thread == main, s
        if s.name == "native.unescape":
            assert by_id[s.parent].name == "serve.issue"
        if s.name == "serve.drain":
            assert by_id[s.parent].name == "serve.issue"
            assert s.thread != main
        if s.name == "native.escape":
            assert by_id[s.parent].name == "serve.drain"
    issues = [s for s in spans if s.name == "serve.issue"]
    drains = [s for s in spans if s.name == "serve.drain"]
    assert len(issues) == len(drains) == (n + 1) // 2
    assert sorted(d.parent for d in drains) == sorted(i.id for i in issues)


def test_native_library_built_once_by_four_threads(tmp_path, monkeypatch):
    """Four threads make the first native.library() call into an empty
    build directory: each gets the one library and none raises."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_SO", str(tmp_path / "libamv_host.so"))
    monkeypatch.setattr(native, "_lib", None)
    gate = threading.Barrier(4)

    def first_call():
        gate.wait(timeout=60)
        return native.library()

    with ThreadPoolExecutor(4) as ex:
        libs = [f.result(timeout=300)
                for f in [ex.submit(first_call) for _ in range(4)]]
    assert all(lib is libs[0] for lib in libs)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["libamv_host.so"]
    rows, lens = native.unescape_frames([b"\xff\xd8\x12\xff\x00\x34\xff\xd9"])
    assert lens.tolist() == [3] and rows[0, :3].tolist() == [0x12, 0xFF, 0x34]
