"""The program's spans on the window's clock (`portbench/program_spans.py`)
and the seven readers of them, on synthetic windows with known answers:
each request shifted by its own pair's offset (the clocks drift between
requests), and every reader None when the pairs disagree, a request
starts late, spans were dropped or the program keeps no spans."""

import pytest

from amv_tpu_torch.utils import profiling as prof
from portbench import program_spans as ps
from portbench import run as R
from portbench import trace as tr

NS = 1_000_000_000
MAIN, WORKER = 1, 2
AMV = ("amv.native_us_per_frame", "amv.containers_us_per_frame",
       "amv.serve_wait_share", "amv.glue_us_per_frame", "amv.idle_in_spans")
LIB = "act.demux_us_per_file.library_decode"
ONE = "act.cli_host_ms.one_file"


class Program:
    """Spans given in window seconds, stored on a program clock that is
    the window's plus `clock` seconds (a request's own clock offset)."""

    def __init__(self):
        self.spans, self.ids = [], {}

    def add(self, key, name, a, b, clock, parent=None, thread=MAIN,
            request=None):
        sid = len(self.spans) + 1
        self.ids[key] = sid
        pid = self.ids[parent] if parent else None
        req = self.ids[request] if request else sid
        self.spans.append(prof.Span(sid, name, round((a + clock) * NS),
                                    round((b + clock) * NS), thread, pid,
                                    req))


def films(late=0.0, over=0.0):
    """Two films: harness spans 1.0-4.0 and 5.0-6.0 of a 10-s window (the
    first request's end 5 ms before its harness span's: the request's
    objects freed after it returns); the second request's clock 0.7 ms
    off the first's."""
    p = Program()
    c = 1000.0
    p.add("r0", "transcode_bytes", 1.0, 3.995, c)
    for key, name, a, b, parent, thread in (
            ("d0", "riff.demux", 1.0, 1.1, "r0", MAIN),
            ("i0", "serve.issue", 1.1, 1.3, "r0", MAIN),
            ("u0", "native.unescape", 1.15, 1.25, "i0", MAIN),
            ("p0", "serve.pack", 1.3, 1.5, "r0", MAIN),
            ("c0", "serve.wait_count", 1.3, 1.4, "p0", MAIN),
            ("s0", "serve.wait_slot", 1.5, 2.0, "r0", MAIN),
            ("w0", "serve.drain", 1.5, 2.5, "i0", WORKER),
            ("e0", "native.escape", 1.6, 2.2, "w0", WORKER),
            ("m0", "riff.mux", 3.5, 3.9, "r0", MAIN)):
        p.add(key, name, a, b, c, parent, thread, "r0")
    c = 1000.0007
    p.add("r1", "transcode_bytes", 5.0 + late, 5.99996 + over, c)
    for key, name, a, b, parent, thread in (
            ("d1", "riff.demux", 5.0 + late, 5.1, "r1", MAIN),
            ("i1", "serve.issue", 5.1, 5.2, "r1", MAIN),
            ("u1", "native.unescape", 5.1, 5.2, "i1", MAIN),
            ("w1", "serve.drain", 5.2, 5.6, "i1", WORKER),
            ("e1", "native.escape", 5.2, 5.5, "w1", WORKER),
            ("s1", "serve.wait_slot", 5.2, 5.6, "r1", MAIN),
            ("m1", "riff.mux", 5.6, 5.9, "r1", MAIN)):
        p.add(key, name, a, b, c, parent, thread, "r1")
    return p.spans


def films_view(extra=()):
    return tr.TraceView(
        window_s=10.0,
        kernels=[("k", 1.2, 1.6), ("k", 5.0, 5.05), ("k", 8.0, 9.0)],
        spans=[("transcode_bytes", 1.0, 4.0), ("transcode_bytes", 5.0, 6.0),
               *extra])


def library(shift=0.0, overrun=0.0):
    """Two passes: harness demux spans 0-0.3 and 1-1.3, each act.demux a
    request of its own; the second pass's clock 0.4 ms off."""
    p = Program()
    for i, (a, b) in enumerate(((0.0, 0.01), (0.01, 0.02), (0.02, 0.04))):
        p.add(f"a{i}", "act.demux", a, b, 500.0)
    for i, (a, b) in enumerate(((1.0, 1.01), (1.01, 1.03 + overrun))):
        p.add(f"b{i}", "act.demux", a + shift, b + shift, 500.0004)
    return p.spans


def library_view(passes=((0.0, 0.3), (1.0, 1.3))):
    return tr.TraceView(window_s=2.0, kernels=[("g", 0.4, 0.9)],
                        spans=[("demux", a, b) for a, b in passes])


def one_file():
    p = Program()
    for k, (a, b, c0, c1, clock) in enumerate((
            (0.0, 0.19999, 0.05, 0.15, 30.0),
            (0.2, 0.49999, 0.25, 0.45, 30.0002))):
        p.add(f"m{k}", "cli.main", a, b, clock)
        p.add(f"r{k}", "cli.read", a, a + 0.01, clock, f"m{k}",
              request=f"m{k}")
        p.add(f"d{k}", "act.demux", a + 0.01, a + 0.02, clock, f"m{k}",
              request=f"m{k}")
        p.add(f"c{k}", "cli.copy_back", c0, c1, clock, f"m{k}",
              request=f"m{k}")
    return p.spans


def one_file_view():
    return tr.TraceView(window_s=0.5, kernels=[("g", 0.06, 0.14)],
                        spans=[("cli_main", 0.0, 0.2),
                               ("cli_main", 0.2, 0.5)])


@pytest.fixture
def program(monkeypatch):
    held = {"spans": [], "counters": {}}
    monkeypatch.setattr(prof, "recorded", lambda: (
        list(held["spans"]), dict(held["counters"])))
    return held


def read_all(names, view):
    return {m: R.reader(m)(view, {"frames": 1}) for m in names}


def test_films_readers(program):
    program["spans"] = films()
    program["counters"] = {"serve.frames": 1000}
    got = read_all(AMV, films_view())
    assert got["amv.native_us_per_frame"] == pytest.approx(1100.0)
    assert got["amv.containers_us_per_frame"] == pytest.approx(900.0)
    assert got["amv.serve_wait_share"] == pytest.approx(10.0)
    # self time: 2.995 - 1.4 and 0.99996 - 0.9 seconds
    assert got["amv.glue_us_per_frame"] == pytest.approx(1694.96)
    # spans below the requests cover 1.0-2.5, 3.5-3.9, 5.0-5.9 (2.8 s), of
    # which 0.45 s the device was busy; idle 10 - 1.45
    assert got["amv.idle_in_spans"] == pytest.approx(100 * 2.35 / 8.55)


def test_each_request_takes_its_own_offset(program):
    program["spans"] = films()
    al = ps.aligned(films_view())
    starts = sorted((r.a, r.name) for r in al.spans
                    if r.name == "riff.demux")
    assert [a for a, _ in starts] == [pytest.approx(1.0, abs=1e-9),
                                      pytest.approx(5.0, abs=1e-9)]
    drain = [r for r in al.spans if r.name == "serve.drain"]
    assert {r.thread for r in drain} == {WORKER}
    assert sorted(r.a for r in drain) == [pytest.approx(1.5),
                                          pytest.approx(5.2)]


def test_library_reader(program):
    program["spans"] = library()
    assert R.reader(LIB)(library_view(), {}) == pytest.approx(14000.0)


def test_one_file_reader(program):
    program["spans"] = one_file()
    assert R.reader(ONE)(one_file_view(), {}) == pytest.approx(99.99)


@pytest.mark.parametrize("case", [
    "extra_harness_span", "late_request", "ends_after", "dropped",
    "no_program_spans"])
def test_films_readers_refuse(program, monkeypatch, case):
    program["spans"] = films(late=0.002 if case == "late_request" else 0.0,
                             over=0.002 if case == "ends_after" else 0.0)
    program["counters"] = {"serve.frames": 1000}
    view = films_view()
    if case == "extra_harness_span":
        view = films_view([("transcode_bytes", 8.0, 8.5)])
    elif case == "dropped":
        program["counters"][prof.DROPPED] = 1
    elif case == "no_program_spans":
        monkeypatch.delattr(prof, "recorded")
    assert read_all(AMV, view) == dict.fromkeys(AMV)


@pytest.mark.parametrize("case", [
    "pass_without_spans", "late_pass", "overrun", "dropped"])
def test_library_reader_refuses(program, case):
    program["spans"] = library(shift=0.003 if case == "late_pass" else 0.0,
                               overrun=0.3 if case == "overrun" else 0.0)
    view = library_view()
    if case == "pass_without_spans":
        view = library_view(((0.0, 0.3), (1.0, 1.3), (1.6, 1.9)))
    elif case == "dropped":
        program["counters"] = {prof.DROPPED: 3}
    assert R.reader(LIB)(view, {}) is None


@pytest.mark.parametrize("case", ["missing_pair", "dropped"])
def test_one_file_reader_refuses(program, case):
    program["spans"] = one_file()
    view = one_file_view()
    if case == "missing_pair":
        program["spans"] = program["spans"][:4]
    else:
        program["counters"] = {prof.DROPPED: 1}
    assert R.reader(ONE)(view, {}) is None


def test_readers_of_another_cell_find_nothing(program):
    program["spans"] = one_file()
    view = one_file_view()
    assert read_all(AMV, view) == dict.fromkeys(AMV)
    program["spans"] = films()
    program["counters"] = {"serve.frames": 1000}
    assert R.reader(ONE)(films_view(), {}) is None
