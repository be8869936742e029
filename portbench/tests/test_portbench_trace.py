"""The traced run's arithmetic on a synthetic Chrome trace: the window,
the device intervals, the union, the readers and the breakdown."""

import json
import os
import tempfile

import pytest

from portbench import roofline
from portbench import run as R
from portbench import trace as tr


def _trace(events):
    fd, path = tempfile.mkstemp(suffix=".json")
    with os.fdopen(fd, "w") as f:
        json.dump({"traceEvents": events}, f)
    return path


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


@pytest.fixture
def view():
    # a window of 1 s (ts in us) starting at 1e6
    events = [
        ev("user_annotation", "pb.window", 1_000_000, 1_000_000),
        ev("user_annotation", "pb.demux", 1_000_000, 200_000),
        ev("user_annotation", "pb.decode_streams", 1_200_000, 500_000),
        ev("kernel", "void g729_decode_kernel<4>(int)", 1_250_000, 400_000),
        ev("kernel", "elementwise", 1_600_000, 100_000),     # overlaps
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1_700_000,
           100_000),
        ev("gpu_memset", "Memset (Device)", 900_000, 200_000),  # clipped
        ev("cpu_op", "aten::copy_", 1_000_000, 999_000),     # ignored
        {"ph": "i", "cat": "kernel", "name": "x", "ts": 1_500_000},
    ]
    path = _trace(events)
    try:
        yield tr.parse_chrome_trace(path)
    finally:
        os.remove(path)


def test_window_and_intervals(view):
    assert view.window_s == pytest.approx(1.0)
    assert len(view.kernels) == 2 and len(view.copies) == 1
    assert view.memsets == [("Memset (Device)", 0.0, pytest.approx(0.1))]
    # union: memset 0-0.1, kernels 0.25-0.7, copy 0.7-0.8
    assert tr.union_s(view.device()) == pytest.approx(0.65)
    assert tr.idle_pct(view) == pytest.approx(35.0)
    assert tr.kernel_s(view, "g729_decode") == pytest.approx(0.4)


def test_breakdown_names_gaps_by_span(view):
    b = tr.breakdown(view)
    ops = dict(b["device_ops"])
    assert ops["void g729_decode_kernel<4>(int)"] == pytest.approx(0.4)
    gaps = dict(b["idle_gaps"])
    assert gaps["demux"] == pytest.approx(0.15)         # 0.1 - 0.25
    assert gaps["none"] == pytest.approx(0.2)           # 0.8 - 1.0


def test_readers(view):
    work = {"frames": 1000, "chain_bytes": 3.35e9}
    read = {m: R.reader(m)(view, work) for m in (
        "amv.device_idle", "act.copy_share.library_decode",
        "g729.G_us_per_frame.one_file", "g729.G_roofline.library_decode",
        "amv.chain_roofline")}
    assert read["amv.device_idle"] == pytest.approx(35.0)
    assert read["act.copy_share.library_decode"] == pytest.approx(10.0)
    assert read["g729.G_us_per_frame.one_file"] == pytest.approx(400.0)
    want = roofline.bound_s(roofline.g729a_decode_ops(1000),
                            roofline.g729a_decode_bytes(1000)) / 0.4
    assert read["g729.G_roofline.library_decode"] == \
        pytest.approx(100 * want)
    assert read["amv.chain_roofline"] == pytest.approx(100 * 1e-3 / 0.5)


def test_a_reader_with_nothing_to_read_returns_nothing():
    empty = tr.TraceView(window_s=1.0)
    for m in ("g729.G_roofline.library_decode", "amv.chain_roofline",
              "g729.G_us_per_frame.one_file",
              "act.copy_share.library_decode"):
        assert R.reader(m)(empty, {"frames": 10, "chain_bytes": 1.0}) is None


def test_two_windows_are_refused():
    path = _trace([ev("user_annotation", "pb.window", 0, 10),
                   ev("user_annotation", "pb.window", 20, 10)])
    try:
        with pytest.raises(RuntimeError):
            tr.parse_chrome_trace(path)
    finally:
        os.remove(path)


def test_g729_decode_work():
    assert roofline.g729a_decode_ops(1) == 13482
    assert roofline.g729a_decode_bytes(2) == 340
