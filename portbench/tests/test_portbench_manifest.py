"""BENCHMARK.json against the benchmark's contract: keys, names, units,
lengths, files, and what each cell reports."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    B = json.load(f)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(B["paths"]) <= 16
    for p in B["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
        assert not p.endswith("_torch")
    assert len(B["command"]) <= 32 and all(line(w) for w in B["command"])
    for w in B["command"][1:]:
        assert not w.startswith("/") and ".." not in w
        if "/" in w:
            assert any(w.startswith(p + "/") for p in B["paths"])


def test_run_seconds_fits_a_check_of_24_cells():
    rs = B["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", B["configs"], ids=lambda e: e["name"])
def test_configs(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and line(entry["source"])
    assert line(entry["why"]) and len(entry["reduced"]) <= 16
    assert all(NAME.match(k) for k in entry["reduced"])
    assert any(entry["file"].startswith(p + "/") for p in B["paths"])
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert any(w["config"] == entry["name"] for w in B["workloads"])
    assert len({c["file"] for c in B["configs"]}) == len(B["configs"])


@pytest.mark.parametrize("cell", B["workloads"], ids=lambda e: e["name"])
def test_cells(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and line(cell["why"])
    assert cell["config"] in {c["name"] for c in B["configs"]}
    with open(os.path.join(ROOT, "portbench", "traffic",
                           f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    assert os.path.exists(os.path.join(ROOT, "portbench", "drivers",
                                       f"{traffic['driver']}.py"))
    e2e = [m["name"] for m in B["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in B["per_layer"] if cell["name"] in m.get(
        "workloads", [cell["name"]] if m["moves"] in e2e else [])]
    assert layer
    for m in layer:
        assert m["moves"] in e2e


def test_cells_are_distinct_and_few_take_four_chips():
    cells = B["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({c["name"] for c in cells}) == len(cells)
    assert len({(c["config"], c["traffic"]) for c in cells}) == len(cells)
    assert sum(c["chips"] == 4 for c in cells) <= max(1, len(cells) // 4)


@pytest.mark.parametrize("m", B["end_to_end"], ids=lambda e: e["name"])
def test_end_to_end_metrics(m):
    assert set(m) <= {"name", "unit", "better", "bound", "source",
                      "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    cells = {c["name"] for c in B["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("m", B["per_layer"], ids=lambda e: e["name"])
def test_per_layer_metrics(m):
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and line(m["layer"])
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    assert m["moves"] in {e["name"] for e in B["end_to_end"]}
    assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                       f"{m['name']}.py"))
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"


def test_names_unique_across_metrics():
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    assert next(m for m in B["end_to_end"]
                if m["name"] == "setup_s")["bound"] <= 0.25
