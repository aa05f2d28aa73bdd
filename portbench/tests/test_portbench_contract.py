"""BENCHMARK.json against the benchmark contract, and every file the
harness finds by name present."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(line(w) for w in BENCH["command"])
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_configs():
    names = [c["name"] for c in BENCH["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["why"]) and line(c["source"])
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert k in cfg  # the key is in the file, beside its source
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_workloads():
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    configs = {c["name"] for c in BENCH["configs"]}
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4) and line(w["why"])
        for part in (("traffic", f"{w['traffic']}.json"),
                     ("limits", f"{w['name']}.json")):
            assert os.path.exists(os.path.join(ROOT, "portbench", *part))
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


def cells_of(metric):
    return metric.get("workloads", [w["name"] for w in BENCH["workloads"]])


def test_metrics():
    e2e, per = BENCH["end_to_end"], BENCH["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(per) <= 128
    names = [m["name"] for m in e2e + per]
    assert len(set(names)) == len(names)
    assert "setup_s" in names
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in per:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"])
        moved = next(x for x in e2e if x["name"] == m["moves"])
        assert set(cells_of(m)) <= set(cells_of(moved))
    for m in e2e + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(cells_of(m)) <= cells
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                           f"{m['name']}.py"))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_layer_names_agree():
    """Metrics of one layer give it the same name."""
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"], []).append(m["name"])
    assert all(by_layer.values())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_enough(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"] if cell in cells_of(m)]
    per = [m["name"] for m in BENCH["per_layer"] if cell in cells_of(m)]
    assert "setup_s" in e2e and len(e2e) >= 2 and per


def test_run_seconds_fit_the_check():
    """A full check of 24 cells fits its 43,200 s."""
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
