"""`BENCHMARK.json` keeps to the form its checker takes: its keys, names,
units and lengths, every cell's files and metric readers present, every
configuration used, every cell reporting `setup_s`, another end-to-end
metric and a per-layer metric, and each per-layer metric moving an
end-to-end metric of the cells it lists."""

import json
import re

import pytest

from conftest import REPO

M = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["benchmark"] and len(M["command"]) <= 32
    assert all(_line(w) for w in M["command"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs():
    used = {w["config"] for w in M["workloads"]}
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/")
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])


def test_workloads():
    names = [w["name"] for w in M["workloads"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    pairs = {(w["config"], w["traffic"]) for w in M["workloads"]}
    assert len(pairs) == len(names)
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (REPO / "benchmark/traffic" / f"{w['traffic']}.json").exists()


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    cells = {w["name"] for w in M["workloads"]}
    e2e = {m["name"] for m in M["end_to_end"]}
    keys = ({"name", "unit", "better", "bound", "source"} if kind ==
            "end_to_end" else {"name", "unit", "better", "source", "layer",
                               "moves"})
    for m in M[kind]:
        assert set(m) - {"workloads"} == keys
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (REPO / "benchmark/metrics" / f"{m['name']}.py").exists()
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert _line(m["layer"]) and m["moves"] in e2e
    if kind == "end_to_end":
        assert any(m["name"] == "setup_s" for m in M[kind])


def test_every_cell_reports_enough():
    for w in M["workloads"]:
        def has(m):
            return w["name"] in m.get("workloads", [w["name"]])
        e2e = {m["name"] for m in M["end_to_end"] if has(m)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in M["per_layer"] if has(m)]
        assert layer and all(m["moves"] in e2e for m in layer)
