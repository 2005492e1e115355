"""Shared set-up of the benchmark's own tests (run them with
`python -m pytest benchmark/tests -p no:cacheprovider`; those marked
`card` need a CUDA card and skip without one).

`tiny_root` is a copy of the benchmark (its folder and `BENCHMARK.json`)
in a temporary directory whose configurations are cut to 32 x 48 frames,
so that a run of any cell ends in seconds on the CPU through the
program's plain versions."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for _p in (REPO, REPO / "benchmark"):          # the package, control.py
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

TINY_H, TINY_W = 32, 48


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one")


def needs_card():
    """Skip the calling test unless a CUDA card is present (decided when
    the test runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def shrink(root: Path) -> None:
    """Cut the configurations under `root` to the tiny size."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    for c in manifest["configs"]:
        path = root / c["file"]
        cfg = json.loads(path.read_text())
        cfg["height"], cfg["width"] = TINY_H, TINY_W
        path.write_text(json.dumps(cfg))


def add_cell(root: Path, config: str, traffic: str) -> str:
    """Add the cell of `config` under `traffic` to the manifest under
    `root`, as a later PR would, unless it is there -> its name."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    name = f"{config}.{traffic}"
    if all(w["name"] != name for w in manifest["workloads"]):
        manifest["workloads"].append(dict(name=name, config=config,
                                          traffic=traffic, chips=1,
                                          why="a test"))
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            if "workloads" in m:
                m["workloads"].append(name)
        (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return name


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shrink(tmp_path)
    return tmp_path


def run_cell(root: Path, name: str, seed: int = 2**31 + 11,
             seconds: float = 0.5, trace: int = 0) -> dict:
    """A whole run of `name` on the CPU through the copy's own `run.py`
    (its look for a card skipped) -> the result line it prints."""
    import contextlib
    import importlib.util
    import io
    spec = importlib.util.spec_from_file_location(
        "benchmark_run_under_test", root / "benchmark" / "run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = module.main(["--workload", name, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", str(trace)],
                         device="cpu")
    assert rc == 0, out.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])
