"""What the benchmark loads: a cell run on the CPU loads nothing whose
top-level module name is `jax`, `jaxlib`, `flax` or `vcs_h264_tpu` (the
port, `vcs_h264_tpu_torch`, is another name), and the reference loads
nothing of the port. Each runs in a fresh interpreter, so that nothing
this test process loaded counts."""

import ast
import json
import subprocess
import sys

from conftest import REPO

BANNED = ("jax", "jaxlib", "flax", "vcs_h264_tpu")


def _fresh(code: str, cwd) -> list:
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, check=True,
                         capture_output=True, text=True, timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_cell_run_loads_no_jax(tiny_root):
    code = f"""
import contextlib, io, json, sys
sys.path.insert(0, {str(REPO)!r})
sys.path.insert(0, {str(tiny_root / 'benchmark')!r})
import run
with contextlib.redirect_stdout(io.StringIO()):
    rc = run.main(["--workload", "rgb444_720p_lowdelay.live", "--seed",
                   "3000000001", "--seconds", "0.2", "--trace", "0"],
                  device="cpu")
assert rc == 0
print(json.dumps(sorted(sys.modules)))
"""
    mods = _fresh(code, tiny_root)
    assert "vcs_h264_tpu_torch" in mods
    assert not [m for m in mods if m.split(".")[0] in BANNED]


def test_the_reference_loads_nothing_of_the_program(tiny_root):
    code = f"""
import json, sys
sys.path.insert(0, {str(tiny_root)!r})
import numpy as np
from benchmark.harness import check, frames
config = json.load(open("benchmark/configs/c420_1080p_randomaccess.json"))
pool = frames.frame_pool(1, 7, config["height"], config["width"], "cpu")
check.reference_gops(pool, [0], 7, config, "cpu")
print(json.dumps(sorted(sys.modules)))
"""
    mods = _fresh(code, tiny_root)
    assert "benchmark.reference.codec" in mods
    assert not [m for m in mods if m.split(".")[0] in BANNED
                or m.split(".")[0] == "vcs_h264_tpu_torch"]


def test_the_reference_sources_import_nothing_of_the_program():
    for path in (REPO / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in (*BANNED,
                                               "vcs_h264_tpu_torch"), path
