"""The harness is driven by data: a cell, a configuration, a mix and a
per-layer metric written as files and manifest entries into a copy of the
benchmark are found and run, at a tiny size on the CPU, with no edit to
`run.py` or the harness."""

import json

from conftest import add_allintra_cell, run_cell

import control  # benchmark/control.py

NEW_METRIC = '''"""Segments completed in the window."""


def read(rec):
    return float(len(rec.latency))
'''


def _add_everything(root):
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "benchmark/configs/rgb444_720p_lowdelay.json")
                     .read_text())
    cfg.update(name="tiny_ipbp", height=32, width=64,
               codec=dict(cfg["codec"], gop_pattern=["I", "B", "P"],
                          quality_factor=75.0))
    (root / "benchmark/configs/tiny_ipbp.json").write_text(json.dumps(cfg))
    mix = {"segment": {"unit": "gop", "min_video_seconds": 0.2},
           "check_segments": 2, "check_gops_per_segment": 1}
    (root / "benchmark/traffic/short_clips.json").write_text(json.dumps(mix))
    (root / "benchmark/metrics/segments_done.py").write_text(NEW_METRIC)
    manifest["configs"].append(dict(
        name="tiny_ipbp", source="a test", file="benchmark/configs/"
        "tiny_ipbp.json", reduced=[], why="a test"))
    manifest["workloads"].append(dict(
        name="tiny_ipbp.short_clips", config="tiny_ipbp",
        traffic="short_clips", chips=1, why="a test"))
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny_ipbp.short_clips")
    manifest["per_layer"].append(dict(
        name="segments_done", unit="segments", better="higher",
        source="host_clock", layer="encode orchestration", moves="fps",
        workloads=["tiny_ipbp.short_clips"]))
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))


def test_a_new_cell_config_mix_and_metric_run_from_files(tiny_root):
    run_py = (tiny_root / "benchmark/run.py").read_bytes()
    _add_everything(tiny_root)
    name = "tiny_ipbp.short_clips"
    plain = run_cell(tiny_root, name)
    # two sampled segments, one GOP each, once the window holds two
    assert plain["correct"]
    assert plain["gops_compared"] == min(2, plain["attempted"])
    assert set(plain["metrics"]) == {"fps", "setup_s"}
    traced = run_cell(tiny_root, name, trace=1)
    assert traced["correct"]
    done = traced["metrics"]["segments_done"]
    assert done["unit"] == "segments" and done["value"] >= 1
    # segments of 6 frames: two GOPs of I, B, P hold 0.2 s of 25 fps video
    assert traced["metrics"]["encoder_ms_per_frame"]["value"] > 0
    assert (tiny_root / "benchmark/run.py").read_bytes() == run_py


def test_an_all_intra_cell_runs_from_files(tiny_root):
    code = [tiny_root / "benchmark/run.py", tiny_root / "benchmark/control.py",
            *sorted((tiny_root / "benchmark/harness").glob("*.py")),
            *sorted((tiny_root / "benchmark/controls").glob("*.py"))]
    before = [p.read_bytes() for p in code]
    name = add_allintra_cell(tiny_root)
    # a segment is one batch of 8 I-frames, every GOP of it compared
    plain = run_cell(tiny_root, name)
    assert plain["correct"] and plain["gops_compared"] == 8
    assert set(plain["metrics"]) == {"fps", "setup_s"}
    traced = run_cell(tiny_root, name, trace=1)
    assert traced["correct"] and traced["gops_compared"] == 8
    assert traced["metrics"]["encoder_ms_per_frame"]["value"] > 0
    # the control its configuration names is found by file, and fails
    ctl = control.readings(tiny_root, name, 2**33 + 1, "cpu")
    assert ctl["control"] == "open_loop_intra" and ctl["gops"] == 8
    assert not ctl["correct"]
    assert [p.read_bytes() for p in code] == before


def test_every_cell_of_the_manifest_runs_on_the_cpu(tiny_root):
    manifest = json.loads((tiny_root / "BENCHMARK.json").read_text())
    for w in manifest["workloads"]:
        r = run_cell(tiny_root, w["name"], seconds=0.2)
        assert r["correct"], (w["name"], r)
        # a metric read from the device's trace has nothing to read on the
        # CPU, and is left out
        wanted = {m["name"] for m in manifest["end_to_end"]
                  if w["name"] in m.get("workloads", [w["name"]])
                  and m["source"] != "device_trace"}
        assert set(r["metrics"]) == wanted
        assert list(r)[-1] == "checks"
