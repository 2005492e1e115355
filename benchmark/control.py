"""The comparison's control: the reference put in the program's place with
one step taken that would tempt a later change, held against the reference
exactly as a run holds the program. It has to come out as not correct.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

The control is found by name: a configuration's file may name one under
`control`, whose `reference_gops` is in `benchmark/controls/<name>.py`;
without one it is `bfloat16`, the reference computed in the precision
below the float32 the configurations state. For each seed it makes the
cell's frame pool, draws the segments and GOPs a run's comparison would
(the first `check_segments` segments of the window's offsets, and the
seeded GOPs of each), and prints one JSON line with the numbers a run
compares, beside their limits, and whether they pass. No window is
needed: the program is not run. The benchmark's own runs never run this.
"""

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DEFAULT = "bfloat16"


def control(root, config: dict):
    """The `reference_gops` of the control the configuration names."""
    name = config.get("control", DEFAULT)
    path = Path(root) / "benchmark" / "controls" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_control_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.reference_gops


def readings(root, name: str, seed: int, device) -> dict:
    from benchmark.harness import check, frames, manifest, traffic
    cell = manifest.Cell(root, name)
    config, mix = cell.config, cell.mix
    seed = seed % (1 << 64)
    gop_len = len(config["codec"]["gop_pattern"])
    seg = traffic.segment_frames(mix, gop_len, config["gop_batch"])
    pool = frames.frame_pool(seed, traffic.POOL_FRAMES, config["height"],
                             config["width"], device)
    offs = traffic.offsets(seed, traffic.WINDOW, len(pool), seg)
    kept = [next(offs) for _ in range(mix["check_segments"])]
    picks = check.draw(seed, kept, mix["check_gops_per_segment"],
                       seg // gop_len)
    starts = [o + g * gop_len for o, gops in zip(kept, picks) for g in gops]
    want, want_frames = check.reference_gops(pool, starts, gop_len, config,
                                             device)
    got, got_frames = control(root, config)(pool, starts, gop_len, config,
                                            device)
    values = dict(stream_mismatch=sum(check.mismatch(g, w)
                                      for g, w in zip(got, want)),
                  frames_mismatch=int((got_frames != want_frames).sum()))
    checks = {k: {"value": v, "limit": check.LIMITS[k]}
              for k, v in values.items()}
    return dict(workload=name, seed=seed,
                control=config.get("control", DEFAULT), gops=len(starts),
                correct=check.passed(checks, len(starts)), **values,
                checks=checks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t = time.perf_counter()
        r = readings(ROOT, args.workload, seed, "cuda")
        r.update(seconds=time.perf_counter() - t,
                 card=torch.cuda.get_device_name(0))
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
