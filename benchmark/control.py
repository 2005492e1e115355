"""The comparison's control: the reference put in the program's place and
computed in bfloat16, the precision below the float32 the configurations
state, held against the float32 reference exactly as a run holds the
program. It has to come out as not correct.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it makes the cell's frame pool, draws the segments and GOPs
a run's comparison would (the first `check_segments` segments of the
window's offsets, and the seeded GOPs of each), and prints one JSON line
with the numbers a run compares: the bfloat16 reference's stream fields
and decoded frames against the float32 reference's. No window is needed:
the program is not run. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(root, name: str, seed: int, device) -> dict:
    import torch
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
    got, got_frames = check.reference_gops(pool, starts, gop_len, config,
                                           device, ftype=torch.bfloat16)
    return dict(workload=name, seed=seed, gops=len(starts),
                stream_mismatch=sum(check.mismatch(g, w)
                                    for g, w in zip(got, want)),
                frames_mismatch=int((got_frames != want_frames).sum()))


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
