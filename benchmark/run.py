"""Run one cell of the benchmark once and print its result as the last line
of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the `vcs_h264_tpu_torch` package,
on a machine with as many CUDA cards as the cell asks for. With
`--trace 0` the result holds the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics. Every number compared with the
reference is printed beside its limit, last on standard error and last in
the result. The run exits with a nonzero code, and prints no result,
without the cards, or when JAX, Flax or the JAX package `vcs_h264_tpu` is
loaded in the process once the window has closed.
"""

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def process_start() -> float:
    """The process's start on the perf_counter clock (from its start time in
    /proc, in clock ticks since boot), or this module's import where /proc
    does not say."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - ticks / os.sysconf("SC_CLK_TCK"))
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError, AttributeError):
        return _T_IMPORT


def main(argv=None, device: str = "cuda") -> int:
    """`device`: "cuda" for every run; the tests pass "cpu", which skips
    the look for cards and drives the rest of a run on the CPU."""
    t0 = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import cell, manifest
    chips = manifest.Cell(ROOT, args.workload).workload["chips"]
    import torch
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    result = cell.run(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), device, t0)
    banned = cell.banned_modules()
    if banned:
        print(f"loaded in this process: {', '.join(banned)}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
