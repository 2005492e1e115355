"""One measure for every stage of the stage tools (`profile_stages`,
`exp_720_stages`).

A stage is a function `fn(it)` of the iteration number. The JAX tools ran
N iterations in one jitted `fori_loop`, so their wall time per iteration
was the TPU's device time. In eager PyTorch the two differ, so a stage gets
three numbers:

* `ms`: wall time per iteration, as the JAX tools defined it: one warm
  iteration, then N on the host clock, ended by `torch.cuda.synchronize()`;
* `device_ms`: the device's time for the same N iterations run again,
  over N (`queued_device_ms`): CUDA events around each iteration, queued
  behind a device-side wait long enough that the host has queued the
  whole iteration before the device starts it. The device then never
  waits for the host inside an iteration, so the events' time is the
  device's work (with the microsecond or so between queued kernels) and
  not the host's. (Not torch.profiler: on an H100 it loses kernel
  records once a process has run for some seconds, and then reads only
  a part of the device time.)
* `launches`: the kernels' launch counters (the `LAUNCHES` dicts of
  `ops/motion_cuda.py`, `ops/inter_cuda.py`, `ops/intra_cuda.py`) gained
  over the N timed iterations, per iteration, the nonzero ones.

On the CPU (the plain versions) only `ms` is measured; `device_ms` and
`launches` are None.

The JAX tools rolled their inputs inside the loop so that XLA could not
hoist a loop-invariant body, and summed every output so that it could not
drop the work. Eager PyTorch does neither, so the inputs are rolled before
the window (`rolled`) and each iteration's outputs are kept alive until
the iteration ends, with no reductions added.
"""

from __future__ import annotations

import json
import time

import torch

ROLLS = 8          # iteration `it` takes the copy rolled by `it & 7`
QUEUE_ATTEMPTS = 3
HOLD_HZ = 2.0e9    # cycles a second of torch.cuda._sleep: at or above the
                   # SM clock, so that a hold lasts at least its seconds


def rolled(x: torch.Tensor, n: int = ROLLS, dim: int = -1) -> list:
    """The n copies of x rolled by 0 .. n-1 along `dim`, each contiguous."""
    return [torch.roll(x, k, dims=dim).contiguous() for k in range(n)]


def counters() -> tuple:
    from vcs_h264_tpu_torch.ops import inter_cuda, intra_cuda, motion_cuda
    return (motion_cuda.LAUNCHES, inter_cuda.LAUNCHES, intra_cuda.LAUNCHES)


def launch_counts() -> dict:
    return {k: v for c in counters() for k, v in c.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def hold_seconds(host_ms: float, attempt: int) -> float:
    """How long the device waits before an iteration: twice the host time
    of one iteration plus 5 ms, four times longer at each new attempt."""
    return (2 * host_ms / 1e3 + 0.005) * 4 ** attempt


def queued_device_ms(fn, iters: int, device: torch.device,
                     host_ms: float) -> float:
    """The device time of `iters` iterations of `fn`, each queued whole
    before the device starts it, per iteration. Before each iteration the
    device waits (torch.cuda._sleep) while the host queues it; if the
    iteration's start event has completed by the time the host has queued
    the iteration, the host fell behind the device (a host sync, a full
    launch queue) and the iterations are timed again with longer waits, up
    to QUEUE_ATTEMPTS times, and then it raises."""
    for attempt in range(QUEUE_ATTEMPTS):
        hold = int(hold_seconds(host_ms, attempt) * HOLD_HZ)
        windows, ahead = [], True
        for it in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(hold)
            start.record()
            out = fn(it)
            end.record()
            ahead = ahead and not start.query()
            windows.append((start, end))
            del out
        _sync(device)
        if ahead:
            return sum(s.elapsed_time(e) for s, e in windows) / iters
    raise RuntimeError(f"the device reached an iteration before the host "
                       f"had queued it, in each of {QUEUE_ATTEMPTS} attempts")


def measure(fn, iters: int, device: torch.device) -> dict:
    """-> {"ms", "device_ms", "launches"} of the stage `fn` (see above)."""
    if iters < 1:
        raise ValueError("iters must be >= 1")
    fn(0)
    _sync(device)
    before = launch_counts()
    t0 = time.perf_counter()
    for it in range(iters):
        out = fn(it)
    _sync(device)
    ms = (time.perf_counter() - t0) / iters * 1e3
    del out
    if device.type != "cuda":
        return {"ms": ms, "device_ms": None, "launches": None}
    after = launch_counts()
    launches = {k: (after[k] - before[k]) / iters for k in after
                if after[k] != before[k]}
    launches = {k: int(v) if v == int(v) else v for k, v in launches.items()}
    return {"ms": ms, "device_ms": queued_device_ms(fn, iters, device, ms),
            "launches": launches}


def run_stages(tool: str, stages: dict, iters: int, device: torch.device,
               arr, source: str, line: str) -> dict:
    """Measure every stage of `stages` on the frames `arr` [N, 3, H, W],
    printing the JAX tool's `line` (a format of name, ms and n) per stage,
    then one JSON line of the results, which it returns."""
    n = len(arr)
    results = {}
    for name, fn in stages.items():
        results[name] = r = measure(fn, iters, device)
        print(line.format(name=name, ms=r["ms"], n=n), flush=True)
    out = {"tool": tool, "device": device_name(device),
           "res": f"{arr.shape[-1]}x{arr.shape[-2]}", "frames": n,
           "iters": iters, "source": source, "stages": results}
    print(json.dumps(out), flush=True)
    return out


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
