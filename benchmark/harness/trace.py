"""The profiled sub-window of a traced run: a few whole segments under
`torch.profiler` (host and device), its Chrome trace read back into device
intervals and host spans, and the check that the trace holds every kernel
launch the program counted.

The program counts the launches of each of its kernels where it launches
them (`LAUNCHES` in `vcs_h264_tpu_torch/ops/{motion,inter,intra}_cuda.py`).
torch.profiler has been seen to drop kernel records in long processes, so
the sub-window runs early in a fresh process, and a trace that lacks a
counted launch is taken again, up to ATTEMPTS times, and then fails the
run: no device share or roofline is read from it.
"""

from __future__ import annotations

import json
import os

import torch

ATTEMPTS = 3
WINDOW_SPAN = "benchmark.subwindow"
# kernel-name fragment -> the program's counters of the calls that launch
# one such kernel each. A `benchmark` change repoints these when the
# program renames or fuses its kernels.
KERNEL_COUNTERS = {
    "sad_search_": ("motion_cuda.sad_search",),
    "compensate": ("motion_cuda.compensate",),
    "fused_p_encode_kernel": ("inter_cuda.fused_p_encode",),
    "fused_p_decode_kernel": ("inter_cuda.fused_p_decode",),
    "plane_encode_kernel": ("inter_cuda.plane_encode",
                            "inter_cuda.c420_encode"),
    "plane_decode_kernel": ("inter_cuda.plane_decode",
                            "inter_cuda.c420_decode"),
    "intra_encode_kernel": ("intra_cuda.intra_encode",),
    "intra_decode_": ("intra_cuda.intra_decode",),
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host spans that name an idle gap: the benchmark's own step spans and the
# program's record_function spans
HOST_SPANS = ("benchmark.encode", "benchmark.save_vcs", "benchmark.load_vcs",
              "benchmark.decode", "intra_i_encode", "encode_gop_batch",
              "encode_gop_batch_420")


def counters() -> dict:
    from vcs_h264_tpu_torch.ops import inter_cuda, intra_cuda, motion_cuda
    mods = dict(motion_cuda=motion_cuda, inter_cuda=inter_cuda,
                intra_cuda=intra_cuda)
    return {f"{m}.{k}": v for m, mod in mods.items()
            for k, v in mod.LAUNCHES.items()}


class Trace:
    """Device intervals and host spans of one profiled sub-window, in
    seconds on the trace's clock."""

    def __init__(self, events: list):
        win = [e for e in events if e.get("name") == WINDOW_SPAN
               and e.get("cat") == "user_annotation"]
        if len(win) != 1:
            raise RuntimeError(f"the trace holds {len(win)} {WINDOW_SPAN} "
                               "spans, not 1")
        self.t0 = win[0]["ts"] * 1e-6
        self.t1 = self.t0 + win[0]["dur"] * 1e-6
        self.device = []            # (start, end, name, category)
        self.spans = []             # (start, end, name)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            s, d = e["ts"] * 1e-6, e["dur"] * 1e-6
            if e.get("cat") in DEVICE_CATS:
                lo, hi = max(s, self.t0), min(s + d, self.t1)
                if hi > lo:
                    self.device.append((lo, hi, e["name"], e["cat"]))
            elif e.get("cat") == "user_annotation" and e["name"] in HOST_SPANS:
                self.spans.append((s, s + d, e["name"]))
        self.device.sort()

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> list:
        """The union of the device intervals, sorted [(start, end)]."""
        out = []
        for s, e, _, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def kernel_count(self, fragment: str) -> int:
        return sum(1 for _, _, n, c in self.device
                   if c == "kernel" and fragment in n)

    def kernel_seconds(self, fragments) -> float:
        return sum(e - s for s, e, n, c in self.device
                   if c == "kernel" and any(f in n for f in fragments))

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the device's
        idle time summed by the innermost host span it fell in (each idle
        stretch cut at the spans' edges), the ten largest."""
        ops = {}
        for s, e, n, _ in self.device:
            ops[n] = ops.get(n, 0.0) + (e - s)
        gaps = {}
        edges = [self.t0] + [x for iv in self.busy() for x in iv] + [self.t1]
        for lo, hi in zip(edges[0::2], edges[1::2]):
            cuts = sorted({lo, hi} | {x for s, e, _ in self.spans
                                      for x in (s, e) if lo < x < hi})
            for a, b in zip(cuts, cuts[1:]):
                mid = 0.5 * (a + b)
                inside = [(e - s, n) for s, e, n in self.spans
                          if s <= mid < e]
                name = min(inside)[1] if inside else "outside the step spans"
                gaps[name] = gaps.get(name, 0.0) + (b - a)

        def top(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                    ][:10]

        return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def missing_launches(trace: Trace, before: dict, after: dict) -> list:
    """Kernel families whose counted launches the trace lacks."""
    out = []
    for fragment, names in KERNEL_COUNTERS.items():
        counted = sum(after[n] - before[n] for n in names)
        seen = trace.kernel_count(fragment)
        if seen != counted:
            out.append(f"{fragment}: counted {counted}, traced {seen}")
    return out


def profile(run_segments, workdir: str) -> Trace:
    """Run `run_segments()` (whole segments, each step under its
    record_function span) under the profiler -> its Trace, once the trace
    holds every launch counted over it."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    path = os.path.join(workdir, "subwindow.trace.json")
    problems = []
    for _ in range(ATTEMPTS):
        before = counters()
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW_SPAN):
                run_segments()
                torch.cuda.synchronize()
        after = counters()
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        os.remove(path)
        trace = Trace(events)
        problems = missing_launches(trace, before, after)
        if not problems:
            return trace
    raise RuntimeError("the profiler trace lacks counted kernel launches in "
                       f"{ATTEMPTS} attempts: {'; '.join(problems)}")
