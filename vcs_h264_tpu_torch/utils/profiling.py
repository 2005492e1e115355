"""Tracing and profiling hooks (counterpart of
`vcs_h264_tpu/utils/profiling.py`): named ranges in the profiler's
timeline, a trace of the enclosed block written to a directory, and a
wall-clock timer per encode stage whose results feed the JSONL metrics
stream."""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict

import torch


@contextlib.contextmanager
def trace_annotation(name: str):
    """Named range in the profiler's timeline."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the enclosed block (host activity, and the GPU's when one is
    present) and write its trace into `logdir` on exit, as a
    `*.pt.trace.json` file that TensorBoard and Perfetto read."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


def _holds_cuda(obj) -> bool:
    """Whether a stage's result (a tensor, a dataclass, a tuple, list or
    dict of them) holds a CUDA tensor."""
    if torch.is_tensor(obj):
        return obj.is_cuda
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    elif isinstance(obj, dict):
        obj = obj.values()
    elif not isinstance(obj, (list, tuple)):
        return False
    return any(_holds_cuda(v) for v in obj)


class StageTimer:
    """Accumulating wall-clock timer per pipeline stage.

    Waits for the device at stage exit when the stage's result holds CUDA
    tensors, so that the number means something (kernels are queued, and
    their time would otherwise fall to the first later sync)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            if _holds_cuda(box.get("result", result)):
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, dict]:
        return {k: {"total_s": v, "calls": self.counts[k],
                    "mean_ms": 1e3 * v / self.counts[k]}
                for k, v in self.totals.items()}
