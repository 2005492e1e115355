"""Tracing and profiling hooks (counterpart of
`vcs_h264_tpu/utils/profiling.py`): the program's span, which names a range
in the profiler's timeline and keeps a record of it; a trace of the
enclosed block written to a directory; and a wall-clock timer per encode
stage whose results feed the JSONL metrics stream.

Spans are recorded only while a torch profiler records on the thread that
opens them (`torch.profiler.profile`, `emit_nvtx`, the CLI's
`--trace_dir`), or in a task that `carry` hands to another thread from
such a thread. Otherwise a span costs one check: no profiler range is
opened and nothing is kept. A recorded span opens a
`torch.profiler.record_function` range, which puts it on the profiler's
timeline beside the kernels and copies it caused, and is appended, once
closed, to the process's recording (`recorded()`): its name, its length on
`time.perf_counter_ns` and its counts, which is what the benchmark's
readers sum. Nothing writes the recording anywhere; a reader takes it at
the end of a run.

The counts in use: `frames` on the `save_vcs` root, and `d2h_copies` and
`d2h_bytes` (tensors brought to host memory and their bytes) where the
copies are made.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading
import time
from typing import Dict, List

import torch


@dataclasses.dataclass(eq=False)
class Span:
    """One recorded span: its name, its length in nanoseconds and its
    counts."""

    name: str
    ns: int
    counts: Dict[str, int]


class _Local(threading.local):
    def __init__(self):
        self.open: List[Span] = []   # this thread's open spans, innermost last
        self.carried = False         # a task that `carry` handed over


_LOCAL = _Local()
_RECORDING: List[Span] = []


def recording() -> bool:
    """Whether a span opened on this thread now is recorded."""
    return _LOCAL.carried or torch._C._autograd._profiler_enabled()


# the span while nothing records
_OFF = contextlib.nullcontext()


class _Recorded:
    """A span being recorded."""

    __slots__ = ("span", "_range", "_t0")

    def __init__(self, name: str, counts: dict):
        self.span = Span(name, 0, counts)

    def __enter__(self):
        self._range = torch.profiler.record_function(self.span.name)
        self._range.__enter__()
        _LOCAL.open.append(self.span)
        self._t0 = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        self.span.ns = time.perf_counter_ns() - self._t0
        _LOCAL.open.pop()
        self._range.__exit__(*exc)
        _RECORDING.append(self.span)
        return False


def trace_annotation(name: str, **counts):
    """The program's span: a context manager that, while a profiler
    records, names a range in the profiler's timeline and records the span
    with `counts` (see the module's docstring). Entering it gives None."""
    if not recording():
        return _OFF
    return _Recorded(name, counts)


def traced(name: str):
    """Decorator: every call of the function runs under the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with trace_annotation(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def add_counts(**counts) -> None:
    """Add `counts` to the innermost span open on this thread, if one is
    recorded."""
    if _LOCAL.open:
        mine = _LOCAL.open[-1].counts
        for k, v in counts.items():
            mine[k] = mine.get(k, 0) + v


def carry(fn):
    """`fn` wrapped so that its spans are recorded on whatever thread runs
    it (a thread pool's, which a profiler does not record by default), if
    spans are recorded here; `fn` itself while nothing records."""
    if not recording():
        return fn

    @functools.wraps(fn)
    def task(*args, **kwargs):
        before, _LOCAL.carried = _LOCAL.carried, True
        try:
            return fn(*args, **kwargs)
        finally:
            _LOCAL.carried = before
    return task


def recorded() -> List[Span]:
    """The spans recorded so far, each once closed, in the order they
    closed."""
    return list(_RECORDING)


def clear() -> None:
    """Forget the recording."""
    _RECORDING.clear()


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
    """Accumulating wall-clock timer per pipeline stage, each stage under
    the program's span of its name.

    Waits for the device at stage exit when the stage's result holds CUDA
    tensors, so that the number means something (kernels are queued, and
    their time would otherwise fall to the first later sync)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        with trace_annotation(name):
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
