"""Milliseconds a frame of the program's span `save_vcs.pull` in the
profiled sub-window: the stream's copy from the device to host memory
inside save_vcs, one copy a tensor field."""

from benchmark.harness import program_spans


def read(rec):
    return program_spans.span_ms_per_frame("save_vcs.pull")
