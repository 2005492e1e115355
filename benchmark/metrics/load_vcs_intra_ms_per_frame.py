"""Milliseconds a frame of the program's span `load_vcs.intra` in the
profiled sub-window: the loader's phase 3, the I-frames' upload, their
decode by K6 and the read-back to host memory."""

from benchmark.harness import program_spans


def read(rec):
    return program_spans.span_ms_per_frame("load_vcs.intra")
