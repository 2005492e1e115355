"""Milliseconds a frame of the program's spans `vcs.rc_decode` in the
profiled sub-window: every call of the .vcs range coder's decoders (the C++
coder through its wrappers), summed over the threads that ran them."""

from benchmark.harness import program_spans


def read(rec):
    return program_spans.span_ms_per_frame("vcs.rc_decode")
