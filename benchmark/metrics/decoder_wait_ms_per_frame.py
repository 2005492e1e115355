"""Milliseconds a frame of the program's span `decode.wait` in the
profiled sub-window: the decoder's host blocked on the device's decode and
the download of the decoded frames."""

from benchmark.harness import program_spans


def read(rec):
    return program_spans.span_ms_per_frame("decode.wait")
