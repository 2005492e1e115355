"""Megabytes (1e6 bytes) copied from the device to host memory a frame in
the profiled sub-window, as the program counts them where it makes them
(`d2h_bytes` on its spans); None unless the sub-window's trace holds as
many copies a segment as the program counted."""

from benchmark.harness import program_spans


def read(rec):
    if not program_spans.copies_traced(rec):
        return None
    return program_spans.count_per_frame("d2h_bytes") / 1e6
