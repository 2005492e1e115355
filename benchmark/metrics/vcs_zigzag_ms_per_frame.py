"""Milliseconds a frame of the program's spans `vcs.zigzag` in the
profiled sub-window: the zigzag scans of coefficient planes in save_vcs and
their inverse in load_vcs, summed over the threads that ran them."""

from benchmark.harness import program_spans


def read(rec):
    return program_spans.span_ms_per_frame("vcs.zigzag")
