"""Copies from the device to host memory a frame in the profiled
sub-window, as the program counts them where it makes them (`d2h_copies`
on its spans: the stream's pull in save_vcs, the I-frames' read-back in
load_vcs, the decoder's downloads); None unless the sub-window's trace
holds as many copies a segment."""

from benchmark.harness import program_spans


def read(rec):
    if not program_spans.copies_traced(rec):
        return None
    return program_spans.count_per_frame("d2h_copies")
