"""Milliseconds a frame of the program's span `encode.intra_batch` in the
profiled sub-window: the encoder's batched stage of GOPs of an I-frame
alone (the batch's upload, 4:2:0 ingest and lossy intra launches, queued
on the device). None where the program records no such span."""

from benchmark.harness import program_spans

SPAN = "encode.intra_batch"


def read(rec):
    if not any(s.name == SPAN for s in program_spans.recording()):
        return None
    return program_spans.span_ms_per_frame(SPAN)
