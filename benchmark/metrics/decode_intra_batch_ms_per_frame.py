"""Milliseconds a frame of the program's span `decode.intra_batch` in the
profiled sub-window: the decoder's batched emit of GOPs of an I-frame
alone (the stored planes' stack and upload, the 4:2:0 emit, the start of
the batch's one download). None where the program records no such
span."""

from benchmark.harness import program_spans

SPAN = "decode.intra_batch"


def read(rec):
    if not any(s.name == SPAN for s in program_spans.recording()):
        return None
    return program_spans.span_ms_per_frame(SPAN)
