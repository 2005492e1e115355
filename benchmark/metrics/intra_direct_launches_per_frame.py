"""K5 launches a frame in the direct form in the profiled sub-window: the
program's count `intra_direct_launches`, one a launch of the closed-loop
lossy intra encode on planes too tall for its staged forms, which loads and
stores on the wavefront's chain, over the recording's frames. 0.0 where
every launch is staged. None where the program counts no such launch (it
has no such counter)."""

from benchmark.harness import program_spans

COUNT = "intra_direct_launches"


def read(rec):
    if not any(COUNT in s.counts for s in program_spans.recording()):
        return None
    return program_spans.count_per_frame(COUNT)
