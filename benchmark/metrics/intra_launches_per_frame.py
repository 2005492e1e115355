"""K5 launches a frame in the profiled sub-window: the program's count
`intra_launches`, one a launch of the closed-loop lossy intra encode, over
the recording's frames. A batch of all-intra 4:2:0 GOPs launches K5 twice
(its luma planes, then its chroma planes), so a segment of 8 reads 0.25.
None where the program counts no launch (it has no such counter)."""

from benchmark.harness import program_spans

COUNT = "intra_launches"


def read(rec):
    if not any(COUNT in s.counts for s in program_spans.recording()):
        return None
    return program_spans.count_per_frame(COUNT)
