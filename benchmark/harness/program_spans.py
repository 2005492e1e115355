"""The program's own spans and counters, per frame: what
`vcs_h264_tpu_torch.utils.profiling.recorded()` holds at the end of a run.

The program records its spans only while a torch profiler records, so in a
run of the benchmark the recording holds the profiled sub-window's segments
(each of its attempts, if the trace was taken again). Every segment is
saved once, so the frames of the recording are those of its `save_vcs`
roots. Without such a root (an untraced run, a run on the CPU, a program
that records no spans) a reader finds nothing: None.

The program counts its copies from the device to host memory by hand
(`d2h_copies`, `d2h_bytes`), where it makes them. `copies_traced` holds
that count against the sub-window's trace, the device's own record of its
copies, so that a copy the program makes and does not count shows as a
missing metric and not as a smaller one.
"""

from __future__ import annotations

from typing import Optional

# the trace's name of a copy from the device to host memory, pageable or
# pinned, and the benchmark's span of one segment's save_vcs
D2H_PREFIX = "Memcpy DtoH"
SEGMENT_SPAN = "benchmark.save_vcs"


def recording() -> list:
    """The program's recorded spans; none where it keeps no recording."""
    try:
        from vcs_h264_tpu_torch.utils.profiling import recorded
    except ImportError:
        return []
    return recorded()


def _frames(spans) -> int:
    return sum(s.counts.get("frames", 0) for s in spans
               if s.name == "save_vcs")


def span_ms_per_frame(name: str) -> Optional[float]:
    """Milliseconds of the spans `name`, summed over every thread, over the
    recording's frames."""
    spans = recording()
    frames = _frames(spans)
    if not frames:
        return None
    return 1e-6 * sum(s.ns for s in spans if s.name == name) / frames


def count_per_frame(key: str) -> Optional[float]:
    """The count `key`, summed over every span, over the recording's
    frames."""
    spans = recording()
    frames = _frames(spans)
    if not frames:
        return None
    return sum(s.counts.get(key, 0) for s in spans) / frames


def copies_traced(rec) -> bool:
    """Whether the sub-window's trace holds, a segment, as many copies from
    the device to host memory as the recording counts a segment. The trace
    holds the last of the sub-window's attempts and the recording every
    attempt, so the two are compared per segment, which the cell makes
    alike."""
    trace = getattr(rec, "trace", None)
    if trace is None:
        return False
    spans = recording()
    segments = sum(1 for s in spans if s.name == "save_vcs")
    traced_segments = sum(1 for _, _, n in trace.spans if n == SEGMENT_SPAN)
    if not (segments and traced_segments):
        return False
    counted = sum(s.counts.get("d2h_copies", 0) for s in spans)
    traced = sum(1 for _, _, n, c in trace.device
                 if c == "gpu_memcpy" and n.startswith(D2H_PREFIX))
    return counted * traced_segments == traced * segments
