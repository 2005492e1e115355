"""What a metric's reader (`benchmark/metrics/<name>.py`) is given: the
window's segments (latencies, step spans, frames), its length and the
set-up before it, the profiled sub-window's trace, and the work that the
profiled segments' inputs and the configuration define (counted by the
reference, never by the program). A reader returns a number, or None when
it finds nothing to read; the harness then leaves the metric out."""

from __future__ import annotations

from typing import Callable, Optional


class Records:
    def __init__(self, spans: dict, frames: list, latency: list,
                 window_s: float, setup_s: Optional[float], trace,
                 config: dict, profiled_gops: int,
                 search_log: Callable[[], list]):
        self.spans = spans              # step -> seconds per window segment
        self.frames = frames            # frames per window segment
        self.latency = latency          # seconds per window segment, 1-4
        self.window_s = window_s        # first encode to last decode
        self.setup_s = setup_s          # process start to the window
        self.trace = trace              # trace.Trace, or None
        self.config = config            # the configuration's file
        self.profiled_gops = profiled_gops
        self._search_log = search_log
        self._searches = None

    def ms_per_frame(self, step: str) -> Optional[float]:
        if not self.frames:
            return None
        return 1e3 * sum(self.spans[step]) / sum(self.frames)

    def kernel_seconds(self, fragments) -> Optional[float]:
        """Device seconds of the sub-window's kernels whose names hold one
        of `fragments`; None without a trace or such a kernel."""
        if self.trace is None:
            return None
        return self.trace.kernel_seconds(fragments) or None

    def searches(self) -> list:
        """The profiled segments' motion searches as the reference runs
        them: each call's geometry and static blocks."""
        if self._searches is None:
            self._searches = self._search_log()
        return self._searches
