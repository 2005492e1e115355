"""`device_idle_pct`, read as its own reader reads it, in a cell whose bounded
rate is `kernel_ms_per_frame`: there the host-clock `fps` spreads over
the widest bound, so it is not an end-to-end metric."""

from benchmark.metrics.device_idle_pct import read  # noqa: F401
