"""`save_vcs_ms_per_frame`, read as its own reader reads it, in a cell whose bounded
rate is `kernel_ms_per_frame`: there the host-clock `fps` spreads over
the widest bound, so it is not an end-to-end metric."""

from benchmark.metrics.save_vcs_ms_per_frame import read  # noqa: F401
