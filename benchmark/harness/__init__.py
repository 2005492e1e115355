"""The cell runner and its yardstick: traffic, frames, bounds, the trace
reader and the comparison with the reference."""
