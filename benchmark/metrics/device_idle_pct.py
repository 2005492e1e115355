"""The share of the profiled sub-window in which no kernel, copy or memset
ran on the device: 100 x (1 - union of their intervals / the sub-window's
length)."""


def read(rec):
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
