"""The card's kernel time a frame: the union of every kernel's interval in
a profiled sub-window of whole segments, in milliseconds, over the frames
of those segments. Copies are left out: a copy from or to pageable host
memory lasts as long as the host's staging copy, so its length follows
the host. An untraced run profiles its sub-window after the window."""


def read(rec):
    if rec.trace is None or not rec.profiled_gops:
        return None
    kernel_s = sum(e - s for s, e in rec.trace.busy(("kernel",)))
    frames = rec.profiled_gops * len(rec.config["codec"]["gop_pattern"])
    return 1e3 * kernel_s / frames if kernel_s > 0 else None
