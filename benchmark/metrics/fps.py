"""Frames of every segment completed in the window over the window's
seconds (first encode to last decode)."""


def read(rec):
    if not rec.window_s:
        return None
    return sum(rec.frames) / rec.window_s
