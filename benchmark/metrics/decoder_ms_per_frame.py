"""Host-clock milliseconds of the window's `decode` steps over the frames
they carried (the benchmark's own span around the call)."""


def read(rec):
    return rec.ms_per_frame("decode")
