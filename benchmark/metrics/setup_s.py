"""Process start to the first timed segment: imports, the kernels' and the
coder's build or load, the frame pool, the encoder and decoder, the
warm-up segment (and in a traced run the profiled sub-window)."""


def read(rec):
    return rec.setup_s
