"""K2, the block motion search (`csrc/motion_sad.cu`): the least time its
work could take on the card over the device time of its kernels in the
profiled sub-window, in percent. The work is the searches of the profiled
segments as the reference runs them: per block the static SAD, and for the
blocks these frames do not declare static every valid candidate's SAD
(`bounds.search_work`)."""

from benchmark.harness import bounds

KERNELS = ("sad_search_",)


def read(rec):
    seconds = rec.kernel_seconds(KERNELS)
    if not seconds:
        return None
    work = [bounds.search_work(call) for call in rec.searches()]
    n_bytes = sum(b for b, _ in work)
    n_ops = sum(o for _, o in work)
    return 100.0 * bounds.bound_seconds(n_bytes, n_ops) / seconds
