"""K5, the closed-loop lossy 4x4 intra encode (`csrc/intra_wavefront.cu`):
the least time its work could take on the card over the device time of its
kernels in the profiled sub-window, in percent. The work is every I plane
of the profiled GOPs (`bounds.intra_encode_work`): three full planes a GOP
at full resolution, a luma plane and two half-size chroma planes in
4:2:0."""

from benchmark.harness import bounds

KERNELS = ("intra_encode_kernel",)


def _planes(config):
    h, w = config["height"], config["width"]
    if config["codec"]["chroma_420"]:
        return [(1, h, w), (2, h // 2, w // 2)]
    return [(3, h, w)]


def read(rec):
    seconds = rec.kernel_seconds(KERNELS)
    if not seconds or not rec.profiled_gops:
        return None
    work = [bounds.intra_encode_work(rec.profiled_gops * n, h, w)
            for n, h, w in _planes(rec.config)]
    n_bytes = sum(b for b, _ in work)
    n_ops = sum(o for _, o in work)
    return 100.0 * bounds.bound_seconds(n_bytes, n_ops) / seconds
