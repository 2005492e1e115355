"""The least time the card could take for a kernel's work: the peaks of one
NVIDIA H100 SXM (NVIDIA's data sheet, at its full 700 W power limit) and
the operations and bytes that the inputs and the configuration define,
whatever a kernel happens to do.

`search_work` counts the block motion search: frames in, vectors out; per
block the static SAD, and for the blocks these frames do not declare static
the SAD of every valid candidate, 3 operations per sample and candidate.
`intra_encode_work` counts the closed-loop lossy 4x4 intra encode: planes
in, coefficients, modes, escape flags and the reconstruction out; 9
predictors of about 3 operations per predicted sample and 3 per SAD term,
and the core transform forwards and back, 94 operations a sample.
"""

from __future__ import annotations

import numpy as np

PEAK_BYTES_PER_S = 3.35e12      # HBM3
PEAK_OPS_PER_S = 67e12          # float32 outside the tensor cores, taken
                                # for the integer ALU work as well
SEARCH_OPS_PER_SAMPLE = 3
INTRA_ENC_OPS = 94


def bound_seconds(n_bytes: float, n_ops: float) -> float:
    """The larger of the bytes over the memory rate and the operations over
    the ALU rate."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_OPS_PER_S)


def valid_candidates(h: int, w: int, bs: int, reach: int, step: int):
    """[nbh, nbw]: the valid candidates of each block, positions
    max(c - reach, 0) + step * k with p + bs < min(c + reach, extent) on
    each axis."""
    k = -(-2 * reach // step)

    def axis(nb, extent):
        c = np.arange(nb) * bs
        lo = np.maximum(c - reach, 0)
        hi = np.minimum(c + reach, extent)
        pos = lo[:, None] + step * np.arange(k)[None, :]
        return (pos + bs < hi[:, None]).sum(1)

    return axis(h // bs, h)[:, None] * axis(w // bs, w)[None, :]


def search_work(call: dict):
    """One search: `call` holds its geometry (g, f, c, h, w, bs, reach,
    step) and `static`, bool [g, f, nbh, nbw] -> (bytes, operations)."""
    g, f, c, h, w, bs = (call[k] for k in ("g", "f", "c", "h", "w", "bs"))
    valid = valid_candidates(h, w, bs, call["reach"], call["step"])
    cands = 1 + (~call["static"]) * valid[None, None]
    n_bytes = g * f * c * h * w + g * c * h * w + g * f * (h // bs) * (
        w // bs) * 2 * 4
    return n_bytes, SEARCH_OPS_PER_SAMPLE * c * bs * bs * float(cands.sum())


def intra_encode_work(n: int, h: int, w: int):
    """n planes of h x w -> (bytes, operations): uint8 planes, int16
    coefficients, uint8 reconstruction, an int8 mode and a bool escape flag
    per 4x4 block."""
    samples = n * h * w
    return samples * 4 + 2 * n * (h // 4) * (w // 4), samples * INTRA_ENC_OPS
