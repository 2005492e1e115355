"""Quality metrics (counterpart of `vcs_h264_tpu/utils/metrics.py`)."""

from __future__ import annotations

import numpy as np


def psnr(a, b, max_val: float = 255.0) -> float:
    """Peak signal-to-noise ratio between two uint8-valued arrays."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(max_val * max_val / mse))
