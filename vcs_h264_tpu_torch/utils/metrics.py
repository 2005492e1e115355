"""Quality metrics and structured logging (counterpart of
`vcs_h264_tpu/utils/metrics.py`): PSNR on the host and on the device,
SSIM, the sparsity statistic and the JSONL metrics sink."""

from __future__ import annotations

import json
import time
from typing import IO

import numpy as np
import torch


def psnr(a, b, max_val: float = 255.0) -> float:
    """Peak signal-to-noise ratio between two uint8-valued arrays."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(max_val * max_val / mse))


def psnr_t(a: torch.Tensor, b: torch.Tensor,
           max_val: float = 255.0) -> torch.Tensor:
    """PSNR of two tensors on their device, as a 0-d float32 tensor (no
    host sync); the mean squared error is floored at 1e-10."""
    mse = torch.mean((a.to(torch.float32) - b.to(torch.float32)) ** 2)
    return 10.0 * torch.log10(max_val * max_val / mse.clamp_min(1e-10))


def _float64(x, device) -> torch.Tensor:
    t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
    return t.to(device=device or t.device, dtype=torch.float64)


def ssim(a, b, max_val: float = 255.0, win: int = 8) -> float:
    """Mean local SSIM over sliding uniform windows (win x win, per
    channel), the standard structural similarity formulation with a uniform
    filter in place of the 11x11 Gaussian. Inputs are HxW or HxWxC
    uint8-valued arrays or tensors.

    The mean is over the windows that lie wholly inside the image: the JAX
    package's edge-padded uniform filter crops a border of win // 2, which
    leaves exactly those, so box means in float64 give its number."""
    a = _float64(a, None)
    b = _float64(b, a.device)
    if a.ndim == 3:                    # per-channel mean
        return float(np.mean([ssim(a[..., c], b[..., c], max_val, win)
                              for c in range(a.shape[-1])]))
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    m = win // 2
    h, w = a.shape[0] - 2 * m, a.shape[1] - 2 * m

    def box(x):
        mean = torch.nn.functional.avg_pool2d(x[None, None], win, stride=1)
        return mean[0, 0, :h, :w]

    mu_a, mu_b = box(a), box(b)
    va = box(a * a) - mu_a * mu_a
    vb = box(b * b) - mu_b * mu_b
    cov = box(a * b) - mu_a * mu_b
    s = (((2 * mu_a * mu_b + c1) * (2 * cov + c2))
         / ((mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2)))
    return float(s.mean())


def sparsity(x) -> float:
    """1 - nonzeros/size (the reference's compression statistic)."""
    x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    return float(1.0 - np.count_nonzero(x) / x.size)


class MetricsLogger:
    """Append-only JSONL metrics sink: one record per line, `ts` (seconds
    since the epoch) and `event` first, then the fields."""

    def __init__(self, path_or_file):
        if hasattr(path_or_file, "write"):
            self._fh: IO = path_or_file
            self._owns = False
        else:
            self._fh = open(path_or_file, "a")
            self._owns = True

    def log(self, event: str, **fields) -> None:
        rec = {"ts": time.time(), "event": event}
        rec.update(fields)
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._owns:
            self._fh.close()
