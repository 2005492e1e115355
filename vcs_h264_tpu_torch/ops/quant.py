"""JPEG quantization tables, quality-factor scaling, quantization and the
zigzag scan (counterpart of `vcs_h264_tpu/ops/quant.py`). The functions
below the tables take torch tensors or numpy arrays; the `.vcs` container
(`io/bitstream.py`) orders each block's coefficients by `zigzag_order_np`.

    scale = 50/QF            (1 <= QF < 50)
    scale = (100-QF)/50      (50 <= QF <= 99)
    Q     = clip(round(Qbase * scale), 1, 255)
"""

from __future__ import annotations

import functools

import numpy as np
import torch

QY_BASE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 48, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], dtype=np.float64)

QC_BASE = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
], dtype=np.float64)


def qf_scale(qf: float) -> float:
    """Quality factor -> table scale."""
    if not (1 <= qf <= 99):
        raise ValueError("quality factor must be in [1, 99]")
    if qf < 50:
        return 50.0 / qf
    return (100.0 - qf) / 50.0


@functools.lru_cache(maxsize=None)
def quant_tables_np(qf: float):
    """(QY, QC) scaled tables as float64, clipped to [1, 255]."""
    s = qf_scale(qf)
    qy = np.clip(np.round(QY_BASE * s), 1, 255)
    qc = np.clip(np.round(QC_BASE * s), 1, 255)
    return qy, qc


@functools.lru_cache(maxsize=None)
def quant_tables(qf: float, device=None) -> torch.Tensor:
    """Stacked float32 [3, 8, 8] table for (Y, Cr, Cb) channel order, made
    once per quality and device: on a GPU each upload is a host sync. Every
    caller shares the tensor, so none may write to it."""
    qy, qc = quant_tables_np(qf)
    return torch.tensor(np.stack([qy, qc, qc]), dtype=torch.float32,
                        device=device)


def quantize(coeffs, q, rounded: bool):
    """coeffs / q, optionally rounded to nearest with ties to even (as
    `np.round` and `torch.round` both round). `coeffs` [..., bs, bs]
    float; `q` a broadcastable table."""
    d = coeffs / q
    if rounded:
        d = torch.round(d) if isinstance(d, torch.Tensor) else np.round(d)
    return d


def dequantize(coeffs, q):
    return coeffs * q


@functools.lru_cache(maxsize=None)
def zigzag_order_np(n: int) -> np.ndarray:
    """Flat indices of an n x n block in zigzag (diagonal) scan order."""
    idx = []
    for s in range(2 * n - 1):
        diag = [(i, s - i) for i in range(max(0, s - n + 1), min(n, s + 1))]
        if s % 2 == 0:
            diag = diag[::-1]   # even diagonals run bottom-left -> top-right
        idx.extend(i * n + j for i, j in diag)
    return np.array(idx, dtype=np.int32)


def _index(order: np.ndarray, like):
    """`order` as an index into `like`, a tensor (on its device) or an
    array."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(order.astype(np.int64)).to(like.device)
    return order


def zigzag(blocks):
    """[..., n, n] -> [..., n*n] in zigzag order."""
    n = blocks.shape[-1]
    flat = blocks.reshape(*blocks.shape[:-2], n * n)
    return flat[..., _index(zigzag_order_np(n), blocks)]


def unzigzag(scans):
    """[..., n*n] zigzag -> [..., n, n]."""
    nn = scans.shape[-1]
    n = int(round(nn ** 0.5))
    order = zigzag_order_np(n)
    inv = np.empty_like(order)
    inv[order] = np.arange(nn, dtype=np.int32)
    return scans[..., _index(inv, scans)].reshape(*scans.shape[:-1], n, n)
