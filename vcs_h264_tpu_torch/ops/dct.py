"""Blockwise orthonormal 2-D DCT-II and its inverse in float32
(counterpart of `vcs_h264_tpu/ops/dct.py`).

The matrix is computed in float64 on the host and rounded once to float32,
as the JAX package does; the products run in full float32 (callers on a GPU
keep TF32 off, which is PyTorch's default for matmul).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def dct_matrix_np(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (float64): row 0 = 1/sqrt(n), row i =
    sqrt(2/n) cos((2j+1) i pi / 2n)."""
    j = np.arange(n)[None, :]
    i = np.arange(n)[:, None]
    m = np.sqrt(2.0 / n) * np.cos((2 * j + 1) * i * np.pi / (2 * n))
    m[0, :] = 1.0 / np.sqrt(n)
    return m


def dct_matrix(n: int, device=None) -> torch.Tensor:
    return torch.tensor(dct_matrix_np(n), dtype=torch.float32, device=device)


def dct2_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Forward DCT D @ B @ D^T on [..., bs, bs] float32 blocks."""
    d = dct_matrix(blocks.shape[-1], blocks.device)
    return torch.matmul(torch.matmul(d, blocks), d.T)


def idct2_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Inverse DCT D^T @ B @ D on [..., bs, bs] float32 blocks."""
    d = dct_matrix(blocks.shape[-1], blocks.device)
    return torch.matmul(torch.matmul(d.T, blocks), d)
