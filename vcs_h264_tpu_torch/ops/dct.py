"""Blockwise orthonormal 2-D DCT-II and its inverse in float32
(counterpart of `vcs_h264_tpu/ops/dct.py`).

The matrix is computed in float64 on the host and rounded once to float32,
as the JAX package does. The products are written out as eight multiplies
and adds per pass, each rounded to float32, in the order the K3/K4 kernels
sum them (`csrc/inter_fused.cu`), instead of `torch.matmul`: a float32
matmul on a GPU may run in TF32 (`torch.backends.cuda.matmul.allow_tf32`,
`torch.set_float32_matmul_precision`), which keeps about three decimal
digits, and reference mode rounds IDCT outputs that sit within ~1e-4 of an
integer. The result does not depend on either setting.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vcs_h264_tpu_torch.ops.blocks import blocks_to_plane, plane_to_blocks


@functools.lru_cache(maxsize=None)
def dct_matrix_np(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (float64): row 0 = 1/sqrt(n), row i =
    sqrt(2/n) cos((2j+1) i pi / 2n)."""
    j = np.arange(n)[None, :]
    i = np.arange(n)[:, None]
    m = np.sqrt(2.0 / n) * np.cos((2 * j + 1) * i * np.pi / (2 * n))
    m[0, :] = 1.0 / np.sqrt(n)
    return m


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int, device=None) -> torch.Tensor:
    """float32 [n, n], made once per size and device (on a GPU each upload
    is a host sync); shared by every caller, so none may write to it."""
    return torch.tensor(dct_matrix_np(n), dtype=torch.float32, device=device)


def _left(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """m @ x over the last two axes: sum_j m[i, j] x[..., j, k], j in order."""
    acc = m[:, 0, None] * x[..., 0:1, :]
    for j in range(1, m.shape[1]):
        acc = acc + m[:, j, None] * x[..., j:j + 1, :]
    return acc


def _right(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x @ m over the last two axes: sum_k x[..., i, k] m[k, l], k in order."""
    acc = x[..., 0:1] * m[0]
    for k in range(1, m.shape[0]):
        acc = acc + x[..., k:k + 1] * m[k]
    return acc


def dct2_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Forward DCT D @ B @ D^T on [..., bs, bs] float32 blocks."""
    d = dct_matrix(blocks.shape[-1], blocks.device)
    return _right(_left(d, blocks), d.T)


def idct2_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Inverse DCT D^T @ B @ D on [..., bs, bs] float32 blocks."""
    d = dct_matrix(blocks.shape[-1], blocks.device)
    return _right(_left(d.T, blocks), d)


def dct2_plane(plane: torch.Tensor, bs: int) -> torch.Tensor:
    """Forward blockwise DCT over a [..., H, W] plane (H, W multiples of
    bs), in float32."""
    return blocks_to_plane(dct2_blocks(plane_to_blocks(
        plane.to(torch.float32), bs)))


def idct2_plane(plane: torch.Tensor, bs: int) -> torch.Tensor:
    """Inverse blockwise DCT over a [..., H, W] plane, in float32."""
    return blocks_to_plane(idct2_blocks(plane_to_blocks(
        plane.to(torch.float32), bs)))
