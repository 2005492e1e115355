"""Plane <-> block-batch layout transforms (counterpart of
`vcs_h264_tpu/ops/blocks.py`)."""

from __future__ import annotations

import torch


def plane_to_blocks(plane: torch.Tensor, bs: int) -> torch.Tensor:
    """[..., H, W] -> [..., H//bs, W//bs, bs, bs]. H and W must divide bs."""
    *lead, h, w = plane.shape
    if h % bs or w % bs:
        raise ValueError(f"plane {h}x{w} not a multiple of block {bs}")
    x = plane.reshape(*lead, h // bs, bs, w // bs, bs)
    return x.transpose(-3, -2)


def blocks_to_plane(blocks: torch.Tensor) -> torch.Tensor:
    """[..., nbh, nbw, bs, bs] -> [..., H, W]."""
    *lead, nbh, nbw, bs1, bs2 = blocks.shape
    return blocks.transpose(-3, -2).reshape(*lead, nbh * bs1, nbw * bs2)
