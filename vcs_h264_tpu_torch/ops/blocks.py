"""Plane <-> block-batch layout transforms, and the padding and cropping
of planes to a block multiple (counterpart of `vcs_h264_tpu/ops/blocks.py`)."""

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


def pad_to_multiple(plane: torch.Tensor, bs: int, value=0) -> torch.Tensor:
    """Pad the trailing two dims at the bottom and right up to the next
    multiple of bs with `value`."""
    ph = (-plane.shape[-2]) % bs
    pw = (-plane.shape[-1]) % bs
    if ph == 0 and pw == 0:
        return plane
    return torch.nn.functional.pad(plane, (0, pw, 0, ph), value=value)


def crop_to_multiple(plane: torch.Tensor, bs: int) -> torch.Tensor:
    """Crop the trailing two dims down to a multiple of bs (the partial
    blocks at the bottom and right are dropped)."""
    h, w = plane.shape[-2:]
    return plane[..., : h - h % bs, : w - w % bs]
