"""4:2:0 chroma subsampling (counterpart of
`vcs_h264_tpu/ops/subsample.py`), and the chroma study's round trip.

cv2.boxFilter's uint8 2x2 path, as the JAX package pins it:
out(i, j) = ceil((x[i-1, j-1] + x[i-1, j] + x[i, j-1] + x[i, j]) / 4) with
BORDER_REFLECT_101 at the top and left (index -1 reads index 1), then a
stride-2 decimation; nearest-neighbour upsampling back. All in int32, so
every step is exact. Plain PyTorch: the JAX package computes these outside
any Pallas kernel.
"""

from __future__ import annotations

import torch

from vcs_h264_tpu_torch.ops import color


def box_filter_2x2(plane: torch.Tensor) -> torch.Tensor:
    """Bit-exact cv2.boxFilter(uint8, ksize=(2, 2), normalize=True) on
    uint8-valued planes [..., H, W] (H, W >= 2) -> int32."""
    x = plane.to(torch.int32)
    xp = torch.cat([x[..., 1:2, :], x], dim=-2)          # row -1 -> row 1
    xp = torch.cat([xp[..., :, 1:2], xp], dim=-1)        # col -1 -> col 1
    s = (xp[..., :-1, :-1] + xp[..., :-1, 1:]
         + xp[..., 1:, :-1] + xp[..., 1:, 1:])
    return (s + 3) >> 2                                  # ceil(s / 4)


def subsample_420(plane: torch.Tensor) -> torch.Tensor:
    """Box filter and stride-2 decimation: [..., H, W] -> [..., ceil(H/2),
    ceil(W/2)] int32."""
    return box_filter_2x2(plane)[..., ::2, ::2]


def upsample_nearest(plane: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample: out[i, j] = plane[i // factor, j // factor]."""
    return plane.repeat_interleave(factor, dim=-2).repeat_interleave(
        factor, dim=-1)


def encode_420(ycc_planes: torch.Tensor):
    """Planar YCrCb [..., 3, H, W] -> (Y [..., H, W], Cr [..., H/2, W/2],
    Cb) int32."""
    return (ycc_planes[..., 0, :, :].to(torch.int32),
            subsample_420(ycc_planes[..., 1, :, :]),
            subsample_420(ycc_planes[..., 2, :, :]))


def decode_420(y: torch.Tensor, cr: torch.Tensor,
               cb: torch.Tensor) -> torch.Tensor:
    """(Y, Cr/2, Cb/2) -> planar YCrCb [..., 3, H, W], chroma upsampled to
    the luma's size."""
    h, w = y.shape[-2:]
    return torch.stack([y, upsample_nearest(cr)[..., :h, :w].to(y.dtype),
                        upsample_nearest(cb)[..., :h, :w].to(y.dtype)],
                       dim=-3)


def chroma_420_roundtrip(bgr_planes: torch.Tensor) -> torch.Tensor:
    """The chroma study end to end: BGR planes [..., 3, H, W] (uint8 values)
    -> YCrCb, 4:2:0 subsampled chroma, nearest upsampling back to H x W, the
    study's float conversion to RGB (`color.ycrcb_to_rgb_float`) -> BGR
    planes [..., 3, H, W] int32. The float -> int step truncates toward
    zero, as the reference's assignment into a uint8 image does (the
    values are already clamped to [0, 255])."""
    ycc = color.bgr_to_ycrcb_planes(bgr_planes)
    y = ycc[..., 0, :, :]
    h, w = y.shape[-2:]
    cr = upsample_nearest(subsample_420(ycc[..., 1, :, :]))[..., :h, :w]
    cb = upsample_nearest(subsample_420(ycc[..., 2, :, :]))[..., :h, :w]
    r, g, b = color.ycrcb_to_rgb_float(y, cr, cb)
    return torch.stack([b.to(torch.int32), g.to(torch.int32),
                        r.to(torch.int32)], dim=-3)
