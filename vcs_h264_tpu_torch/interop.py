"""Encoded streams across the two packages.

The codec has no weights: what crosses between the JAX package and this
one is the encoded stream (I-frames, motion vectors, coefficients). These
functions convert it through numpy, without importing JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vcs_h264_tpu_torch.config import CodecConfig, check_supported
from vcs_h264_tpu_torch.models.gop import EncodedGOP, EncodedVideo


def from_jax_video(video) -> EncodedVideo:
    """A JAX-package `EncodedVideo` (any array type numpy can read) -> this
    package's, with CPU tensors. Raises NotImplementedError for streams in
    modes this package does not code (B-frame and lossy-intra payloads only
    exist in such modes)."""
    cfg = CodecConfig(**dataclasses.asdict(video.config))
    check_supported(cfg)
    gops = []
    for gop in video.gops:
        res = gop.residuals
        gops.append(EncodedGOP(
            i_frame=torch.from_numpy(np.asarray(gop.i_frame).astype(np.uint8)),
            mv=torch.from_numpy(np.asarray(gop.mv).astype(np.int32)),
            residuals=None if res is None
            else torch.from_numpy(np.asarray(res).astype(np.int16))))
    return EncodedVideo(cfg, int(video.height), int(video.width),
                        float(video.fps), int(video.num_frames), gops)


def to_numpy_video(video: EncodedVideo) -> dict:
    """This package's `EncodedVideo` -> plain numpy: a dict with `config`
    (the dataclass fields), `height`, `width`, `fps`, `num_frames` and
    `gops`, a list of dicts keyed like the JAX package's `EncodedGOP`
    fields (`i_frame` uint8, `mv` int32, `residuals` int16 or None)."""
    return dict(
        config=dataclasses.asdict(video.config), height=video.height,
        width=video.width, fps=video.fps, num_frames=video.num_frames,
        gops=[dict(i_frame=g.i_frame.cpu().numpy().astype(np.uint8),
                   mv=g.mv.cpu().numpy().astype(np.int32),
                   residuals=None if g.residuals is None
                   else g.residuals.cpu().numpy().astype(np.int16))
              for g in video.gops])
