"""Encoded streams across the two packages.

The codec has no weights: what crosses between the JAX package and this
one is the encoded stream (I-frames, motion vectors, residuals, the
B-frame vectors, modes and residuals, and the lossy-intra payload). These
functions convert it through numpy, without importing JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vcs_h264_tpu_torch.config import CodecConfig
from vcs_h264_tpu_torch.models.gop import (NPZ_420, EncodedGOP,
                                            EncodedGOP420, EncodedVideo,
                                            residual_dtype)


def _dtypes(cfg: CodecConfig) -> dict:
    """GOP field -> dtype, as both packages hold it in memory; the
    residuals' follows the mode (`models.gop.residual_dtype`). Under
    `chroma_420` the fields are `EncodedGOP420`'s."""
    if cfg.chroma_420:
        return {name: mem for name, (_, _, mem) in NPZ_420.items()}
    res = residual_dtype(cfg)
    return dict(i_frame=np.uint8, mv=np.int32, residuals=res, b_mv=np.int32,
                b_mode=np.int8, b_residuals=res, i_qcoef=np.int16,
                i_modes=np.int8, i_escape=bool)


def from_jax_video(video) -> EncodedVideo:
    """A JAX-package `EncodedVideo` (any array type numpy can read) -> this
    package's, with CPU tensors."""
    cfg = CodecConfig(**dataclasses.asdict(video.config))

    def conv(v, dtype):
        return None if v is None else torch.from_numpy(
            np.asarray(v).astype(dtype))

    record = EncodedGOP420 if cfg.chroma_420 else EncodedGOP
    gops = [record(**{k: conv(getattr(gop, k), dt)
                      for k, dt in _dtypes(cfg).items()})
            for gop in video.gops]
    return EncodedVideo(cfg, int(video.height), int(video.width),
                        float(video.fps), int(video.num_frames), gops)


def to_numpy_video(video: EncodedVideo) -> dict:
    """This package's `EncodedVideo` -> plain numpy: a dict with `config`
    (the dataclass fields), `height`, `width`, `fps`, `num_frames` and
    `gops`, a list of dicts keyed like the JAX package's `EncodedGOP`
    fields (`i_frame` uint8, `mv` int32, `residuals` in the mode's dtype,
    the B-frame fields `b_mv` int32, `b_mode` int8 and `b_residuals`, and
    the lossy-intra payload `i_qcoef` int16, `i_modes` int8, `i_escape`
    bool; None where absent). A 4:2:0 stream's dicts are keyed like
    `EncodedGOP420`: `i_y`, `i_c` uint8, `mv`, `res_y`, `res_c`, the six
    payload fields, `b_mv`, `b_mode`, `bres_y`, `bres_c`."""
    dtypes = _dtypes(video.config)
    return dict(
        config=dataclasses.asdict(video.config), height=video.height,
        width=video.width, fps=video.fps, num_frames=video.num_frames,
        gops=[{k: None if getattr(g, k) is None
               else getattr(g, k).cpu().numpy().astype(dt)
               for k, dt in dtypes.items()} for g in video.gops])
