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
from vcs_h264_tpu_torch.models.gop import (EncodedGOP, EncodedGOP420,
                                            EncodedVideo, npz_fields)


def _dtypes(cfg: CodecConfig) -> dict:
    """GOP field -> dtype, as both packages hold it in memory
    (`models.gop.npz_fields`)."""
    return {name: mem for name, (_, _, mem) in npz_fields(cfg).items()}


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
