"""GOP encode / decode for the production IPPP path (counterpart of
`vcs_h264_tpu/models/pipeline.py:296-402` without B-frames).

Every P-frame of a GOP references the GOP's I-frame, which is stored raw.
Encode: motion search (K2), then the fused residual coding (K3). Decode:
the fused reconstruction (K4). The leading axis of the batched entry points
is the GOP batch.

`backend` is passed down to the ops: "auto" runs the CUDA kernels on CUDA
tensors and the plain PyTorch versions on CPU tensors; "plain" runs the
plain versions on either, the reference the kernels are compared with.
"""

from __future__ import annotations

import torch

from vcs_h264_tpu_torch.config import CodecConfig, check_supported
from vcs_h264_tpu_torch.models.gop import EncodedGOP
from vcs_h264_tpu_torch.ops import inter_cuda, motion


def encode_gop_batch(i_frames: torch.Tensor, p_frames: torch.Tensor,
                     cfg: CodecConfig, backend: str = "auto") -> EncodedGOP:
    """i_frames uint8 [B, 3, H, W]; p_frames uint8 [B, F, 3, H, W] with
    F >= 1, on one device -> EncodedGOP with a leading batch axis."""
    check_supported(cfg)
    mv = motion.motion_search_gops(
        p_frames, i_frames, bs=cfg.block_size, reach=cfg.search_reach,
        step=cfg.search_step, static_threshold=cfg.static_threshold,
        backend=backend)
    res = inter_cuda.encode_p_coeffs(mv, i_frames, p_frames,
                                     cfg.quality_factor, backend)
    return EncodedGOP(i_frame=i_frames, mv=mv, residuals=res)


def decode_gop_batch(gop: EncodedGOP, cfg: CodecConfig,
                     backend: str = "auto") -> torch.Tensor:
    """Batched EncodedGOP with F >= 1 P-frames -> uint8 frames
    [B, 1 + F, 3, H, W] in display order."""
    check_supported(cfg)
    if gop.residuals is None:
        raise ValueError("decode_gop_batch: P-frames without residuals")
    out_p = inter_cuda.decode_p_frames(gop.mv, gop.i_frame, gop.residuals,
                                       cfg.quality_factor, backend)
    return torch.cat([gop.i_frame[:, None], out_p], dim=1)


def encode_gop(i_frame: torch.Tensor, p_frames: torch.Tensor,
               cfg: CodecConfig, backend: str = "auto") -> EncodedGOP:
    """One GOP: i_frame [3, H, W], p_frames [F, 3, H, W] (F >= 1, fewer than
    the pattern's for a tail GOP)."""
    return encode_gop_batch(i_frame[None], p_frames[None], cfg,
                            backend).select(0)


def decode_gop(gop: EncodedGOP, cfg: CodecConfig,
               backend: str = "auto") -> torch.Tensor:
    """One GOP -> uint8 frames [1 + F, 3, H, W]."""
    batch = EncodedGOP.stack([gop], gop.i_frame.device)
    return decode_gop_batch(batch, cfg, backend)[0]
