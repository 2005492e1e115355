"""Intra coding of I-frames (counterpart of
`vcs_h264_tpu/models/intra_codec.py`).

Each channel of an I-frame is a plane of the 4x4 intra wavefront. Lossless
intra stores per-channel residuals, modes and escapes; lossy intra stores
quantized 4x4 core-transform coefficients, modes and escapes, and its
reconstruction is what the decoder gives back bit for bit, so P-frames can
be predicted from it without drift. Prediction runs on the B, G, R planes
directly, without a colour conversion.

The batched functions flatten (B, C) into one plane batch, so the whole
batch of I-frames rides one kernel launch. `backend` is passed to the ops:
"auto" runs the CUDA kernels (K5, K6) on CUDA tensors and the plain PyTorch
versions on CPU tensors; "plain" runs the plain versions on either.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vcs_h264_tpu_torch.ops import intra


class IntraFrame(NamedTuple):
    """Losslessly intra-coded frame: per-channel residual, modes, escape."""
    residual: torch.Tensor    # int16 [C, H, W]
    modes: torch.Tensor       # int8  [C, H/4, W/4]
    escape: torch.Tensor      # bool  [C, H/4, W/4]


class IntraFrameLossy(NamedTuple):
    """Lossy intra-coded frame (or a batch with a leading axis): quantized
    4x4 core-transform coefficients in block-layout planes, modes, escape."""
    qcoef: torch.Tensor       # int16 [C, H, W]
    modes: torch.Tensor       # int8  [C, H/4, W/4]
    escape: torch.Tensor      # bool  [C, H/4, W/4]


def encode_intra_frame(planes: torch.Tensor) -> IntraFrame:
    """planes [C, H, W] (uint8 values), H, W multiples of 4."""
    res, modes, escape = intra.luma4x4_codec(planes)
    return IntraFrame(residual=res.to(torch.int16),
                      modes=modes.to(torch.int8), escape=escape)


def decode_intra_frame(frame: IntraFrame,
                       backend: str = "auto") -> torch.Tensor:
    """-> int32 [C, H, W], the bit-exact inverse of encode_intra_frame."""
    return intra.intra_decode4x4_batch(frame.residual, frame.modes,
                                       frame.escape, backend)


def encode_intra_frame_lossy(planes: torch.Tensor, qstep: int,
                             backend: str = "auto"):
    """planes uint8 [C, H, W] -> (IntraFrameLossy, recon uint8 [C, H, W]),
    recon being the decoder's exact output."""
    q, modes, escape, recon = intra.intra_encode4x4_lossy_batch(
        planes, qstep, backend)
    return IntraFrameLossy(qcoef=q, modes=modes, escape=escape), recon


def decode_intra_frame_lossy(frame: IntraFrameLossy, qstep: int,
                             backend: str = "auto") -> torch.Tensor:
    """-> uint8 [C, H, W], bit-exact equal to the encoder's recon."""
    return intra.intra_decode4x4_lossy_batch(frame.qcoef, frame.modes,
                                             frame.escape, qstep, backend)


def encode_intra_frames_lossy_batch(planes: torch.Tensor, qstep: int,
                                    backend: str = "auto"):
    """uint8 [B, C, H, W] -> (IntraFrameLossy with leading B, recon uint8
    [B, C, H, W])."""
    b, c = planes.shape[:2]
    q, modes, escape, recon = intra.intra_encode4x4_lossy_batch(
        planes.reshape(b * c, *planes.shape[2:]).contiguous(), qstep, backend)

    def unflat(x):
        return x.reshape(b, c, *x.shape[1:])

    return (IntraFrameLossy(qcoef=unflat(q), modes=unflat(modes),
                            escape=unflat(escape)), unflat(recon))


def decode_intra_frames_lossy_batch(frame: IntraFrameLossy, qstep: int,
                                    backend: str = "auto") -> torch.Tensor:
    """IntraFrameLossy with leading B -> recon uint8 [B, C, H, W]."""
    b, c = frame.qcoef.shape[:2]

    def flat(x, dtype):
        return x.to(dtype).reshape(b * c, *x.shape[2:]).contiguous()

    out = intra.intra_decode4x4_lossy_batch(
        flat(frame.qcoef, torch.int16), flat(frame.modes, torch.int8),
        flat(frame.escape, torch.bool), qstep, backend)
    return out.reshape(b, c, *out.shape[1:])
