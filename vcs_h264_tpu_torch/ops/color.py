"""BGR <-> YCrCb, bit-exact with OpenCV's 8-bit path (counterpart of
`vcs_h264_tpu/ops/color.py`), and the chroma study's float conversion
back to RGB.

OpenCV's uint8 conversion is fixed-point: 14-bit coefficient tables with
round-half-up descaling. The port computes it in int32 with an arithmetic
right shift. Every intermediate is an integer of magnitude below 2^23, so
this is exact, and it equals the JAX package's float32 `floor` form (its
planar functions) for every uint8 input.
"""

from __future__ import annotations

import torch

# OpenCV fixed-point constants (yuv_shift = 14).
_SHIFT = 14
_HALF = 1 << (_SHIFT - 1)
_R2Y, _G2Y, _B2Y = 4899, 9617, 1868
_CR_COEF = 11682          # (R - Y) * 11682 >> 14  + 128
_CB_COEF = 9241           # (B - Y) * 9241  >> 14  + 128
_CR2R = 22987             # R = Y + ((Cr-128) * 22987 >> 14)
_CB2B = 29049             # B = Y + ((Cb-128) * 29049 >> 14)
_CR2G = -11698
_CB2G = -5636


def _descale(x: torch.Tensor) -> torch.Tensor:
    return (x + _HALF) >> _SHIFT


def _to_ycrcb(b, g, r):
    y = _descale(r * _R2Y + g * _G2Y + b * _B2Y)
    cr = _descale((r - y) * _CR_COEF + (128 << _SHIFT))
    cb = _descale((b - y) * _CB_COEF + (128 << _SHIFT))
    return y, cr, cb


def _to_bgr(y, cr, cb):
    b = y + _descale((cb - 128) * _CB2B)
    g = y + _descale((cb - 128) * _CB2G + (cr - 128) * _CR2G)
    r = y + _descale((cr - 128) * _CR2R)
    return b, g, r


def _convert(x: torch.Tensor, fn, dim: int) -> torch.Tensor:
    """Apply fn to the three channels of x along `dim`, in int32, and clip
    the result to [0, 255]."""
    x = x.to(torch.int32)
    out = fn(*(x.select(dim, c) for c in range(3)))
    return torch.stack(out, dim=dim).clamp_(0, 255)


def bgr_to_ycrcb(bgr: torch.Tensor) -> torch.Tensor:
    """BGR [..., 3] (uint8-valued) -> YCrCb [..., 3] int32, bit-exact with
    cv2.COLOR_BGR2YCR_CB."""
    return _convert(bgr, _to_ycrcb, -1)


def ycrcb_to_bgr(ycrcb: torch.Tensor) -> torch.Tensor:
    """YCrCb [..., 3] (uint8-valued) -> BGR [..., 3] int32, bit-exact with
    cv2.COLOR_YCR_CB2BGR."""
    return _convert(ycrcb, _to_bgr, -1)


def bgr_to_ycrcb_planes(x: torch.Tensor) -> torch.Tensor:
    """Planar BGR [..., 3, H, W] -> planar YCrCb [..., 3, H, W] int32."""
    return _convert(x, _to_ycrcb, -3)


def ycrcb_to_bgr_planes(x: torch.Tensor) -> torch.Tensor:
    """Planar YCrCb [..., 3, H, W] -> planar BGR [..., 3, H, W] int32."""
    return _convert(x, _to_bgr, -3)


# The chroma study's own float32 constants (YCrCb -> RGB).
_STUDY_CR2R, _STUDY_CB2G, _STUDY_CR2G, _STUDY_CB2B = (
    1.4022, 0.34414, 0.71414, 1.772)


def ycrcb_to_rgb_float(y: torch.Tensor, cr: torch.Tensor, cb: torch.Tensor):
    """Float YCrCb -> RGB with the chroma study's constants, in float32:
    r = y + 1.4022 cr', g = y - 0.34414 cb' - 0.71414 cr', b = y + 1.772 cb'
    (cr', cb' = cr - 128, cb - 128), each clamped to [0, 255]. Returns float32
    tensors (r, g, b)."""
    yf = y.to(torch.float32)
    crf = cr.to(torch.float32) - 128.0
    cbf = cb.to(torch.float32) - 128.0
    # a Python float multiplies a float32 tensor as a float32 operand, as
    # the JAX package rounds its constants
    r = yf + _STUDY_CR2R * crf
    g = yf - _STUDY_CB2G * cbf - _STUDY_CR2G * crf
    b = yf + _STUDY_CB2B * cbf
    return r.clamp(0.0, 255.0), g.clamp(0.0, 255.0), b.clamp(0.0, 255.0)
