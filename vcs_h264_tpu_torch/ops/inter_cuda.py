"""Fused P-frame encode (K3) and decode (K4): wrappers of the CUDA kernels in
`csrc/inter_fused.cu` and their plain PyTorch versions (counterpart of
`vcs_h264_tpu/ops/inter_pallas.py`, with the production residual coding of
`vcs_h264_tpu/models/pipeline.py:87-131`).

The production residual path codes the SIGNED residual cur - prediction
through a linear, offset-free RCT (the cv2 YCrCb factors), an 8x8 DCT and
round-half-even quantization to int16; decode runs it backwards, rounds,
adds the prediction back and clips to [0, 255].

`encode_p_coeffs` / `decode_p_frames` send CUDA tensors to the kernels and
CPU tensors to the plain versions; `backend="plain"` asks for the plain
versions on any device (the reference the kernels are held against).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vcs_h264_tpu_torch.ops import _build
from vcs_h264_tpu_torch.ops.blocks import blocks_to_plane, plane_to_blocks
from vcs_h264_tpu_torch.ops.dct import dct2_blocks, dct_matrix_np, idct2_blocks
from vcs_h264_tpu_torch.ops.motion import check_backend, motion_compensate_gops
from vcs_h264_tpu_torch.ops.quant import quant_tables, quant_tables_np

# Launches of each kernel of this module, counted where the kernel launches.
LAUNCHES = {"fused_p_encode": 0, "fused_p_decode": 0}

BS = 8


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    # A float32 tensor on the input's device: dividing by a Python scalar on
    # a GPU multiplies by its reciprocal, which is not IEEE division.
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def signed_bgr_to_ycc(resid: torch.Tensor) -> torch.Tensor:
    """Linear BGR -> YCrCb on signed planar float32 residuals [..., 3, H, W]."""
    b, g, r = resid[..., 0, :, :], resid[..., 1, :, :], resid[..., 2, :, :]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cr = (r - y) * 0.713
    cb = (b - y) * 0.564
    return torch.stack([y, cr, cb], dim=-3)


def signed_ycc_to_bgr(ycc: torch.Tensor) -> torch.Tensor:
    y, cr, cb = ycc[..., 0, :, :], ycc[..., 1, :, :], ycc[..., 2, :, :]
    r = y + cr / _const(0.713, ycc)
    b = y + cb / _const(0.564, ycc)
    g = (y - 0.299 * r - 0.114 * b) / _const(0.587, ycc)
    return torch.stack([b, g, r], dim=-3)


def dct_compress_residual_signed(resid: torch.Tensor, qf: float) -> torch.Tensor:
    """Signed residual [..., 3, H, W] (integers in [-255, 255]) -> int16
    quantized coefficient planes."""
    ycc = signed_bgr_to_ycc(resid.to(torch.float32))
    d = dct2_blocks(plane_to_blocks(ycc, BS))
    q = quant_tables(qf, resid.device)[:, None, None]
    return blocks_to_plane(torch.round(d / q)).to(torch.int16)


def dct_decompress_residual_signed(coeffs: torch.Tensor, qf: float) -> torch.Tensor:
    """int16 coefficient planes [..., 3, H, W] -> signed residual int32."""
    q = quant_tables(qf, coeffs.device)[:, None, None]
    v = idct2_blocks(plane_to_blocks(coeffs.to(torch.float32), BS) * q)
    return torch.round(signed_ycc_to_bgr(blocks_to_plane(v))).to(torch.int32)


def encode_p_coeffs_plain(mv, refs, curs, qf: float) -> torch.Tensor:
    """Plain K3: round(DCT(RCT(curs - compensate(refs, mv))) / Q) as int16.
    mv [G, F, nbh, nbw, 2], refs [G, 3, H, W], curs [G, F, 3, H, W]."""
    pred = motion_compensate_gops(mv, refs, bs=BS, backend="plain")
    return dct_compress_residual_signed(
        curs.to(torch.int32) - pred.to(torch.int32), qf)


def decode_p_frames_plain(mv, refs, coeffs, qf: float) -> torch.Tensor:
    """Plain K4: clip(compensate(refs, mv) + residual(coeffs), 0, 255) as
    uint8 [G, F, 3, H, W]."""
    pred = motion_compensate_gops(mv, refs, bs=BS, backend="plain")
    out = pred.to(torch.int32) + dct_decompress_residual_signed(coeffs, qf)
    return out.clamp_(0, 255).to(torch.uint8)


@functools.lru_cache(maxsize=None)
def _tables(qf: float, device: torch.device) -> torch.Tensor:
    """[D, QY, QC] float32, 192 values on the device: the kernels' constant
    operands, uploaded once per quality factor."""
    qy, qc = quant_tables_np(qf)
    tabs = np.concatenate([dct_matrix_np(BS).astype(np.float32).ravel(),
                           qy.astype(np.float32).ravel(),
                           qc.astype(np.float32).ravel()])
    return torch.from_numpy(tabs).to(device)


def _check_operands(name, mv, refs, data, data_dtype):
    for arg, t, dt, nd in (("mv", mv, torch.int32, 5),
                           ("refs", refs, torch.uint8, 4),
                           ("data", data, data_dtype, 5)):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, got "
                             f"{t.device}")
        if t.dtype != dt or t.ndim != nd or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous {dt} with "
                             f"{nd} dims, got {t.dtype} {tuple(t.shape)}")
    g, f, c, h, w = data.shape
    if c != 3 or h % BS or w % BS or g == 0 or f == 0:
        raise ValueError(f"{name}: needs [G>=1, F>=1, 3, H, W] with H, W "
                         f"multiples of {BS}, got {tuple(data.shape)}")
    if tuple(refs.shape) != (g, 3, h, w) \
            or tuple(mv.shape) != (g, f, h // BS, w // BS, 2):
        raise ValueError(f"{name}: refs {tuple(refs.shape)} / mv "
                         f"{tuple(mv.shape)} do not match {tuple(data.shape)}")
    if not (mv.device == refs.device == data.device):
        raise ValueError(f"{name}: operands on different devices")
    if g * f > 65535 or h // BS > 65535:
        raise ValueError(f"{name}: grid too large for {tuple(data.shape)}")


def _launch(entry: str, counter: str, mv, refs, data, qf, out):
    lib = _build.load_library()
    tabs = _tables(float(qf), data.device)
    g, f, _, h, w = data.shape
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(mv.data_ptr(), refs.data_ptr(),
                                  data.data_ptr(), tabs.data_ptr(),
                                  out.data_ptr(), g, f, h, w, stream)
    _build.check(err, counter)
    LAUNCHES[counter] += 1
    return out


def fused_p_encode(mv: torch.Tensor, refs: torch.Tensor, curs: torch.Tensor,
                   qf: float) -> torch.Tensor:
    """K3 on the card: mv int32 [G, F, nbh, nbw, 2], refs uint8 [G, 3, H, W],
    curs uint8 [G, F, 3, H, W] -> int16 coefficients [G, F, 3, H, W]."""
    _check_operands("fused_p_encode", mv, refs, curs, torch.uint8)
    out = torch.empty(curs.shape, dtype=torch.int16, device=curs.device)
    return _launch("vcs_fused_p_encode", "fused_p_encode", mv, refs, curs,
                   qf, out)


def fused_p_decode(mv: torch.Tensor, refs: torch.Tensor, coeffs: torch.Tensor,
                   qf: float) -> torch.Tensor:
    """K4 on the card: mv int32, refs uint8 [G, 3, H, W], coeffs int16
    [G, F, 3, H, W] -> decoded frames uint8 [G, F, 3, H, W]."""
    _check_operands("fused_p_decode", mv, refs, coeffs, torch.int16)
    out = torch.empty(coeffs.shape, dtype=torch.uint8, device=coeffs.device)
    return _launch("vcs_fused_p_decode", "fused_p_decode", mv, refs, coeffs,
                   qf, out)


def encode_p_coeffs(mv, refs, curs, qf: float, backend: str = "auto"):
    """K3 on a CUDA tensor, its plain version on a CPU tensor or when
    backend == "plain"."""
    check_backend(backend)
    if backend == "plain" or curs.device.type == "cpu":
        return encode_p_coeffs_plain(mv, refs, curs, qf)
    return fused_p_encode(mv, refs, curs, qf)


def decode_p_frames(mv, refs, coeffs, qf: float, backend: str = "auto"):
    """K4 on a CUDA tensor, its plain version on a CPU tensor or when
    backend == "plain"."""
    check_backend(backend)
    if backend == "plain" or coeffs.device.type == "cpu":
        return decode_p_frames_plain(mv, refs, coeffs, qf)
    return fused_p_decode(mv, refs, coeffs, qf)
