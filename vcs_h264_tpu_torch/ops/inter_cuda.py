"""Fused P-frame encode (K3) and decode (K4) and the fused 4:2:0 chroma
encode and decode (K7): wrappers of the CUDA kernels in `csrc/inter_fused.cu`
and `csrc/inter_plane.cu` and their plain PyTorch versions (counterpart of
`vcs_h264_tpu/ops/inter_pallas.py`, with the production residual coding of
`vcs_h264_tpu/models/pipeline.py:87-131` and the per-plane coding of
`vcs_h264_tpu/models/pipeline420.py:110-119`).

The production residual path codes the SIGNED residual cur - prediction
through an 8x8 DCT and round-half-even quantization to int16; decode runs
it backwards, rounds, adds the prediction back and clips to [0, 255]. On
full-resolution BGR frames (C == 3) the residual first passes a linear,
offset-free RCT (the cv2 YCrCb factors) and the planes take the Y, C, C
tables. On a bare plane there is no colour transform: the 4:2:0 luma plane
(C == 1, the same entry points) takes the luma table on an 8-pixel motion
grid, and the two 4:2:0 chroma planes (`encode_c420_coeffs` /
`decode_c420_frames`) take the chroma table on a 4-pixel motion grid, four
vectors under each 8x8 transform block.

The dispatchers send CUDA tensors to the kernels and CPU tensors to the
plain versions; `backend="plain"` asks for the plain versions on any device
(the reference the kernels are held against).
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
LAUNCHES = {"fused_p_encode": 0, "fused_p_decode": 0, "plane_encode": 0,
            "plane_decode": 0, "c420_encode": 0, "c420_decode": 0}

BS = 8


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    # A float32 tensor on the input's device: dividing by a Python scalar on
    # a GPU multiplies by its reciprocal, which is not IEEE division.
    return _const_on(v, like.device)


@functools.lru_cache(maxsize=None)
def _const_on(v: float, device: torch.device) -> torch.Tensor:
    # one upload per value and device (on a GPU each is a host sync); shared
    return torch.tensor(v, dtype=torch.float32, device=device)


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


def code_planes(resid: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Signed residual planes [..., H, W] -> int16 coefficients quantized by
    the [8, 8] table; no colour transform."""
    d = dct2_blocks(plane_to_blocks(resid.to(torch.float32), BS))
    return blocks_to_plane(torch.round(d / table)).to(torch.int16)


def decode_planes(coeffs: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """int16 coefficient planes [..., H, W] -> signed residual int32."""
    v = idct2_blocks(plane_to_blocks(coeffs.to(torch.float32), BS) * table)
    return torch.round(blocks_to_plane(v)).to(torch.int32)


def _bare_encode_plain(mv, refs, curs, qf: float, mvbs: int, qsel: int):
    pred = motion_compensate_gops(mv, refs, bs=mvbs, backend="plain")
    return code_planes(curs.to(torch.int32) - pred.to(torch.int32),
                       quant_tables(qf, refs.device)[qsel])


def _bare_decode_plain(mv, refs, coeffs, qf: float, mvbs: int, qsel: int):
    pred = motion_compensate_gops(mv, refs, bs=mvbs, backend="plain")
    out = pred.to(torch.int32) + decode_planes(
        coeffs, quant_tables(qf, refs.device)[qsel])
    return out.clamp_(0, 255).to(torch.uint8)


def encode_p_coeffs_plain(mv, refs, curs, qf: float) -> torch.Tensor:
    """Plain K3: round(DCT(RCT(curs - compensate(refs, mv))) / Q) as int16.
    mv [G, F, nbh, nbw, 2], refs [G, C, H, W], curs [G, F, C, H, W]; C == 3
    as above, C == 1 a bare plane (no RCT, the luma table)."""
    if refs.shape[1] == 1:
        return _bare_encode_plain(mv, refs, curs, qf, BS, 0)
    pred = motion_compensate_gops(mv, refs, bs=BS, backend="plain")
    return dct_compress_residual_signed(
        curs.to(torch.int32) - pred.to(torch.int32), qf)


def decode_p_frames_plain(mv, refs, coeffs, qf: float) -> torch.Tensor:
    """Plain K4: clip(compensate(refs, mv) + residual(coeffs), 0, 255) as
    uint8 [G, F, C, H, W], C == 3 or a bare plane (C == 1)."""
    if refs.shape[1] == 1:
        return _bare_decode_plain(mv, refs, coeffs, qf, BS, 0)
    pred = motion_compensate_gops(mv, refs, bs=BS, backend="plain")
    out = pred.to(torch.int32) + dct_decompress_residual_signed(coeffs, qf)
    return out.clamp_(0, 255).to(torch.uint8)


def encode_c420_coeffs_plain(mv_c, c_refs, c_curs, qf: float) -> torch.Tensor:
    """Plain K7 encode: chroma vectors mv_c [G, F, Hc/4, Wc/4, 2] on a
    4-pixel grid, c_refs [G, 2, Hc, Wc], c_curs [G, F, 2, Hc, Wc] -> int16
    coefficients, the chroma table on both planes."""
    return _bare_encode_plain(mv_c, c_refs, c_curs, qf, BS // 2, 1)


def decode_c420_frames_plain(mv_c, c_refs, coeffs, qf: float) -> torch.Tensor:
    """Plain K7 decode -> uint8 chroma planes [G, F, 2, Hc, Wc]."""
    return _bare_decode_plain(mv_c, c_refs, coeffs, qf, BS // 2, 1)


@functools.lru_cache(maxsize=None)
def _tables_np(qf: float) -> np.ndarray:
    """[D, QY, QC] float32, 192 values in host memory (cached: every kernel
    of this module takes them from there as its parameter, so the array
    must live)."""
    qy, qc = quant_tables_np(qf)
    return np.concatenate([dct_matrix_np(BS).astype(np.float32).ravel(),
                           qy.astype(np.float32).ravel(),
                           qc.astype(np.float32).ravel()])


def _check_operands(name, mv, refs, data, data_dtype, c: int, mvbs: int):
    """`c`: the channels the kernel takes; `mvbs`: the side of its motion
    grid's cells."""
    for arg, t, dt, nd in (("mv", mv, torch.int32, 5),
                           ("refs", refs, torch.uint8, 4),
                           ("data", data, data_dtype, 5)):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, got "
                             f"{t.device}")
        if t.dtype != dt or t.ndim != nd or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous {dt} with "
                             f"{nd} dims, got {t.dtype} {tuple(t.shape)}")
    g, f, cc, h, w = data.shape
    if cc != c or h % BS or w % BS or g == 0 or f == 0 or h == 0 or w == 0:
        raise ValueError(f"{name}: needs [G>=1, F>=1, {c}, H, W] with H, W "
                         f"positive multiples of {BS}, got "
                         f"{tuple(data.shape)}")
    if tuple(refs.shape) != (g, c, h, w) \
            or tuple(mv.shape) != (g, f, h // mvbs, w // mvbs, 2):
        raise ValueError(f"{name}: refs {tuple(refs.shape)} / mv "
                         f"{tuple(mv.shape)} do not match {tuple(data.shape)}")
    if not (mv.device == refs.device == data.device):
        raise ValueError(f"{name}: operands on different devices")
    if g * f > 65535 or h // BS > 65535:          # grid (strips, nbh, G*F)
        raise ValueError(f"{name}: grid too large for {tuple(data.shape)}")


def _check_aligned(name: str, arg: str, t: torch.Tensor, align: int) -> None:
    if t.data_ptr() % align:
        raise ValueError(f"{name}: {arg} must start on a {align}-byte "
                         "boundary")


# What the strip kernels' wide accesses need, (operand, bytes) each, in the
# order mv, data, refs, out: 16-byte loads or stores of int16 rows, 8-byte
# ones of uint8 rows, reference rows cut out of aligned 4-byte words, a
# block's vector as one 8-byte load and the two vectors under a row of a
# chroma block (cells of 4) as one 16-byte load.
_ALIGNMENTS = {
    "fused_p_encode": (("mv", 4), ("curs", 8), ("refs", 4), ("out", 16)),
    "fused_p_decode": (("mv", 4), ("coeffs", 16), ("refs", 4), ("out", 8)),
    "plane_encode": (("mv", 8), ("curs", 8), ("refs", 4), ("out", 16)),
    "plane_decode": (("mv", 8), ("coeffs", 16), ("refs", 4), ("out", 8)),
    "c420_encode": (("mv", 16), ("curs", 8), ("refs", 4), ("out", 16)),
    "c420_decode": (("mv", 16), ("coeffs", 16), ("refs", 4), ("out", 8)),
}


def _launch(entry: str, counter: str, mv, refs, data, qf, out):
    for (arg, align), t in zip(_ALIGNMENTS[counter], (mv, data, refs, out)):
        _check_aligned(counter, arg, t, align)
    lib = _build.load_library()
    tabs_ptr = _tables_np(float(qf)).ctypes.data
    g, f, _, h, w = data.shape
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(mv.data_ptr(), refs.data_ptr(),
                                  data.data_ptr(), tabs_ptr,
                                  out.data_ptr(), g, f, h, w, stream)
    _build.check(err, counter)
    LAUNCHES[counter] += 1
    return out


def _encode_on_card(name: str, mv, refs, curs, qf, c: int, mvbs: int):
    _check_operands(name, mv, refs, curs, torch.uint8, c, mvbs)
    out = torch.empty(curs.shape, dtype=torch.int16, device=curs.device)
    return _launch(f"vcs_{name}", name, mv, refs, curs, qf, out)


def _decode_on_card(name: str, mv, refs, coeffs, qf, c: int, mvbs: int):
    _check_operands(name, mv, refs, coeffs, torch.int16, c, mvbs)
    out = torch.empty(coeffs.shape, dtype=torch.uint8, device=coeffs.device)
    return _launch(f"vcs_{name}", name, mv, refs, coeffs, qf, out)


def fused_p_encode(mv: torch.Tensor, refs: torch.Tensor, curs: torch.Tensor,
                   qf: float) -> torch.Tensor:
    """K3 on the card: mv int32 [G, F, nbh, nbw, 2], refs uint8 [G, 3, H, W],
    curs uint8 [G, F, 3, H, W] -> int16 coefficients [G, F, 3, H, W]."""
    return _encode_on_card("fused_p_encode", mv, refs, curs, qf, 3, BS)


def fused_p_decode(mv: torch.Tensor, refs: torch.Tensor, coeffs: torch.Tensor,
                   qf: float) -> torch.Tensor:
    """K4 on the card: mv int32, refs uint8 [G, 3, H, W], coeffs int16
    [G, F, 3, H, W] -> decoded frames uint8 [G, F, 3, H, W]."""
    return _decode_on_card("fused_p_decode", mv, refs, coeffs, qf, 3, BS)


def plane_encode(mv: torch.Tensor, refs: torch.Tensor, curs: torch.Tensor,
                 qf: float) -> torch.Tensor:
    """The bare-plane case of K3 on the card: mv int32 [G, F, H/8, W/8, 2],
    refs uint8 [G, 1, H, W], curs uint8 [G, F, 1, H, W] -> int16
    coefficients [G, F, 1, H, W] (the luma table, no colour transform)."""
    return _encode_on_card("plane_encode", mv, refs, curs, qf, 1, BS)


def plane_decode(mv: torch.Tensor, refs: torch.Tensor, coeffs: torch.Tensor,
                 qf: float) -> torch.Tensor:
    """The bare-plane case of K4 on the card -> uint8 [G, F, 1, H, W]."""
    return _decode_on_card("plane_decode", mv, refs, coeffs, qf, 1, BS)


def c420_encode(mv_c: torch.Tensor, c_refs: torch.Tensor,
                c_curs: torch.Tensor, qf: float) -> torch.Tensor:
    """K7 encode on the card: chroma vectors mv_c int32 [G, F, Hc/4, Wc/4, 2]
    (any value), c_refs uint8 [G, 2, Hc, Wc], c_curs uint8 [G, F, 2, Hc, Wc],
    Hc and Wc multiples of 8 -> int16 coefficients [G, F, 2, Hc, Wc]."""
    return _encode_on_card("c420_encode", mv_c, c_refs, c_curs, qf, 2,
                           BS // 2)


def c420_decode(mv_c: torch.Tensor, c_refs: torch.Tensor,
                coeffs: torch.Tensor, qf: float) -> torch.Tensor:
    """K7 decode on the card -> uint8 chroma planes [G, F, 2, Hc, Wc]."""
    return _decode_on_card("c420_decode", mv_c, c_refs, coeffs, qf, 2,
                           BS // 2)


def _plain(backend: str, t: torch.Tensor) -> bool:
    check_backend(backend)
    return backend == "plain" or t.device.type == "cpu"


def encode_p_coeffs(mv, refs, curs, qf: float, backend: str = "auto"):
    """K3 on a CUDA tensor (its bare-plane case when C == 1), the plain
    version on a CPU tensor or when backend == "plain"."""
    if _plain(backend, curs):
        return encode_p_coeffs_plain(mv, refs, curs, qf)
    if refs.shape[1] == 1:
        return plane_encode(mv, refs, curs, qf)
    return fused_p_encode(mv, refs, curs, qf)


def decode_p_frames(mv, refs, coeffs, qf: float, backend: str = "auto"):
    """K4 on a CUDA tensor (its bare-plane case when C == 1), the plain
    version on a CPU tensor or when backend == "plain"."""
    if _plain(backend, coeffs):
        return decode_p_frames_plain(mv, refs, coeffs, qf)
    if refs.shape[1] == 1:
        return plane_decode(mv, refs, coeffs, qf)
    return fused_p_decode(mv, refs, coeffs, qf)


def encode_c420_coeffs(mv_c, c_refs, c_curs, qf: float,
                       backend: str = "auto"):
    """K7 encode on a CUDA tensor, its plain version on a CPU tensor or when
    backend == "plain"."""
    if _plain(backend, c_curs):
        return encode_c420_coeffs_plain(mv_c, c_refs, c_curs, qf)
    return c420_encode(mv_c, c_refs, c_curs, qf)


def decode_c420_frames(mv_c, c_refs, coeffs, qf: float,
                       backend: str = "auto"):
    """K7 decode on a CUDA tensor, its plain version on a CPU tensor or when
    backend == "plain"."""
    if _plain(backend, coeffs):
        return decode_c420_frames_plain(mv_c, c_refs, coeffs, qf)
    return c420_decode(mv_c, c_refs, coeffs, qf)
