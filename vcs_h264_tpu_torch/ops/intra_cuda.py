"""Wrappers of the K5 / K6 CUDA kernels in `csrc/intra_wavefront.cu`
(counterpart of `vcs_h264_tpu/ops/intra_pallas.py`): the closed-loop lossy
4x4 intra encode and the wavefront intra decode, lossy or lossless.

The kernels' plain PyTorch versions are `ops.intra.intra_encode4x4_lossy_plain`
and `ops.intra.decode_planes_plain`; these wrappers take CUDA tensors only and
raise on anything else.
"""

from __future__ import annotations

import torch

from vcs_h264_tpu_torch.ops import _build
from vcs_h264_tpu_torch.utils.profiling import add_counts

# Launches of each kernel of this module, counted where the kernel launches.
# K5's launches are also the count `intra_launches` of the innermost open
# span, while spans are recorded, and those in the direct form
# (`encode_form`) the count `intra_direct_launches`.
LAUNCHES = {"intra_encode": 0, "intra_decode": 0}

_SHMEM_MAX = 232448           # dynamic shared memory a block may opt into
_SHMEM_PER_ROW = 20 * 4       # the carry of one block row, in bytes (the
                              # int form, which the tallest planes take)
FAST_DECODE_ROWS = 9 * 32     # block rows up to which the clipped decode
                              # takes its fast form (kDecRowWarps warps)
# K5's forms by block rows: the staged form, a thread per block row in up
# to 8 row warps (kEncRowWarps); the tall form, 9 row warps (kTallRowWarps)
# while a block row's carry and staged outputs, 5 + 201 words, fit in
# shared memory (kTallRows); the direct form past it.
STAGED_ENCODE_ROWS = 8 * 32
TALL_ENCODE_ROWS = min(9 * 32, _SHMEM_MAX // (4 * (5 + 201)))


def _check(name: str, arg: str, t: torch.Tensor, dtype, ndim: int,
           align: int = 1) -> None:
    """`align`: bytes the start must be a multiple of, for the kernels'
    4-pixel vector loads (uchar4, short4)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: {arg} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: {arg} must be contiguous {dtype} with "
                         f"{ndim} dims, got {t.dtype} {tuple(t.shape)}")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: {arg} must start on a {align}-byte "
                         "boundary")


def _check_shape(name: str, n: int, h: int, w: int) -> None:
    if n == 0 or h == 0 or w == 0 or h % 4 or w % 4:
        raise ValueError(f"{name}: needs [N>=1, H, W] with H, W positive "
                         f"multiples of 4, got {(n, h, w)}")
    if n > 2**31 - 1:
        raise ValueError(f"{name}: {(n, h, w)} is too large")
    if (h // 4) * _SHMEM_PER_ROW > _SHMEM_MAX:
        raise ValueError(f"{name}: H={h} needs more shared memory than a "
                         "block has")


def _check_qstep(name: str, qstep: int, lo: int) -> None:
    if not lo <= qstep <= 65535:
        raise ValueError(f"{name}: qstep must be in [{lo}, 65535], got "
                         f"{qstep}")


_NUMERATOR_BITS = 25          # 2 * 25 * 36 * 255 + 400 * 65535 < 2**25


def quant_magic(qstep: int) -> tuple[int, int]:
    """(magic, shift) with n // (800 * qstep) == (n * magic) >> (32 + shift)
    for every 0 <= n < 2**25: the forward quantiser's division, which K5
    takes as one high multiply and one shift. Its numerators are
    2 * |coefficient * 400 G| + 400 * qstep with |coefficient| <= 36 * 255
    and 400 G <= 25, below 2**25 for every qstep the wrapper admits.

    Round-up method: with l = ceil(log2 d) and magic = ceil(2**(25 + l) / d),
    magic * d - 2**(25 + l) < d <= 2**l, which bounds the error of the
    product below one step of the quotient for n < 2**25."""
    d = 800 * qstep
    k = _NUMERATOR_BITS + (d - 1).bit_length()
    return -(-(1 << k) // d), k - 32


def encode_form(h: int) -> int:
    """The row warps K5 launches with on planes of `h` pixel rows, which
    `vcs_intra_encode` takes as its form: ceil(nbh / 32) up to
    STAGED_ENCODE_ROWS block rows (the staged form), 9 up to
    TALL_ENCODE_ROWS (the tall form), 0 past it (the direct form, which
    loads and stores on the chain)."""
    nbh = h // 4
    if nbh <= STAGED_ENCODE_ROWS:
        return -(-nbh // 32)
    return 9 if nbh <= TALL_ENCODE_ROWS else 0


def intra_encode(planes: torch.Tensor, qstep: int):
    """K5 on the card: planes uint8 [N, H, W] -> (qcoef int16 [N, H, W]
    block-layout planes, modes int8 [N, H/4, W/4], escape bool [N, H/4,
    W/4], recon uint8 [N, H, W])."""
    name = "intra_encode"
    _check(name, "planes", planes, torch.uint8, 3, align=4)
    n, h, w = planes.shape
    _check_shape(name, n, h, w)
    _check_qstep(name, qstep, 1)
    dev = planes.device
    qcoef = torch.empty((n, h, w), dtype=torch.int16, device=dev)
    modes = torch.empty((n, h // 4, w // 4), dtype=torch.int8, device=dev)
    escape = torch.empty((n, h // 4, w // 4), dtype=torch.bool, device=dev)
    recon = torch.empty((n, h, w), dtype=torch.uint8, device=dev)
    row_warps = encode_form(h)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vcs_intra_encode(planes.data_ptr(), qcoef.data_ptr(),
                                   modes.data_ptr(), escape.data_ptr(),
                                   recon.data_ptr(), n, h, w, qstep,
                                   *quant_magic(qstep), row_warps, stream)
    _build.check(err, name)
    LAUNCHES[name] += 1
    add_counts(intra_launches=1, intra_direct_launches=int(row_warps == 0))
    return qcoef, modes, escape, recon


def intra_decode(res: torch.Tensor, modes: torch.Tensor, escape: torch.Tensor,
                 qstep: int, clip: bool) -> torch.Tensor:
    """K6 on the card: res int16 [N, H, W] (block-layout quantized
    coefficients when qstep > 0, exact residuals when qstep == 0), modes
    int8 and escape bool [N, H/4, W/4] -> reconstructed planes [N, H, W],
    uint8 when `clip`, int32 otherwise."""
    name = "intra_decode"
    _check(name, "res", res, torch.int16, 3, align=8)
    _check(name, "modes", modes, torch.int8, 3)
    _check(name, "escape", escape, torch.bool, 3)
    n, h, w = res.shape
    _check_shape(name, n, h, w)
    _check_qstep(name, qstep, 0)
    if tuple(modes.shape) != (n, h // 4, w // 4) \
            or escape.shape != modes.shape:
        raise ValueError(f"{name}: modes {tuple(modes.shape)} / escape "
                         f"{tuple(escape.shape)} do not match res "
                         f"{tuple(res.shape)}")
    if not (res.device == modes.device == escape.device):
        raise ValueError(f"{name}: operands on different devices")
    out = torch.empty((n, h, w), dtype=torch.uint8 if clip else torch.int32,
                      device=res.device)
    # the fast form dequantises every block ahead of the chain, into scratch
    scratch = (torch.empty_like(res)
               if clip and qstep and h // 4 <= FAST_DECODE_ROWS else None)
    lib = _build.load_library()
    with torch.cuda.device(res.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vcs_intra_decode(
            res.data_ptr(), modes.data_ptr(), escape.data_ptr(),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            n, h, w, qstep, int(bool(clip)), stream)
    _build.check(err, name)
    LAUNCHES[name] += 1
    return out
