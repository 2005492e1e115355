"""Wrappers of the motion kernels (counterpart of
`vcs_h264_tpu/ops/motion_pallas.py`): K2 `csrc/motion_sad.cu`, frames in,
motion vectors out; K1 `csrc/motion_comp.cu`, vectors and references in,
compensated frames out.

The kernels' plain PyTorch versions are `ops.motion.motion_search_plain`
and `ops.motion.motion_compensate_plain`; these wrappers take CUDA tensors
only and raise on anything else.
"""

from __future__ import annotations

import torch

from vcs_h264_tpu_torch.ops import _build
from vcs_h264_tpu_torch.ops.motion import key_packing, make_plan

# Launches of each kernel of this module, counted where the kernel launches.
LAUNCHES = {"sad_search": 0, "compensate": 0}

_SHMEM_LIMIT = 48 * 1024      # static launch limit without opt-in


def sad_search(curs: torch.Tensor, refs: torch.Tensor, *, bs: int = 8,
               reach: int = 16, step: int = 3,
               static_threshold: int = 2000) -> torch.Tensor:
    """curs uint8 [G, F, C, H, W], refs uint8 [G, C, H, W], both contiguous
    on one CUDA device -> motion vectors int32 [G, F, nbh, nbw, 2] (dx, dy)."""
    for name, t, nd in (("curs", curs, 5), ("refs", refs, 4)):
        if t.device.type != "cuda":
            raise ValueError(f"sad_search: {name} must be a CUDA tensor, "
                             f"got {t.device}")
        if t.dtype != torch.uint8 or t.ndim != nd or not t.is_contiguous():
            raise ValueError(f"sad_search: {name} must be contiguous uint8 "
                             f"with {nd} dims, got {t.dtype} "
                             f"{tuple(t.shape)}")
    g, f, c, h, w = curs.shape
    if refs.device != curs.device or tuple(refs.shape) != (g, c, h, w):
        raise ValueError(f"sad_search: refs {tuple(refs.shape)} on "
                         f"{refs.device} does not match curs "
                         f"{tuple(curs.shape)} on {curs.device}")
    if g == 0 or f == 0:
        raise ValueError("sad_search: needs at least one GOP and one frame")
    if g > 65535 or h // bs > 65535:
        raise ValueError(f"sad_search: grid too large for G={g}, H={h}")
    plan = make_plan(h, w, bs, reach, step)
    key_packing(plan, c)                         # raises on int32 overflow
    win = max(step * (plan.k - 1), reach) + bs
    if 4 * c * bs * bs + c * win * win > _SHMEM_LIMIT or plan.k * plan.k > 1024:
        raise ValueError(f"sad_search: reach={reach}, step={step}, bs={bs} "
                         "exceed the kernel's shared memory or thread limit")
    lib = _build.load_library()
    out = torch.empty((g, f, plan.nbh, plan.nbw, 2), dtype=torch.int32,
                      device=curs.device)
    with torch.cuda.device(curs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vcs_sad_search(curs.data_ptr(), refs.data_ptr(),
                                 out.data_ptr(), g, f, c, h, w, bs, reach,
                                 step, static_threshold, stream)
    _build.check(err, "sad_search")
    LAUNCHES["sad_search"] += 1
    return out


def compensate(mv: torch.Tensor, refs: torch.Tensor, *, bs: int) -> torch.Tensor:
    """K1 on the card: mv int32 [G, F, nbh, nbw, 2] (dx, dy), refs uint8
    [G, C, H, W], both contiguous on one CUDA device -> compensated frames
    uint8 [G, F, C, H, W]. Any vector; bs >= 2 dividing H and W."""
    operands = (("mv", mv, torch.int32, 5), ("refs", refs, torch.uint8, 4))
    for name, t, dt, nd in operands:
        if t.dtype != dt or t.ndim != nd or not t.is_contiguous():
            raise ValueError(f"compensate: {name} must be contiguous {dt} "
                             f"with {nd} dims, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t, _, _ in operands:
        if t.device.type != "cuda":
            raise ValueError(f"compensate: {name} must be a CUDA tensor, "
                             f"got {t.device}")
    g, c, h, w = refs.shape
    f = mv.shape[1]
    if bs < 2 or h % bs or w % bs:
        raise ValueError(f"compensate: block size {bs} must be >= 2 and "
                         f"divide the frame {h}x{w}")
    if mv.device != refs.device \
            or tuple(mv.shape) != (g, f, h // bs, w // bs, 2):
        raise ValueError(f"compensate: mv {tuple(mv.shape)} on {mv.device} "
                         f"does not match refs {tuple(refs.shape)} on "
                         f"{refs.device} at block size {bs}")
    if g == 0 or f == 0 or c == 0:
        raise ValueError("compensate: needs at least one GOP, frame and "
                         "channel")
    if g * f > 65535 or h > 65535 or h * w >= 2**31:
        raise ValueError(f"compensate: grid too large for G*F={g * f}, "
                         f"{h}x{w}")
    lib = _build.load_library()
    out = torch.empty((g, f, c, h, w), dtype=torch.uint8, device=refs.device)
    with torch.cuda.device(refs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vcs_compensate(mv.data_ptr(), refs.data_ptr(),
                                 out.data_ptr(), g, f, c, h, w, bs, stream)
    _build.check(err, "compensate")
    LAUNCHES["compensate"] += 1
    return out
