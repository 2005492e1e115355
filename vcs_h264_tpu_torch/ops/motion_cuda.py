"""Wrappers of the motion kernels (counterpart of
`vcs_h264_tpu/ops/motion_pallas.py`): K2 `csrc/motion_sad.cu`, frames in,
motion vectors out; K1 `csrc/motion_comp.cu`, vectors and references in,
compensated frames out.

The kernels' plain PyTorch versions are `ops.motion.motion_search_plain`
and `ops.motion.motion_compensate_plain`; these wrappers take CUDA tensors
only and raise on anything else.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from vcs_h264_tpu_torch.ops import _build
from vcs_h264_tpu_torch.ops.motion import key_packing, make_plan

# Launches of each kernel of this module, counted where the kernel launches.
LAUNCHES = {"sad_search": 0, "compensate": 0}

# The forms of K2 (`csrc/motion_sad.cu`), in the numbering of its C entry
# point vcs_sad_search_form, and the launches of each.
SAD_FORMS = ("words", "bytes", "direct")
FORMS = dict.fromkeys(SAD_FORMS, 0)
_MAX_THREADS = 1024
_MAX_SHARED = 232448          # dynamic shared memory a block may opt into
_INT32 = 2**31


def padded_copy_words(c_words: int, k: int, step: int, n_w: int) -> int:
    """The word kernel's stride between its four shifted window copies: the
    least padding of c_words (0 to 31 words) for which the candidates of
    each warp fall on the fewest common banks, as the C source picks it."""
    cand = np.arange(k * k)
    col = step * (cand % k)
    base = step * (cand // k) * n_w + (col >> 2)
    warp = cand // 32
    costs = []
    for pad in range(32):
        bank = ((col & 3) * (c_words + pad) + base) & 31
        hits = np.zeros((warp[-1] + 1, 32), dtype=np.int64)
        np.add.at(hits, (warp, bank), 1)
        costs.append(int(hits.max(axis=1).sum()))
    return c_words + int(np.argmin(costs))


@functools.lru_cache(maxsize=None)
def sad_search_form(c: int, bs: int, reach: int, step: int,
                    aligned: bool) -> tuple:
    """Which kernel K2 launches for this geometry, by shape alone ->
    (form, dynamic shared bytes, threads per block); what the C entry
    point vcs_sad_search_form reports.

    "words" takes block sizes 4, 8 and 16 with both operands on a 4-byte
    boundary where the window's four shifted word copies fit a block's
    shared memory; "bytes" any block size and alignment where the window
    and the current block fit as bytes; "direct" stages nothing and takes
    every other geometry."""
    k = -(-2 * reach // step)
    win = max(step * (k - 1), reach) + bs
    threads = min(-(-k * k // 32) * 32, _MAX_THREADS)
    n_w = (win + 6) // 4
    block_words = 8 * c * bs * (bs // 4)
    if bs in (4, 8, 16) and aligned \
            and block_words + 16 * c * win * n_w <= _MAX_SHARED:
        shmem = block_words + 16 * padded_copy_words(c * win * n_w, k, step,
                                                     n_w)
        if shmem <= _MAX_SHARED:
            return "words", shmem, threads
    shmem = c * bs * bs + c * win * win
    if shmem <= _MAX_SHARED:
        return "bytes", shmem, threads
    return "direct", 0, threads


def sad_search_form_c(c: int, bs: int, reach: int, step: int,
                      aligned: bool) -> tuple:
    """`sad_search_form` as the built library answers it."""
    shmem, threads = ctypes.c_int(), ctypes.c_int()
    form = _build.load_library().vcs_sad_search_form(
        c, bs, reach, step, int(aligned), ctypes.byref(shmem),
        ctypes.byref(threads))
    return SAD_FORMS[form], shmem.value, threads.value


def sad_search(curs: torch.Tensor, refs: torch.Tensor, *, bs: int = 8,
               reach: int = 16, step: int = 3,
               static_threshold: int = 2000) -> torch.Tensor:
    """curs uint8 [G, F, C, H, W], refs uint8 [G, C, H, W], both contiguous
    on one CUDA device -> motion vectors int32 [G, F, nbh, nbw, 2] (dx, dy).
    Any geometry the search admits (`make_plan`, `key_packing`), in the
    form `sad_search_form` picks."""
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
    if plan.k < 1:
        raise ValueError(f"sad_search: reach={reach} gives no candidates")
    if 2 * (reach + step) + bs >= _INT32:
        raise ValueError(f"sad_search: reach={reach}, step={step} exceed "
                         "the kernels' int32 positions")
    aligned = (curs.data_ptr() | refs.data_ptr()) % 4 == 0
    form = sad_search_form(c, bs, reach, step, aligned)[0]
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
    FORMS[form] += 1
    return out


# The forms of K1 (`csrc/motion_comp.cu`), as its C entry point takes them.
FORM_GENERAL, FORM_FAST = 0, 1
_GRID_X, _GRID_YZ = 2**31 - 1, 65535          # CUDA's grid limits
_FAST_THREADS, _FAST_BYTES = 256, 16          # a CTA; output bytes a thread


def compensate_form(bs: int, w: int, refs_ptr: int, out_ptr: int) -> int:
    """Which kernel K1 launches: the fast form (16-byte stores, source rows
    cut out of aligned 4-byte words) takes block sizes 4, 8 and 16 on rows
    that are multiples of 16 bytes, with refs on a 4-byte and out on a
    16-byte boundary; the general form takes everything else."""
    fast = (bs in (4, 8, 16) and w % _FAST_BYTES == 0 and refs_ptr % 4 == 0
            and out_ptr % _FAST_BYTES == 0)
    return FORM_FAST if fast else FORM_GENERAL


def compensate_grid_fits(form: int, gf: int, h: int, w: int, bs: int) -> bool:
    """Whether the form's grid can be launched: the fast form flattens its
    work items (a 16-byte column of a block row of a frame) over grid x,
    the general form puts the frames on z, the pixel rows on y."""
    if h * w >= 2**31:                         # int32 offsets within a plane
        return False
    if form == FORM_FAST:
        items = gf * (h // bs) * (w // _FAST_BYTES)
        return -(-items // _FAST_THREADS) <= _GRID_X
    return gf <= _GRID_YZ and h <= _GRID_YZ


def compensate(mv: torch.Tensor, refs: torch.Tensor, *, bs: int,
               form: int | None = None,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """K1 on the card: mv int32 [G, F, nbh, nbw, 2] (dx, dy), refs uint8
    [G, C, H, W], both contiguous on one CUDA device -> compensated frames
    uint8 [G, F, C, H, W]. Any vector; bs >= 2 dividing H and W. `form`
    None: as `compensate_form` chooses; FORM_GENERAL asks for the general
    form where the fast one would do. `out`: a contiguous uint8 tensor of
    the result's shape to write into instead of a new one."""
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
    if out is None:
        out = torch.empty((g, f, c, h, w), dtype=torch.uint8,
                          device=refs.device)
    elif out.dtype != torch.uint8 or tuple(out.shape) != (g, f, c, h, w) \
            or out.device != refs.device or not out.is_contiguous():
        raise ValueError(f"compensate: out must be contiguous uint8 "
                         f"{(g, f, c, h, w)} on {refs.device}")
    chosen = compensate_form(bs, w, refs.data_ptr(), out.data_ptr())
    if form is None:
        form = chosen
    elif form not in (FORM_GENERAL, chosen):
        raise ValueError(f"compensate: the fast form does not take bs {bs}, "
                         f"width {w} or these operands' alignment")
    if not compensate_grid_fits(form, g * f, h, w, bs):
        raise ValueError(f"compensate: grid too large for G*F={g * f}, "
                         f"{h}x{w}")
    lib = _build.load_library()
    with torch.cuda.device(refs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vcs_compensate(mv.data_ptr(), refs.data_ptr(),
                                 out.data_ptr(), g, f, c, h, w, bs, form,
                                 stream)
    _build.check(err, "compensate")
    LAUNCHES["compensate"] += 1
    return out
