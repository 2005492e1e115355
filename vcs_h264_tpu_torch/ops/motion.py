"""Block motion estimation and compensation (counterpart of
`vcs_h264_tpu/ops/motion.py`), reference-exact.

Semantics, as the JAX package pins them against the original Python
reference:
  * candidate positions p(b, k) = max(c_b - reach, 0) + step * k on each
    axis, valid iff p + bs < min(c_b + reach, extent);
  * the search SAD wraps like uint8 arithmetic and is ordered:
    sum (ref_candidate - cur) & 255;
  * selection is the first minimum in row-major (ki, kj) order, against a
    virtual initial best at absolute position (0, 0) that any valid
    candidate beats;
  * a block whose saturating co-located SAD sum max(ref - cur, 0) is
    <= static_threshold gets the zero vector;
  * vectors are (dx, dy), dx along the column (W) axis.

`motion_search_gops` and `motion_compensate_gops` (and their one-frame
wrappers `motion_search`, `motion_search_batch`, `motion_compensate`) send a
CUDA tensor to the hand-written kernels (`ops/motion_cuda.py`: K2 search, K1
compensation) and a CPU tensor to the plain PyTorch versions below; a plain
version runs on a CUDA tensor only when asked for by name
(`backend="plain"`), which is how the kernels are held against it on the
card.

Frames are planar: [..., C, H, W].
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

BACKENDS = ("auto", "plain")


class MotionSearchPlan(NamedTuple):
    """Static (host-precomputed) search geometry for a given frame shape."""
    bs: int
    reach: int
    step: int
    n_edge_i: int        # block rows whose window clamps at 0
    n_edge_j: int
    k: int               # candidates per axis
    nbh: int
    nbw: int
    h: int
    w: int
    # [nbh, K] / [nbw, K] candidate validity (p + bs < i_max)
    valid_i: np.ndarray
    valid_j: np.ndarray
    # [nbh, K] / [nbw, K] absolute candidate positions p = i_min + step*k
    pos_i: np.ndarray
    pos_j: np.ndarray


@functools.lru_cache(maxsize=None)
def make_plan(h: int, w: int, bs: int, reach: int, step: int) -> MotionSearchPlan:
    if h % bs or w % bs:
        raise ValueError(f"frame {h}x{w} must be a multiple of block {bs}")
    nbh, nbw = h // bs, w // bs
    k = -(-2 * reach // step)          # ceil(2*reach / step)
    n_edge = -(-reach // bs)           # ceil(reach / bs)

    def axis_plan(nb, extent):
        c = np.arange(nb) * bs
        lo = np.maximum(c - reach, 0)
        hi = np.minimum(c + reach, extent)
        pos = lo[:, None] + step * np.arange(k)[None, :]
        valid = pos + bs < hi[:, None]
        return pos.astype(np.int32), valid

    pos_i, valid_i = axis_plan(nbh, h)
    pos_j, valid_j = axis_plan(nbw, w)
    return MotionSearchPlan(bs, reach, step, min(n_edge, nbh), min(n_edge, nbw),
                            k, nbh, nbw, h, w, valid_i, valid_j, pos_i, pos_j)


def key_packing(plan: MotionSearchPlan, c: int):
    """(shift, sentinel) of the packed key (sad << sh) + flat index + 1."""
    k, bs = plan.k, plan.bs
    sh = (k * k + 1).bit_length()
    sad_max = c * 255 * bs * bs
    if (sad_max + 1) << sh >= 2**31:
        raise ValueError(f"search key packing overflows int32 for C={c}, "
                         f"bs={bs}, K={k}")
    return sh, (sad_max + 1) << sh


def tile_sums(x: torch.Tensor, bs: int) -> torch.Tensor:
    """[..., C, H, W] -> per-(bs x bs)-block sums over C: [..., H/bs, W/bs]
    int32."""
    *lead, c, h, w = x.shape
    x = x.reshape(*lead, c, h // bs, bs, w // bs, bs)
    return x.sum(dim=(-5, -3, -1), dtype=torch.int32)


def static_sad(curs: torch.Tensor, refs: torch.Tensor, bs: int) -> torch.Tensor:
    """Saturating co-located SAD sum max(ref - cur, 0): curs [..., C, H, W]
    against broadcastable refs -> [..., nbh, nbw] int32."""
    return tile_sums((refs.to(torch.int16) - curs.to(torch.int16)).clamp_(min=0),
                     bs)


def sad_candidates(curs: torch.Tensor, refs: torch.Tensor,
                   plan: MotionSearchPlan) -> torch.Tensor:
    """Exact wrapping SAD of every (block, candidate):
    curs [G, F, C, H, W], refs [G, C, H, W] -> [G, F, nbh, nbw, K, K] int32.

    Loops over the K x K candidate indices. Candidate (ki, kj) of block
    (bi, bj) sits at (pos_i[bi, ki], pos_j[bj, kj]), which is separable, so
    each step gathers one shifted copy of the reference with two
    index_selects; memory stays at a few frame-sized buffers at any K.
    Positions past the frame are clamped: only invalid candidates reach
    them, and selection masks those."""
    bs, k, h, w = plan.bs, plan.k, plan.h, plan.w
    dev = curs.device
    cur16 = curs.to(torch.int16)
    ref16 = refs.to(torch.int16)
    offs = torch.arange(bs, device=dev)
    pos_i = torch.as_tensor(np.minimum(plan.pos_i, h - bs), device=dev)
    pos_j = torch.as_tensor(np.minimum(plan.pos_j, w - bs), device=dev)
    out = torch.empty((*curs.shape[:2], plan.nbh, plan.nbw, k, k),
                      dtype=torch.int32, device=dev)
    for ki in range(k):
        rows = (pos_i[:, ki, None] + offs).reshape(-1)              # [H]
        ref_rows = ref16.index_select(-2, rows)
        for kj in range(k):
            cols = (pos_j[:, kj, None] + offs).reshape(-1)          # [W]
            cand = ref_rows.index_select(-1, cols)[:, None]         # [G,1,C,H,W]
            out[..., ki, kj] = tile_sums((cand - cur16) & 255, bs)
    return out


def select_mvs(sad: torch.Tensor, curs: torch.Tensor, refs: torch.Tensor,
               plan: MotionSearchPlan, static_threshold: int) -> torch.Tensor:
    """Candidate SADs [G, F, nbh, nbw, K, K] -> vectors [G, F, nbh, nbw, 2]
    int32: validity mask, packed first-minimum key, (0, 0) fallback and the
    static early-out."""
    k = plan.k
    dev = sad.device
    sh, sent = key_packing(plan, curs.shape[2])
    valid = torch.as_tensor(plan.valid_i[:, None, :, None]
                            & plan.valid_j[None, :, None, :], device=dev)
    idx = torch.arange(1, k * k + 1, dtype=torch.int32, device=dev).reshape(k, k)
    key = torch.where(valid, (sad << sh) + idx,
                      torch.tensor(sent + (1 << sh) - 1, dtype=torch.int32,
                                   device=dev))
    best = key.amin(dim=(-2, -1))
    return mvs_from_best(best, curs, refs, plan, static_threshold, sh, sent)


def mvs_from_best(best: torch.Tensor, curs: torch.Tensor, refs: torch.Tensor,
                  plan: MotionSearchPlan, static_threshold: int, sh: int,
                  sent: int) -> torch.Tensor:
    """Packed best keys [G, F, nbh, nbw] -> vectors [G, F, nbh, nbw, 2]."""
    bs, k, nbh, nbw = plan.bs, plan.k, plan.nbh, plan.nbw
    dev = best.device
    best = best.clamp(max=sent)
    hit = best < sent
    flat = ((best & ((1 << sh) - 1)) - 1).clamp(min=0)
    ki = flat // k
    kj = flat % k
    bi = torch.arange(nbh, device=dev)[:, None]
    bj = torch.arange(nbw, device=dev)[None, :]
    pos_i = torch.as_tensor(plan.pos_i, device=dev)
    pos_j = torch.as_tensor(plan.pos_j, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    pi = torch.where(hit, pos_i[bi, ki], zero)
    pj = torch.where(hit, pos_j[bj, kj], zero)
    ci = (bi * bs).to(torch.int32)
    cj = (bj * bs).to(torch.int32)
    stat = static_sad(curs, refs[:, None], bs) <= static_threshold
    pi = torch.where(stat, ci, pi)
    pj = torch.where(stat, cj, pj)
    return torch.stack([pj - cj, pi - ci], dim=-1).to(torch.int32)


def motion_search_plain(curs: torch.Tensor, refs: torch.Tensor, *,
                        bs: int = 8, reach: int = 16, step: int = 3,
                        static_threshold: int = 2000) -> torch.Tensor:
    """The plain PyTorch search, on any device: curs [G, F, C, H, W],
    refs [G, C, H, W] -> [G, F, nbh, nbw, 2] int32."""
    plan = make_plan(curs.shape[-2], curs.shape[-1], bs, reach, step)
    sad = sad_candidates(curs, refs, plan)
    return select_mvs(sad, curs, refs, plan, static_threshold)


def motion_search_gops(curs: torch.Tensor, refs: torch.Tensor, *, bs: int = 8,
                       reach: int = 16, step: int = 3,
                       static_threshold: int = 2000,
                       backend: str = "auto") -> torch.Tensor:
    """GOP-batched search: curs [G, F, C, H, W] vs refs [G, C, H, W]
    (uint8-valued) -> [G, F, nbh, nbw, 2] int32 (dx, dy).

    backend "auto": the K2 kernel on a CUDA tensor, at every geometry that
    `make_plan` and `key_packing` admit (`motion_cuda.sad_search_form`
    picks its form), the plain version on a CPU tensor. backend "plain":
    the plain version on either."""
    check_backend(backend)
    if curs.ndim != 5 or refs.ndim != 4 or curs.shape[0] != refs.shape[0] \
            or curs.shape[2:] != refs.shape[1:]:
        raise ValueError(f"curs {tuple(curs.shape)} / refs {tuple(refs.shape)}"
                         " must be [G, F, C, H, W] / [G, C, H, W]")
    if backend == "plain" or curs.device.type == "cpu":
        return motion_search_plain(curs, refs, bs=bs, reach=reach, step=step,
                                   static_threshold=static_threshold)
    from vcs_h264_tpu_torch.ops import motion_cuda
    return motion_cuda.sad_search(curs, refs, bs=bs, reach=reach, step=step,
                                  static_threshold=static_threshold)


def source_origin(o: torch.Tensor, extent: int, bs: int) -> torch.Tensor:
    """Block origins o along one axis -> the start `lax.dynamic_slice`
    reads from: o + extent where o < 0, then clamped into [0, extent - bs]."""
    return torch.where(o < 0, o + extent, o).clamp(0, extent - bs)


def gather_operands(mv: torch.Tensor, refs: torch.Tensor, bs: int):
    """The operands of the `torch.gather` that compensates in block-major
    order: (refs viewed [G, F, C, H*W], the flat int64 source index
    [G, F, C, nbh*nbw*bs*bs] of every output sample).

    Each block's source origin o = bs * b + d is placed on each axis as
    `lax.dynamic_slice` places it in the JAX package: a negative o first
    gets the extent added, then o is clamped into [0, extent - bs]. So a
    vector from a foreign stream never reads outside the frame; vectors
    from the search never need either step."""
    g, f, nbh, nbw, _ = mv.shape
    _, c, h, w = refs.shape
    dev = refs.device
    offs = torch.arange(bs, device=dev)
    i0 = source_origin(torch.arange(nbh, device=dev)[:, None] * bs
                       + mv[..., 1], h, bs)
    j0 = source_origin(torch.arange(nbw, device=dev)[None, :] * bs
                       + mv[..., 0], w, bs)
    rows = i0[..., None, None] + offs[:, None]              # [G,F,nbh,nbw,bs,1]
    cols = j0[..., None, None] + offs[None, :]              # [G,F,nbh,nbw,1,bs]
    flat = (rows * w + cols).reshape(g, f, 1, -1)           # [G,F,1,nbh*nbw*bs*bs]
    return (refs.reshape(g, 1, c, h * w).expand(g, f, c, h * w),
            flat.expand(g, f, c, flat.shape[-1]))


def motion_compensate_plain(mv: torch.Tensor, refs: torch.Tensor, *,
                            bs: int) -> torch.Tensor:
    """The plain PyTorch compensation, on any device: mv [G, F, nbh, nbw, 2]
    (dx, dy) against per-GOP refs [G, C, H, W] -> [G, F, C, H, W] in the
    refs' dtype. Any vector is accepted; `gather_operands` says where its
    source block is read."""
    g, f, nbh, nbw, _ = mv.shape
    _, c, h, w = refs.shape
    src, index = gather_operands(mv, refs, bs)
    blocks = torch.gather(src, 3, index)
    blocks = blocks.reshape(g, f, c, nbh, nbw, bs, bs)
    return blocks.transpose(-3, -2).reshape(g, f, c, h, w)


def motion_compensate_gops(mv: torch.Tensor, refs: torch.Tensor, *, bs: int,
                           backend: str = "auto") -> torch.Tensor:
    """Block compensation: mv [G, F, nbh, nbw, 2] (dx, dy) against per-GOP
    refs [G, C, H, W] -> [G, F, C, H, W].

    backend "auto": the K1 kernel on a CUDA tensor (uint8 refs, uint8 out),
    the plain version on a CPU tensor (the refs' dtype). backend "plain":
    the plain version on either. Any vector is accepted; see
    `gather_operands` for where its source block is read."""
    check_backend(backend)
    if mv.ndim != 5 or refs.ndim != 4 or mv.shape[0] != refs.shape[0] \
            or mv.shape[-1] != 2 or refs.shape[-2] % bs \
            or refs.shape[-1] % bs or tuple(mv.shape[2:4]) != (
                refs.shape[-2] // bs, refs.shape[-1] // bs):
        raise ValueError(f"mv {tuple(mv.shape)} / refs {tuple(refs.shape)} "
                         f"must be [G, F, H/{bs}, W/{bs}, 2] / [G, C, H, W]")
    if backend == "plain" or refs.device.type == "cpu":
        return motion_compensate_plain(mv, refs, bs=bs)
    from vcs_h264_tpu_torch.ops import motion_cuda
    return motion_cuda.compensate(mv.contiguous(), refs.contiguous(), bs=bs)


def motion_search(cur: torch.Tensor, ref: torch.Tensor, *, bs: int = 8,
                  reach: int = 16, step: int = 3,
                  static_threshold: int = 2000,
                  backend: str = "auto") -> torch.Tensor:
    """Vectors of one frame: cur, ref [C, H, W] (uint8 values) -> [nbh,
    nbw, 2] int32 (dx, dy); K2 on a CUDA tensor (see motion_search_gops)."""
    return motion_search_batch(cur[None], ref, bs=bs, reach=reach, step=step,
                               static_threshold=static_threshold,
                               backend=backend)[0]


def motion_search_batch(curs: torch.Tensor, ref: torch.Tensor, *,
                        bs: int = 8, reach: int = 16, step: int = 3,
                        static_threshold: int = 2000,
                        backend: str = "auto") -> torch.Tensor:
    """Vectors of F frames against one reference: curs [F, C, H, W], ref
    [C, H, W] (uint8 values) -> [F, nbh, nbw, 2] int32; K2 on a CUDA
    tensor. The frames go to the search as uint8, the kernel's type."""
    return motion_search_gops(
        curs[None].to(torch.uint8).contiguous(),
        ref[None].to(torch.uint8).contiguous(), bs=bs, reach=reach,
        step=step, static_threshold=static_threshold, backend=backend)[0]


def motion_compensate(mv: torch.Tensor, ref: torch.Tensor, bs: int,
                      backend: str = "auto") -> torch.Tensor:
    """One frame rebuilt from its vectors: mv [nbh, nbw, 2] (dx, dy), ref
    [C, H, W] (uint8 values) -> [C, H, W] in ref's dtype; K1 on a CUDA
    tensor, which takes and gives uint8, so the wrapper casts the
    reference to uint8 and the result back."""
    out = motion_compensate_gops(
        mv[None, None].to(torch.int32).contiguous(),
        ref[None].to(torch.uint8).contiguous(), bs=bs, backend=backend)
    return out[0, 0].to(ref.dtype)


def residuals_wrap(cur: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
    """uint8-wrapping residual (cur - recon) & 255, computed in int32."""
    return (cur.to(torch.int32) - recon.to(torch.int32)) & 255


def reconstruct_wrap(recon: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """uint8-wrapping add-back (recon + res) & 255, computed in int32."""
    return (recon.to(torch.int32) + res.to(torch.int32)) & 255


def num_static_blocks(mv: torch.Tensor) -> torch.Tensor:
    """Count of zero motion vectors."""
    return (mv == 0).all(dim=-1).sum()


def check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
