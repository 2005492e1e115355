"""4x4 intra prediction, the lossless intra codec and the closed-loop lossy
intra codec over the block wavefront (counterpart of
`vcs_h264_tpu/ops/intra.py`), integer-exact.

Semantics, as the JAX package pins them against the original Python
reference:
  * availability is positional: u: bi >= 1; l: bj >= 1; ul: both;
    ur: bi >= 1 and bj < nbw - 1;
  * an unavailable neighbour reads 128, and an unavailable ur repeats u[3]
    when u is available (128 when it is not); neither wraps;
  * neighbours that came from the plane are uint8 in the reference, so
    `u + l` in the DC mode and `3 * x` in the down-left / horizontal-up
    modes wrap mod 256 exactly where their operands came from the plane;
  * every `//` is a floor division;
  * mode selection starts from a zero prediction at 16 * 255 and keeps the
    first mode that is strictly better, so the first mode wins a tie, and a
    block no mode beats is an escape (zero prediction, mode 0 stored).

The lossy codec codes each block's residual with the H.264 4x4 integer core
transform: q = iround(Cf X Cf^T * 400 G / (400 qstep)), reconstruction
clip(pred + iround((2Ci)(q qstep)(2Ci)^T / 4), 0, 255), round half away from
zero throughout. Both sides predict from the reconstruction, so blocks are
coded in wavefront order: block (bi, bj) depends only on blocks of smaller
key 2 bi + bj, and the blocks of one anti-diagonal t = 2 bi + bj are
independent.

`intra_encode4x4_lossy_batch` and the decoders send CUDA tensors to the
hand-written kernels (`ops/intra_cuda.py`, K5 and K6) and CPU tensors to the
plain PyTorch wavefront below, which loops over the diagonals in Python;
`backend="plain"` asks for the plain version on any device. The
single-plane wrappers (`intra_encode4x4_lossy`, `intra_decode4x4`,
`intra_decode4x4_lossy`) take the same routes.

The open-loop studies `luma4x4`, `luma16x16` (V/H/DC over 16x16 blocks,
from a zero prediction at 16 * 16 * 255) and `chroma8x8` (V/H/DC over 8x8
blocks, one mode shared by Cr and Cb by their summed SAD, from 2 * 8 * 8 *
255) predict every block from the original plane at once; they are plain
PyTorch on any device, as they are XLA in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vcs_h264_tpu_torch.ops.blocks import blocks_to_plane, plane_to_blocks
from vcs_h264_tpu_torch.ops.motion import check_backend

BS = 4
SENTINEL = 16 * 255          # the reference's initial best SAD


def _avail_masks(nbh: int, nbw: int, device=None):
    """Positional availability [nbh, nbw] bool: (u, l, ul, ur)."""
    bi = torch.arange(nbh, device=device)[:, None]
    bj = torch.arange(nbw, device=device)[None, :]
    a_u = (bi >= 1).expand(nbh, nbw)
    a_l = (bj >= 1).expand(nbh, nbw)
    a_ul = a_u & a_l
    a_ur = a_u & (bj < nbw - 1).expand(nbh, nbw)
    return a_u, a_l, a_ul, a_ur


def _fill(u_raw, l_raw, ul_raw, ur_raw, a_u, a_l, a_ul, a_ur):
    """The reference's 128 fills and ur fallback. u/l/ur [..., 4], ul [...];
    masks [...] (broadcast against the leading axes)."""
    fill = torch.tensor(128, dtype=torch.int32, device=u_raw.device)
    u = torch.where(a_u[..., None], u_raw, fill)
    l = torch.where(a_l[..., None], l_raw, fill)
    ul = torch.where(a_ul, ul_raw, fill)
    ur_fb = torch.where(a_u, u_raw[..., 3], fill)
    ur = torch.where(a_ur[..., None], ur_raw, ur_fb[..., None])
    return u, l, ul, ur


def _neighbors(y: torch.Tensor, bs: int = BS):
    """Per-block neighbour vectors from planes [..., H, W] (int32):
    (u [..., nbh, nbw, bs], l, ul [..., nbh, nbw], ur, masks), with the
    reference's 128 fills and ur fallback applied. The masks say which
    neighbours came from the plane (and so wrap)."""
    h, w = y.shape[-2:]
    nbh, nbw = h // bs, w // bs
    dev = y.device
    a_u, a_l, a_ul, a_ur = _avail_masks(nbh, nbw, dev)
    rows_above = (torch.arange(nbh, device=dev) * bs - 1).clamp(min=0)
    cols_left = (torch.arange(nbw, device=dev) * bs - 1).clamp(min=0)
    top = y[..., rows_above, :]                               # [..., nbh, W]
    u_raw = top.reshape(*top.shape[:-1], nbw, bs)
    top_pad = torch.nn.functional.pad(top, (0, bs))
    ur_raw = top_pad[..., bs:].reshape(*top.shape[:-1], nbw, bs)
    left = y[..., :, cols_left]                               # [..., H, nbw]
    l_raw = left.reshape(*left.shape[:-2], nbh, bs, nbw).transpose(-1, -2)
    ul_raw = top[..., cols_left]                              # [..., nbh, nbw]
    u, l, ul, ur = _fill(u_raw, l_raw, ul_raw, ur_raw, a_u, a_l, a_ul, a_ur)
    return u, l, ul, ur, (a_u, a_l, a_ul, a_ur)


def _w3(x, wrap):
    """3 * x, wrapped mod 256 where `wrap` (the reference's uint8 overflow
    in `3 * ur[3] // 4` and `3 * l[3] // 4`)."""
    t = 3 * x
    return torch.where(wrap, t & 255, t)


# --- 4x4 predictors: u, l, ur [..., 4]; ul [...] -> [..., 4, 4] int32 ------


def _assemble(rows):
    """4 lists of 4 [...] entries -> [..., 4, 4]."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def pred_vertical(u):
    return u[..., None, :].expand(*u.shape[:-1], 4, 4)


def pred_horizontal(l):
    return l[..., :, None].expand(*l.shape[:-1], 4, 4)


def pred_dc4(u, l, u_wraps_with_l):
    s = torch.where(u_wraps_with_l[..., None], (u + l) & 255, u + l)
    avg = s.sum(dim=-1, dtype=torch.int32) // 8
    return avg[..., None, None].expand(*avg.shape, 4, 4)


def pred_downleft(u, ur, ur_wrap):
    e = torch.cat([u, ur], dim=-1)                            # [..., 8]
    t = [e[..., s] // 4 + e[..., s + 1] // 2 + e[..., s + 2] // 4
         for s in range(6)]
    t.append(e[..., 6] // 4 + _w3(e[..., 7], ur_wrap) // 4)
    return _assemble([[t[r + c] for c in range(4)] for r in range(4)])


def pred_downright(ul, u, l):
    d = {
        3: u[..., 1] // 4 + u[..., 2] // 2 + u[..., 3] // 4,
        2: u[..., 0] // 4 + u[..., 1] // 2 + u[..., 2] // 4,
        1: ul // 4 + u[..., 0] // 2 + u[..., 1] // 4,
        0: ul // 4 + u[..., 0] // 2 + l[..., 0] // 4,
        -1: u[..., 0] // 4 + l[..., 0] // 2 + l[..., 1] // 4,
        -2: l[..., 0] // 4 + l[..., 1] // 2 + l[..., 2] // 4,
        -3: l[..., 1] // 4 + l[..., 2] // 2 + l[..., 3] // 4,
    }
    return _assemble([[d[c - r] for c in range(4)] for r in range(4)])


def pred_verticalright(ul, u, l):
    a0 = ul // 2 + u[..., 0] // 2
    a1 = u[..., 0] // 2 + u[..., 1] // 2
    a2 = u[..., 1] // 2 + u[..., 2] // 2
    a3 = u[..., 2] // 2 + u[..., 3] // 2
    b0 = u[..., 0] // 4 + ul // 2 + l[..., 0] // 4
    b1 = ul // 4 + u[..., 0] // 2 + u[..., 1] // 4
    b2 = u[..., 0] // 4 + u[..., 1] // 2 + u[..., 2] // 4
    b3 = u[..., 1] // 4 + u[..., 2] // 2 + u[..., 3] // 4
    c0 = ul // 4 + l[..., 0] // 2 + l[..., 1] // 4
    d0 = l[..., 0] // 4 + l[..., 1] // 2 + l[..., 2] // 4
    return _assemble([[a0, a1, a2, a3],
                      [b0, b1, b2, b3],
                      [c0, a0, a1, a2],
                      [d0, b0, b1, b2]])


def pred_horizontaldown(ul, u, l):
    a0 = ul // 2 + l[..., 0] // 2
    a1 = u[..., 0] // 4 + ul // 2 + l[..., 0] // 4
    a2 = ul // 4 + u[..., 0] // 2 + u[..., 1] // 4
    a3 = u[..., 0] // 4 + u[..., 1] // 2 + u[..., 2] // 4
    b0 = l[..., 0] // 2 + l[..., 1] // 2
    b1 = ul // 4 + l[..., 1] // 2 + l[..., 2] // 4
    c0 = l[..., 1] // 2 + l[..., 2] // 2
    c1 = l[..., 0] // 4 + l[..., 1] // 2 + l[..., 2] // 4
    d0 = l[..., 2] // 2 + l[..., 3] // 2
    d1 = l[..., 1] // 4 + l[..., 2] // 2 + l[..., 3] // 4
    return _assemble([[a0, a1, a2, a3],
                      [b0, b1, a0, a1],
                      [c0, c1, b0, b1],
                      [d0, d1, c0, c1]])


def pred_verticalleft(u, ur):
    a0 = u[..., 0] // 2 + u[..., 1] // 2
    a1 = u[..., 1] // 2 + u[..., 2] // 2
    a2 = u[..., 2] // 2 + u[..., 3] // 2
    a3 = u[..., 3] // 2 + ur[..., 0] // 2
    a4 = ur[..., 0] // 2 + ur[..., 1] // 2
    b0 = u[..., 0] // 4 + u[..., 1] // 2 + u[..., 2] // 4
    b1 = u[..., 1] // 4 + u[..., 2] // 2 + u[..., 3] // 4
    b2 = u[..., 2] // 4 + u[..., 3] // 2 + ur[..., 0] // 4
    b3 = u[..., 3] // 4 + ur[..., 0] // 2 + ur[..., 1] // 4
    b4 = ur[..., 0] // 4 + ur[..., 1] // 2 + ur[..., 2] // 4
    return _assemble([[a0, a1, a2, a3],
                      [b0, b1, b2, b3],
                      [a1, a2, a3, a4],
                      [b1, b2, b3, b4]])


def pred_horizontalup(l, l_wrap):
    a0 = l[..., 0] // 2 + l[..., 1] // 2
    a1 = l[..., 0] // 4 + l[..., 1] // 2 + l[..., 2] // 4
    a2 = l[..., 1] // 2 + l[..., 2] // 2
    a3 = l[..., 1] // 4 + l[..., 2] // 2 + l[..., 3] // 4
    b2 = l[..., 2] // 2 + l[..., 3] // 2
    b3 = l[..., 2] // 4 + _w3(l[..., 3], l_wrap) // 4
    c = l[..., 3]
    return _assemble([[a0, a1, a2, a3],
                      [a2, a3, b2, b3],
                      [b2, b3, c, c],
                      [c, c, c, c]])


def _preds9(u, l, ul, ur, a_u, a_l, a_ur):
    """The 9 4x4 predictors for any leading batch shape: u/l/ur [..., 4],
    ul [...], masks [...] -> [9, ..., 4, 4] int32."""
    return torch.stack([
        pred_vertical(u),
        pred_horizontal(l),
        pred_dc4(u, l, a_u & a_l),
        pred_downleft(u, ur, a_ur),
        pred_downright(ul, u, l),
        pred_verticalright(ul, u, l),
        pred_horizontaldown(ul, u, l),
        pred_verticalleft(u, ur),
        pred_horizontalup(l, a_l),
    ])


def _first_min(diffs, init_diff: int):
    """diffs [M, ...] int32 (M <= 15 modes) -> (mode [...] int32, escape
    [...] bool): the reference's strict-< scan from a zero prediction at
    `init_diff`, as one min over packed keys SAD * 16 + mode + 1 against
    the sentinel init_diff * 16: the smallest SAD wins, the lowest mode
    among equals, and a SAD equal to init_diff loses to the sentinel
    (escape)."""
    m = diffs.shape[0]
    idx = torch.arange(1, m + 1, dtype=torch.int32, device=diffs.device)
    keys = diffs * 16 + idx.reshape(m, *([1] * (diffs.ndim - 1)))
    kmin = keys.amin(dim=0)
    escape = kmin > init_diff * 16
    return torch.where(escape, 0, (kmin & 15) - 1), escape


def _sads(preds, block):
    """preds [M, ..., n, n], block [..., n, n] -> SADs [M, ...] int32."""
    return (preds - block[None]).abs().sum(dim=(-2, -1), dtype=torch.int32)


def _select_best(block, preds, init_diff: int = SENTINEL):
    """preds [M, ..., n, n], block [..., n, n] -> (pred [..., n, n], mode
    [...] int32, escape [...] bool), by `_first_min`."""
    mode, escape = _first_min(_sads(preds, block), init_diff)
    return _pick(preds, mode, escape), mode, escape


def _pick(preds, mode, zero):
    """preds [M, ..., n, n] -> the prediction of `mode` [...], or zeros where
    `zero` (or where mode is not one of the M)."""
    m, n = preds.shape[0], preds.shape[-1]
    safe = mode.clamp(0, m - 1).to(torch.int64)
    pred = torch.gather(preds, 0, safe[None, ..., None, None].expand(
        1, *mode.shape, n, n))[0]
    keep = ~zero & (mode >= 0) & (mode <= m - 1)
    return torch.where(keep[..., None, None], pred, 0)


def _blocks_of_planes(planes: torch.Tensor) -> torch.Tensor:
    """[..., H, W] -> [..., nbh, nbw, 4, 4]."""
    h, w = planes.shape[-2:]
    x = planes.reshape(*planes.shape[:-2], h // BS, BS, w // BS, BS)
    return x.transpose(-3, -2)


def _planes_of_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """[..., nbh, nbw, 4, 4] -> [..., H, W]."""
    nbh, nbw = blocks.shape[-4:-2]
    return blocks.transpose(-3, -2).reshape(*blocks.shape[:-4], nbh * BS,
                                            nbw * BS)


def luma4x4_codec(y: torch.Tensor):
    """Lossless 4x4 intra mode search with neighbours from the ORIGINAL
    plane (the reference's study): y [..., H, W] (uint8 values), H, W
    multiples of 4 -> (residual int32 [..., H, W], modes int32 [..., nbh,
    nbw], escape bool). `escape` marks blocks where no mode beat 16 * 255
    and the zero prediction was kept: the stored mode 0 is ambiguous there,
    so the decoder needs the flag."""
    block, pred, modes, escape = _luma4x4_search(y)
    return _planes_of_blocks(block - pred), modes, escape


def _luma4x4_search(y: torch.Tensor):
    """The 4x4 mode search on the original plane: y [..., H, W] -> (blocks,
    their predictions [..., nbh, nbw, 4, 4], modes, escape)."""
    y = y.to(torch.int32)
    u, l, ul, ur, (a_u, a_l, _, a_ur) = _neighbors(y)
    preds = _preds9(u, l, ul, ur, a_u, a_l, a_ur)
    block = _blocks_of_planes(y)
    return (block, *_select_best(block, preds))


# --- The open-loop studies (the reference's intra study) --------------------


def luma4x4(y: torch.Tensor):
    """Mode search over the 9 4x4 luma modes with neighbours from the
    original plane: y [..., H, W] (uint8 values), H, W multiples of 4 ->
    (residual [..., H, W], prediction [..., H, W], modes [..., nbh, nbw]),
    all int32."""
    block, pred, modes, _ = _luma4x4_search(y)
    return (_planes_of_blocks(block - pred), _planes_of_blocks(pred),
            modes)


def _vhdc_preds(plane: torch.Tensor, bs: int):
    """The vertical, horizontal and DC predictors of bs x bs blocks from the
    original plane [H, W] int32 (an unavailable neighbour reads 128, the DC
    is (sum u + sum l) // (2 bs) without a wrap) -> (preds [3, nbh, nbw,
    bs, bs], blocks [nbh, nbw, bs, bs])."""
    h, w = plane.shape[-2:]
    nbh, nbw = h // bs, w // bs
    dev = plane.device
    a_u, a_l, _, _ = _avail_masks(nbh, nbw, dev)
    rows_above = (torch.arange(nbh, device=dev) * bs - 1).clamp(min=0)
    cols_left = (torch.arange(nbw, device=dev) * bs - 1).clamp(min=0)
    u_raw = plane[rows_above].reshape(nbh, nbw, bs)
    l_raw = plane[:, cols_left].reshape(nbh, bs, nbw).transpose(1, 2)
    fill = torch.tensor(128, dtype=torch.int32, device=dev)
    u = torch.where(a_u[..., None], u_raw, fill)
    l = torch.where(a_l[..., None], l_raw, fill)
    dc = (u.sum(dim=-1, dtype=torch.int32)
          + l.sum(dim=-1, dtype=torch.int32)) // (2 * bs)
    preds = torch.stack([
        u[..., None, :].expand(nbh, nbw, bs, bs),
        l[..., :, None].expand(nbh, nbw, bs, bs),
        dc[..., None, None].expand(nbh, nbw, bs, bs),
    ])
    return preds, plane_to_blocks(plane, bs)


def luma16x16(y: torch.Tensor):
    """Vertical, horizontal and DC over 16x16 blocks of y [H, W] (uint8
    values), H, W multiples of 16, from a zero prediction at 16 * 16 * 255
    -> (residual [H, W], prediction [H, W], modes [nbh, nbw]), all int32."""
    preds, block = _vhdc_preds(y.to(torch.int32), 16)
    pred, modes, _ = _select_best(block, preds, 16 * 16 * 255)
    return (blocks_to_plane(block - pred),
            blocks_to_plane(pred), modes)


def chroma8x8(cr: torch.Tensor, cb: torch.Tensor):
    """Joint Cr / Cb vertical, horizontal and DC over 8x8 blocks (H, W
    multiples of 8): one mode per block, shared by both planes, chosen by
    the summed SAD from a zero prediction at 2 * 8 * 8 * 255 -> (Cr
    residual, Cr prediction, Cb residual, Cb prediction [H, W], modes
    [nbh, nbw]), all int32. Both planes are read as themselves (the JAX
    package's fix of the reference's `Cbres` typo)."""
    preds_r, block_r = _vhdc_preds(cr.to(torch.int32), 8)
    preds_b, block_b = _vhdc_preds(cb.to(torch.int32), 8)
    modes, escape = _first_min(_sads(preds_r, block_r)
                               + _sads(preds_b, block_b), 2 * 8 * 8 * 255)
    pred_r = _pick(preds_r, modes, escape)
    pred_b = _pick(preds_b, modes, escape)
    return (blocks_to_plane(block_r - pred_r),
            blocks_to_plane(pred_r),
            blocks_to_plane(block_b - pred_b),
            blocks_to_plane(pred_b), modes)


# --- H.264 4x4 integer core transform (integer-exact, any device) ----------

_CF4 = ((1, 1, 1, 1), (2, 1, -1, -2), (1, -1, -1, 1), (1, -2, 2, -1))
_CI4X2 = ((2, 2, 2, 1), (2, 1, -2, -2), (2, -1, -2, 2), (2, -2, 2, -1))
_G4X400 = tuple(tuple(a * b for b in (5, 4, 5, 4)) for a in (5, 4, 5, 4))


def _iround_div(a: torch.Tensor, b: int) -> torch.Tensor:
    """Round-half-away-from-zero integer division by a positive int b:
    sign(a) * ((2 |a| + b) // (2 b))."""
    return torch.sign(a) * ((2 * a.abs() + b) // (2 * b))


def _both_sides(m, x: torch.Tensor) -> torch.Tensor:
    """M X M^T for X [..., 4, 4] int32 and a 4x4 integer matrix M, as
    integer multiply-adds (CUDA has no integer matmul)."""
    mt = torch.tensor(m, dtype=torch.int32, device=x.device)
    t = (mt[:, :, None] * x[..., None, :, :]).sum(dim=-2, dtype=torch.int32)
    return (t[..., :, None, :] * mt).sum(dim=-1, dtype=torch.int32)


def core4_fwd(blocks: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] int32 residual -> unscaled coefficients Cf X Cf^T."""
    return _both_sides(_CF4, blocks.to(torch.int32))


def core4_quant(coef: torch.Tensor, qstep: int) -> torch.Tensor:
    gn = torch.tensor(_G4X400, dtype=torch.int32, device=coef.device)
    return _iround_div(coef * gn, 400 * qstep)


def core4_dequant_inv(q: torch.Tensor, qstep: int) -> torch.Tensor:
    """Quantized coefficients [..., 4, 4] -> reconstructed residual (int32,
    exact)."""
    return _iround_div(_both_sides(_CI4X2, q.to(torch.int32) * qstep), 4)


# --- The plain wavefront -----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _wavefront_plan(nbh: int, nbw: int):
    """Host-side bookkeeping of the 2 bi + bj wavefront: T = 2 (nbh - 1) +
    nbw diagonals, and for each diagonal t the range [lo[t], hi[t]) of block
    rows bi whose column t - 2 bi lies in [0, nbw). The rows of one diagonal
    are contiguous, so its blocks are an arange, with no padding lanes."""
    T = 2 * (nbh - 1) + nbw
    t = np.arange(T)
    lo = np.maximum(0, (t - nbw + 2) // 2)
    hi = np.minimum(nbh, t // 2 + 1)
    return T, lo.astype(np.int64), hi.astype(np.int64)


def _wavefront(nbh: int, nbw: int, n: int, device, step):
    """Run `step(t, bi, bj, u, l, ul, ur, a_u, a_l, a_ur) -> reconstructed
    blocks [N, L, 4, 4]` over the diagonals, feeding each diagonal's blocks
    (bi, bj) their neighbours from the reconstruction so far.
    -> reconstruction [N, nbh, nbw, 4, 4] int32."""
    T, lo, hi = _wavefront_plan(nbh, nbw)
    rec = torch.zeros((n, nbh, nbw, BS, BS), dtype=torch.int32, device=device)
    rows = torch.arange(nbh, device=device)
    for t in range(T):
        bi = rows[lo[t]:hi[t]]
        bj = t - 2 * bi
        a_u = bi >= 1
        a_l = bj >= 1
        a_ul = a_u & a_l
        a_ur = a_u & (bj < nbw - 1)
        up = (bi - 1).clamp(min=0)
        left = (bj - 1).clamp(min=0)
        right = (bj + 1).clamp(max=nbw - 1)
        u, l, ul, ur = _fill(rec[:, up, bj][..., 3, :],
                             rec[:, bi, left][..., :, 3],
                             rec[:, up, left][..., 3, 3],
                             rec[:, up, right][..., 3, :],
                             a_u, a_l, a_ul, a_ur)
        rec[:, bi, bj] = step(t, bi, bj, u, l, ul, ur, a_u, a_l, a_ur)
    return rec


def intra_encode4x4_lossy_plain(planes: torch.Tensor, qstep: int):
    """The plain closed-loop lossy encode, on any device: planes [N, H, W]
    (uint8 values) -> (qcoef int16 [N, H, W] block-layout planes, modes int8
    [N, nbh, nbw], escape bool [N, nbh, nbw], recon uint8 [N, H, W])."""
    n, h, w = planes.shape
    nbh, nbw = h // BS, w // BS
    orig = _blocks_of_planes(planes.to(torch.int32))
    q_out = torch.zeros_like(orig)
    modes = torch.zeros((n, nbh, nbw), dtype=torch.int32, device=planes.device)
    escape = torch.zeros((n, nbh, nbw), dtype=torch.bool, device=planes.device)

    def step(t, bi, bj, u, l, ul, ur, a_u, a_l, a_ur):
        oblk = orig[:, bi, bj]                                # [N, L, 4, 4]
        preds = _preds9(u, l, ul, ur, a_u, a_l, a_ur)
        pred, mode, esc = _select_best(oblk, preds)
        q = core4_quant(core4_fwd(oblk - pred), qstep)
        q_out[:, bi, bj] = q
        modes[:, bi, bj] = mode
        escape[:, bi, bj] = esc
        return (pred + core4_dequant_inv(q, qstep)).clamp(0, 255)

    rec = _wavefront(nbh, nbw, n, planes.device, step)
    return (_planes_of_blocks(q_out).to(torch.int16), modes.to(torch.int8),
            escape, _planes_of_blocks(rec).to(torch.uint8))


def decode_planes_plain(res_planes: torch.Tensor, modes: torch.Tensor,
                        escape: torch.Tensor, qstep: int, clip: bool):
    """The plain wavefront decode, on any device: res_planes [N, H, W]
    (block-layout quantized coefficients when qstep > 0, exact residuals
    when qstep == 0), modes / escape [N, nbh, nbw] -> reconstructed planes,
    uint8 when `clip`, int32 otherwise. A mode outside 0..8 predicts zero,
    as the JAX one-hot selection does."""
    n, h, w = res_planes.shape
    nbh, nbw = h // BS, w // BS
    res = _blocks_of_planes(res_planes.to(torch.int32))
    if qstep:
        res = core4_dequant_inv(res, qstep)
    modes = modes.to(torch.int32)
    escape = escape.to(torch.bool)

    def step(t, bi, bj, u, l, ul, ur, a_u, a_l, a_ur):
        preds = _preds9(u, l, ul, ur, a_u, a_l, a_ur)
        pred = _pick(preds, modes[:, bi, bj], escape[:, bi, bj])
        block = pred + res[:, bi, bj]
        return block.clamp(0, 255) if clip else block

    out = _planes_of_blocks(_wavefront(nbh, nbw, n, res_planes.device, step))
    return out.to(torch.uint8) if clip else out


def _check_planes(planes: torch.Tensor, what: str) -> None:
    if planes.ndim != 3 or planes.shape[-2] % BS or planes.shape[-1] % BS:
        raise ValueError(f"{what}: needs planes [N, H, W] with H, W "
                         f"multiples of {BS}, got {tuple(planes.shape)}")


def intra_encode4x4_lossy_batch(planes: torch.Tensor, qstep: int,
                                backend: str = "auto"):
    """Closed-loop lossy intra encode of a batch of planes [N, H, W] (uint8
    values), dims multiples of 4, qstep >= 1 -> (qcoef int16 [N, H, W]
    block-layout planes, modes int8 [N, nbh, nbw], escape bool [N, nbh,
    nbw], recon uint8 [N, H, W], the decoder's exact output).

    backend "auto": K5 on a CUDA tensor, the plain version on a CPU tensor.
    backend "plain": the plain version on either."""
    check_backend(backend)
    _check_planes(planes, "intra_encode4x4_lossy_batch")
    if qstep < 1:
        raise ValueError(f"lossy intra needs qstep >= 1, got {qstep}")
    if backend == "plain" or planes.device.type == "cpu":
        return intra_encode4x4_lossy_plain(planes, qstep)
    from vcs_h264_tpu_torch.ops import intra_cuda
    return intra_cuda.intra_encode(planes, qstep)


def _decode_planes_dispatch(res_planes, modes, escape, clip: bool,
                            qstep: int, backend: str):
    """Shared decode dispatch: K6 on a CUDA tensor, the plain wavefront on a
    CPU tensor or when backend == "plain"."""
    check_backend(backend)
    _check_planes(res_planes, "intra decode")
    if backend == "plain" or res_planes.device.type == "cpu":
        return decode_planes_plain(res_planes, modes, escape, qstep, clip)
    from vcs_h264_tpu_torch.ops import intra_cuda
    return intra_cuda.intra_decode(res_planes, modes, escape, qstep, clip)


def intra_decode4x4_lossy_batch(qcoef: torch.Tensor, modes: torch.Tensor,
                                escape: torch.Tensor, qstep: int,
                                backend: str = "auto") -> torch.Tensor:
    """Wavefront decode, the exact inverse of the encoder's recon: qcoef
    [N, H, W], modes / escape [N, nbh, nbw] -> uint8 [N, H, W]."""
    return _decode_planes_dispatch(qcoef, modes, escape, clip=True,
                                   qstep=qstep, backend=backend)


def intra_decode4x4_batch(residual: torch.Tensor, modes: torch.Tensor,
                          escape: torch.Tensor,
                          backend: str = "auto") -> torch.Tensor:
    """Lossless wavefront decode: residual [N, H, W] from `luma4x4_codec`,
    modes / escape [N, nbh, nbw] -> int32 [N, H, W], unclipped. The encoder
    predicts from original neighbours and the residual is exact, so
    decoding in dependency order gives back the source bit for bit."""
    return _decode_planes_dispatch(residual, modes, escape, clip=False,
                                   qstep=0, backend=backend)


# --- Single-plane wrappers ----------------------------------------------------
# One plane [H, W] as a batch of one. The operands are cast to the kernels'
# types (residuals and coefficients int16, modes int8, escape bool, planes
# uint8), which hold every value an encoder of this package writes.


def intra_decode4x4(residual: torch.Tensor, modes: torch.Tensor,
                    escape: torch.Tensor, backend: str = "auto"
                    ) -> torch.Tensor:
    """Lossless wavefront decode of one plane (see intra_decode4x4_batch):
    residual [H, W], modes / escape [nbh, nbw] -> int32 [H, W]; K6 on a
    CUDA tensor."""
    return intra_decode4x4_batch(
        residual[None].to(torch.int16).contiguous(),
        modes[None].to(torch.int8).contiguous(),
        escape[None].to(torch.bool).contiguous(), backend)[0]


def intra_encode4x4_lossy(y: torch.Tensor, qstep: int,
                          backend: str = "auto"):
    """Closed-loop lossy intra encode of one plane [H, W] (uint8 values; see
    intra_encode4x4_lossy_batch) -> (qcoef int16 [H, W], modes int8 [nbh,
    nbw], escape bool [nbh, nbw], recon uint8 [H, W]); K5 on a CUDA
    tensor."""
    q, modes, escape, recon = intra_encode4x4_lossy_batch(
        y[None].to(torch.uint8).contiguous(), qstep, backend)
    return q[0], modes[0], escape[0], recon[0]


def intra_decode4x4_lossy(qcoef: torch.Tensor, modes: torch.Tensor,
                          escape: torch.Tensor, qstep: int,
                          backend: str = "auto") -> torch.Tensor:
    """Wavefront decode of one lossy plane (see
    intra_decode4x4_lossy_batch) -> uint8 [H, W]; K6 on a CUDA tensor."""
    return intra_decode4x4_lossy_batch(
        qcoef[None].to(torch.int16).contiguous(),
        modes[None].to(torch.int8).contiguous(),
        escape[None].to(torch.bool).contiguous(), qstep, backend)[0]
