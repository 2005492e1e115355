"""The codec's operations in plain PyTorch: a frozen copy of the semantics
the served program implements, kept here so that no later change to the
program can move the yardstick it is judged by.

Every function below restates, operation for operation, the plain version
the program's kernels are held to (colour conversion, 4:2:0 decimation,
the ordered 8x8 DCT, quantisation, the block motion search and
compensation, the 4x4 intra predictors and the closed-loop lossy intra
wavefront). It imports nothing of the program. The float stages (the
residual colour transform, the DCT and the quantiser's division) take a
`ftype`: float32 is the configuration's precision, and the benchmark's
lower-precision control runs them in bfloat16.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# ---------------------------------------------------------------------------
# colour (OpenCV's 8-bit fixed-point BGR <-> YCrCb, all in int32)

_SHIFT = 14
_HALF = 1 << (_SHIFT - 1)


def _descale(x):
    return (x + _HALF) >> _SHIFT


def _to_ycrcb(b, g, r):
    y = _descale(r * 4899 + g * 9617 + b * 1868)
    cr = _descale((r - y) * 11682 + (128 << _SHIFT))
    cb = _descale((b - y) * 9241 + (128 << _SHIFT))
    return y, cr, cb


def _to_bgr(y, cr, cb):
    b = y + _descale((cb - 128) * 29049)
    g = y + _descale((cb - 128) * -5636 + (cr - 128) * -11698)
    r = y + _descale((cr - 128) * 22987)
    return b, g, r


def _convert(x, fn):
    x = x.to(torch.int32)
    out = fn(*(x.select(-3, c) for c in range(3)))
    return torch.stack(out, dim=-3).clamp_(0, 255)


def bgr_to_ycrcb_planes(x):
    """Planar BGR [..., 3, H, W] -> planar YCrCb [..., 3, H, W] int32."""
    return _convert(x, _to_ycrcb)


def ycrcb_to_bgr_planes(x):
    """Planar YCrCb [..., 3, H, W] -> planar BGR [..., 3, H, W] int32."""
    return _convert(x, _to_bgr)


# ---------------------------------------------------------------------------
# 4:2:0 (cv2.boxFilter 2x2 with BORDER_REFLECT_101, stride 2; nearest up)


def subsample_420(plane):
    x = plane.to(torch.int32)
    xp = torch.cat([x[..., 1:2, :], x], dim=-2)
    xp = torch.cat([xp[..., :, 1:2], xp], dim=-1)
    s = (xp[..., :-1, :-1] + xp[..., :-1, 1:]
         + xp[..., 1:, :-1] + xp[..., 1:, 1:])
    return ((s + 3) >> 2)[..., ::2, ::2]


def ingest_420(bgr_planes):
    """Planar BGR [..., 3, H, W] -> (Y uint8 [..., H, W], Cr/Cb uint8
    [..., 2, H/2, W/2])."""
    ycc = bgr_to_ycrcb_planes(bgr_planes)
    y = ycc[..., 0, :, :]
    c = torch.stack([subsample_420(ycc[..., 1, :, :]),
                     subsample_420(ycc[..., 2, :, :])], dim=-3)
    return y.to(torch.uint8), c.to(torch.uint8)


def emit_bgr(y, c):
    """(Y [..., H, W], C [..., 2, H/2, W/2]) -> planar BGR uint8."""
    h, w = y.shape[-2:]

    def up(p):
        return p.repeat_interleave(2, -2).repeat_interleave(2, -1)[
            ..., :h, :w].to(torch.int32)

    ycc = torch.stack([y.to(torch.int32), up(c[..., 0, :, :]),
                       up(c[..., 1, :, :])], dim=-3)
    return ycrcb_to_bgr_planes(ycc).to(torch.uint8)


# ---------------------------------------------------------------------------
# blocks, DCT, quantisation

def plane_to_blocks(plane, bs):
    *lead, h, w = plane.shape
    return plane.reshape(*lead, h // bs, bs, w // bs, bs).transpose(-3, -2)


def blocks_to_plane(blocks):
    *lead, nbh, nbw, b1, b2 = blocks.shape
    return blocks.transpose(-3, -2).reshape(*lead, nbh * b1, nbw * b2)


def dct_matrix_np(n):
    j = np.arange(n)[None, :]
    i = np.arange(n)[:, None]
    m = np.sqrt(2.0 / n) * np.cos((2 * j + 1) * i * np.pi / (2 * n))
    m[0, :] = 1.0 / np.sqrt(n)
    return m


def _dct_matrix(n, ftype, device):
    # rounded once to float32, as the configuration states, then to ftype
    return torch.tensor(dct_matrix_np(n), dtype=torch.float32,
                        device=device).to(ftype)


def _left(m, x):
    """m @ x over the last two axes, one ordered multiply-add at a time."""
    acc = m[:, 0, None] * x[..., 0:1, :]
    for j in range(1, m.shape[1]):
        acc = acc + m[:, j, None] * x[..., j:j + 1, :]
    return acc


def _right(x, m):
    """x @ m over the last two axes, one ordered multiply-add at a time."""
    acc = x[..., 0:1] * m[0]
    for k in range(1, m.shape[0]):
        acc = acc + x[..., k:k + 1] * m[k]
    return acc


def dct2_blocks(blocks):
    d = _dct_matrix(blocks.shape[-1], blocks.dtype, blocks.device)
    return _right(_left(d, blocks), d.T)


def idct2_blocks(blocks):
    d = _dct_matrix(blocks.shape[-1], blocks.dtype, blocks.device)
    return _right(_left(d.T, blocks), d)


QY_BASE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61], [12, 12, 14, 19, 26, 48, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56], [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77], [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101], [72, 92, 95, 98, 112, 100, 103, 99],
], dtype=np.float64)
QC_BASE = np.full((8, 8), 99.0)
QC_BASE[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99],
                   [47, 66, 99, 99]]


def quant_tables(qf, ftype, device):
    """(Y, Cr, Cb) JPEG tables scaled by the quality factor, [3, 8, 8]."""
    s = 50.0 / qf if qf < 50 else (100.0 - qf) / 50.0
    qy = np.clip(np.round(QY_BASE * s), 1, 255)
    qc = np.clip(np.round(QC_BASE * s), 1, 255)
    return torch.tensor(np.stack([qy, qc, qc]), dtype=torch.float32,
                        device=device).to(ftype)


# ---------------------------------------------------------------------------
# the signed production residual (full resolution: RCT, DCT, round) and the
# bare-plane residual (4:2:0: DCT, round); ties round half to even

def _scalar(v, like):
    # a tensor, so that the division is IEEE division in ftype
    return torch.tensor(v, dtype=torch.float32, device=like.device).to(
        like.dtype)


def signed_bgr_to_ycc(resid):
    b, g, r = resid[..., 0, :, :], resid[..., 1, :, :], resid[..., 2, :, :]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cr = (r - y) * 0.713
    cb = (b - y) * 0.564
    return torch.stack([y, cr, cb], dim=-3)


def signed_ycc_to_bgr(ycc):
    y, cr, cb = ycc[..., 0, :, :], ycc[..., 1, :, :], ycc[..., 2, :, :]
    r = y + cr / _scalar(0.713, ycc)
    b = y + cb / _scalar(0.564, ycc)
    g = (y - 0.299 * r - 0.114 * b) / _scalar(0.587, ycc)
    return torch.stack([b, g, r], dim=-3)


def code_residual_rgb(resid, qf, ftype):
    """Signed residual [..., 3, H, W] -> int16 coefficient planes."""
    ycc = signed_bgr_to_ycc(resid.to(ftype))
    d = dct2_blocks(plane_to_blocks(ycc, 8))
    q = quant_tables(qf, ftype, resid.device)[:, None, None]
    return blocks_to_plane(torch.round(d / q)).to(torch.int16)


def decode_residual_rgb(coeffs, qf, ftype):
    """int16 coefficient planes [..., 3, H, W] -> signed residual int32."""
    q = quant_tables(qf, ftype, coeffs.device)[:, None, None]
    v = idct2_blocks(plane_to_blocks(coeffs.to(ftype), 8) * q)
    return torch.round(signed_ycc_to_bgr(blocks_to_plane(v))).to(torch.int32)


def code_planes(resid, table):
    """Signed residual planes [..., H, W] -> int16 coefficients."""
    d = dct2_blocks(plane_to_blocks(resid.to(table.dtype), 8))
    return blocks_to_plane(torch.round(d / table)).to(torch.int16)


def decode_planes(coeffs, table):
    """int16 coefficient planes [..., H, W] -> signed residual int32."""
    v = idct2_blocks(plane_to_blocks(coeffs.to(table.dtype), 8) * table)
    return torch.round(blocks_to_plane(v)).to(torch.int32)


# ---------------------------------------------------------------------------
# block motion search and compensation

@functools.lru_cache(maxsize=None)
def search_plan(h, w, bs, reach, step):
    """Per axis: candidate positions max(c - reach, 0) + step * k and their
    validity p + bs < min(c + reach, extent) -> (k, pos_i, valid_i, pos_j,
    valid_j)."""
    k = -(-2 * reach // step)

    def axis(nb, extent):
        c = np.arange(nb) * bs
        lo = np.maximum(c - reach, 0)
        hi = np.minimum(c + reach, extent)
        pos = lo[:, None] + step * np.arange(k)[None, :]
        return pos.astype(np.int32), pos + bs < hi[:, None]

    pos_i, valid_i = axis(h // bs, h)
    pos_j, valid_j = axis(w // bs, w)
    return k, pos_i, valid_i, pos_j, valid_j


def tile_sums(x, bs):
    """[..., C, H, W] -> per-block sums over C [..., H/bs, W/bs] int32."""
    *lead, c, h, w = x.shape
    x = x.reshape(*lead, c, h // bs, bs, w // bs, bs)
    return x.sum(dim=(-5, -3, -1), dtype=torch.int32)


def static_sad(curs, refs, bs):
    """Saturating co-located SAD sum max(ref - cur, 0)."""
    return tile_sums((refs.to(torch.int16) - curs.to(torch.int16)
                      ).clamp_(min=0), bs)


def motion_search(curs, refs, bs, reach, step, static_threshold, log=None):
    """curs [G, F, C, H, W] against refs [G, C, H, W] -> vectors
    [G, F, nbh, nbw, 2] int32 (dx, dy): the first minimum of the wrapping
    SAD sum((ref - cur) & 255) over the valid candidates in row-major
    order, against a virtual best at absolute (0, 0) that any valid
    candidate beats; a block whose static SAD is <= the threshold keeps the
    zero vector. `log` (a list), when given, receives each call's geometry
    and static mask, from which the benchmark counts the search's work."""
    g, f, c, h, w = curs.shape
    dev = curs.device
    k, pos_i_np, valid_i, pos_j_np, valid_j = search_plan(h, w, bs, reach,
                                                          step)
    nbh, nbw = h // bs, w // bs
    cur16 = curs.to(torch.int16)
    ref16 = refs.to(torch.int16)
    offs = torch.arange(bs, device=dev)
    pi_c = torch.as_tensor(np.minimum(pos_i_np, h - bs), device=dev)
    pj_c = torch.as_tensor(np.minimum(pos_j_np, w - bs), device=dev)
    sad = torch.empty((g, f, nbh, nbw, k, k), dtype=torch.int32, device=dev)
    for ki in range(k):
        rows = (pi_c[:, ki, None] + offs).reshape(-1)
        ref_rows = ref16.index_select(-2, rows)
        for kj in range(k):
            cols = (pj_c[:, kj, None] + offs).reshape(-1)
            cand = ref_rows.index_select(-1, cols)[:, None]
            sad[..., ki, kj] = tile_sums((cand - cur16) & 255, bs)
    sh = (k * k + 1).bit_length()
    sent = (c * 255 * bs * bs + 1) << sh
    valid = torch.as_tensor(valid_i[:, None, :, None]
                            & valid_j[None, :, None, :], device=dev)
    idx = torch.arange(1, k * k + 1, dtype=torch.int32,
                       device=dev).reshape(k, k)
    key = torch.where(valid, (sad << sh) + idx,
                      torch.tensor(sent + (1 << sh) - 1, dtype=torch.int32,
                                   device=dev))
    best = key.amin(dim=(-2, -1)).clamp(max=sent)
    hit = best < sent
    flat = ((best & ((1 << sh) - 1)) - 1).clamp(min=0)
    ki, kj = flat // k, flat % k
    bi = torch.arange(nbh, device=dev)[:, None]
    bj = torch.arange(nbw, device=dev)[None, :]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    pi = torch.where(hit, torch.as_tensor(pos_i_np, device=dev)[bi, ki], zero)
    pj = torch.where(hit, torch.as_tensor(pos_j_np, device=dev)[bj, kj], zero)
    ci, cj = (bi * bs).to(torch.int32), (bj * bs).to(torch.int32)
    stat = static_sad(curs, refs[:, None], bs) <= static_threshold
    if log is not None:
        log.append(dict(g=g, f=f, c=c, h=h, w=w, bs=bs, reach=reach,
                        step=step, static=stat.cpu().numpy()))
    pi = torch.where(stat, ci, pi)
    pj = torch.where(stat, cj, pj)
    return torch.stack([pj - cj, pi - ci], dim=-1).to(torch.int32)


def motion_compensate(mv, refs, bs):
    """mv [G, F, nbh, nbw, 2] against refs [G, C, H, W] -> [G, F, C, H, W]:
    each block copied from its source origin, a negative origin first
    taking the extent added, then clamped into the frame."""
    g, f, nbh, nbw, _ = mv.shape
    _, c, h, w = refs.shape
    dev = refs.device
    offs = torch.arange(bs, device=dev)

    def origin(o, extent):
        return torch.where(o < 0, o + extent, o).clamp(0, extent - bs)

    i0 = origin(torch.arange(nbh, device=dev)[:, None] * bs + mv[..., 1], h)
    j0 = origin(torch.arange(nbw, device=dev)[None, :] * bs + mv[..., 0], w)
    rows = i0[..., None, None] + offs[:, None]
    cols = j0[..., None, None] + offs[None, :]
    index = (rows * w + cols).reshape(g, f, 1, -1).expand(g, f, c, -1)
    src = refs.reshape(g, 1, c, h * w).expand(g, f, c, h * w)
    blocks = torch.gather(src, 3, index).reshape(g, f, c, nbh, nbw, bs, bs)
    return blocks.transpose(-3, -2).reshape(g, f, c, h, w)


def bi_average(pred_f, pred_b):
    return ((pred_f.to(torch.int32) + pred_b.to(torch.int32) + 1) >> 1
            ).to(torch.uint8)


def block_choice(mode, pred_f, pred_b, cell):
    """Per-block choice among forward (0), backward (1) and their rounded
    average (2) by mode [N, nbh, nbw] on cells of `cell` pixels."""
    mpix = mode.repeat_interleave(cell, -2).repeat_interleave(cell, -1)
    mpix = mpix.reshape(mpix.shape[0], *(1,) * (pred_f.ndim - 3),
                        *mpix.shape[1:])
    return torch.where(mpix == 0, pred_f, torch.where(
        mpix == 1, pred_b, bi_average(pred_f, pred_b)))


def choose_mode(cur, preds, bs):
    """The smallest block SAD over the channels among the forward, backward
    and average predictions; the first minimum wins a tie. cur and preds
    [N, C, H, W] -> mode int8 [N, nbh, nbw]."""
    cur = cur.to(torch.int32)
    sads = torch.stack([tile_sums((p.to(torch.int32) - cur).abs(), bs)
                        for p in preds])
    return torch.argmin(sads, dim=0).to(torch.int8)


# ---------------------------------------------------------------------------
# 4x4 intra prediction and the closed-loop lossy intra wavefront (integer)

BS4 = 4
SENTINEL = 16 * 255


def _fill(u_raw, l_raw, ul_raw, ur_raw, a_u, a_l, a_ul, a_ur, fill):
    u = torch.where(a_u[..., None], u_raw, fill)
    l = torch.where(a_l[..., None], l_raw, fill)
    ul = torch.where(a_ul, ul_raw, fill)
    ur_fb = torch.where(a_u, u_raw[..., 3], fill)
    ur = torch.where(a_ur[..., None], ur_raw, ur_fb[..., None])
    return u, l, ul, ur


def _w3(x, wrap):
    t = 3 * x
    return torch.where(wrap, t & 255, t)


def _assemble(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _preds9(u, l, ul, ur, a_u, a_l, a_ur):
    """The nine 4x4 predictors -> [9, ..., 4, 4] int32 (vertical,
    horizontal, DC, down-left, down-right, vertical-right,
    horizontal-down, vertical-left, horizontal-up)."""
    s = torch.where((a_u & a_l)[..., None], (u + l) & 255, u + l)
    dc = (s.sum(dim=-1, dtype=torch.int32) // 8)[..., None, None]
    e = torch.cat([u, ur], dim=-1)
    dl = [e[..., k] // 4 + e[..., k + 1] // 2 + e[..., k + 2] // 4
          for k in range(6)]
    dl.append(e[..., 6] // 4 + _w3(e[..., 7], a_ur) // 4)
    d = {3: u[..., 1] // 4 + u[..., 2] // 2 + u[..., 3] // 4,
         2: u[..., 0] // 4 + u[..., 1] // 2 + u[..., 2] // 4,
         1: ul // 4 + u[..., 0] // 2 + u[..., 1] // 4,
         0: ul // 4 + u[..., 0] // 2 + l[..., 0] // 4,
         -1: u[..., 0] // 4 + l[..., 0] // 2 + l[..., 1] // 4,
         -2: l[..., 0] // 4 + l[..., 1] // 2 + l[..., 2] // 4,
         -3: l[..., 1] // 4 + l[..., 2] // 2 + l[..., 3] // 4}
    # vertical-right
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
    vr = _assemble([[a0, a1, a2, a3], [b0, b1, b2, b3], [c0, a0, a1, a2],
                    [d0, b0, b1, b2]])
    # horizontal-down
    h0 = ul // 2 + l[..., 0] // 2
    h1 = u[..., 0] // 4 + ul // 2 + l[..., 0] // 4
    h2 = ul // 4 + u[..., 0] // 2 + u[..., 1] // 4
    h3 = u[..., 0] // 4 + u[..., 1] // 2 + u[..., 2] // 4
    i0 = l[..., 0] // 2 + l[..., 1] // 2
    i1 = ul // 4 + l[..., 1] // 2 + l[..., 2] // 4
    j0 = l[..., 1] // 2 + l[..., 2] // 2
    j1 = l[..., 0] // 4 + l[..., 1] // 2 + l[..., 2] // 4
    k0 = l[..., 2] // 2 + l[..., 3] // 2
    k1 = l[..., 1] // 4 + l[..., 2] // 2 + l[..., 3] // 4
    hd = _assemble([[h0, h1, h2, h3], [i0, i1, h0, h1], [j0, j1, i0, i1],
                    [k0, k1, j0, j1]])
    # vertical-left
    v0 = u[..., 0] // 2 + u[..., 1] // 2
    v1 = u[..., 1] // 2 + u[..., 2] // 2
    v2 = u[..., 2] // 2 + u[..., 3] // 2
    v3 = u[..., 3] // 2 + ur[..., 0] // 2
    v4 = ur[..., 0] // 2 + ur[..., 1] // 2
    w0 = u[..., 0] // 4 + u[..., 1] // 2 + u[..., 2] // 4
    w1 = u[..., 1] // 4 + u[..., 2] // 2 + u[..., 3] // 4
    w2 = u[..., 2] // 4 + u[..., 3] // 2 + ur[..., 0] // 4
    w3 = u[..., 3] // 4 + ur[..., 0] // 2 + ur[..., 1] // 4
    w4 = ur[..., 0] // 4 + ur[..., 1] // 2 + ur[..., 2] // 4
    vl = _assemble([[v0, v1, v2, v3], [w0, w1, w2, w3], [v1, v2, v3, v4],
                    [w1, w2, w3, w4]])
    # horizontal-up
    x0 = l[..., 0] // 2 + l[..., 1] // 2
    x1 = l[..., 0] // 4 + l[..., 1] // 2 + l[..., 2] // 4
    x2 = l[..., 1] // 2 + l[..., 2] // 2
    x3 = l[..., 1] // 4 + l[..., 2] // 2 + l[..., 3] // 4
    y2 = l[..., 2] // 2 + l[..., 3] // 2
    y3 = l[..., 2] // 4 + _w3(l[..., 3], a_l) // 4
    z = l[..., 3]
    hu = _assemble([[x0, x1, x2, x3], [x2, x3, y2, y3], [y2, y3, z, z],
                    [z, z, z, z]])
    shape = (*u.shape[:-1], 4, 4)
    return torch.stack([
        u[..., None, :].expand(shape), l[..., :, None].expand(shape),
        dc.expand(shape), _assemble([[dl[r + c] for c in range(4)]
                                     for r in range(4)]),
        _assemble([[d[c - r] for c in range(4)] for r in range(4)]),
        vr, hd, vl, hu])


_CF4 = ((1, 1, 1, 1), (2, 1, -1, -2), (1, -1, -1, 1), (1, -2, 2, -1))
_CI4X2 = ((2, 2, 2, 1), (2, 1, -2, -2), (2, -1, -2, 2), (2, -2, 2, -1))
_G4X400 = tuple(tuple(a * b for b in (5, 4, 5, 4)) for a in (5, 4, 5, 4))


def _iround_div(a, b):
    return torch.sign(a) * ((2 * a.abs() + b) // (2 * b))


def _both_sides(mt, x):
    """mt X mt^T for X [..., 4, 4] int32 and an int32 4x4 matrix mt."""
    t = (mt[:, :, None] * x[..., None, :, :]).sum(dim=-2, dtype=torch.int32)
    return (t[..., :, None, :] * mt).sum(dim=-1, dtype=torch.int32)


def intra_encode_lossy(planes, qstep):
    """Closed-loop lossy 4x4 intra coding of planes [N, H, W] (uint8) in
    wavefront order (block (bi, bj) on diagonal 2 bi + bj, predicted from
    the reconstruction) -> (qcoef int16 [N, H, W] in block layout, modes
    int8 and escape bool [N, H/4, W/4], recon uint8 [N, H, W])."""
    n, h, w = planes.shape
    nbh, nbw = h // BS4, w // BS4
    dev = planes.device
    orig = plane_to_blocks(planes.to(torch.int32), BS4)
    q_out = torch.zeros_like(orig)
    modes = torch.zeros((n, nbh, nbw), dtype=torch.int32, device=dev)
    escape = torch.zeros((n, nbh, nbw), dtype=torch.bool, device=dev)
    rec = torch.zeros((n, nbh, nbw, BS4, BS4), dtype=torch.int32, device=dev)
    # constants made once: each tensor made from host data is a copy
    gn = torch.tensor(_G4X400, dtype=torch.int32, device=dev)
    cf = torch.tensor(_CF4, dtype=torch.int32, device=dev)
    ci = torch.tensor(_CI4X2, dtype=torch.int32, device=dev)
    fill = torch.tensor(128, dtype=torch.int32, device=dev)
    idx9 = torch.arange(1, 10, dtype=torch.int32, device=dev).reshape(9, 1, 1)
    rows = torch.arange(nbh, device=dev)
    for t in range(2 * (nbh - 1) + nbw):
        lo, hi = max(0, (t - nbw + 2) // 2), min(nbh, t // 2 + 1)
        bi = rows[lo:hi]
        bj = t - 2 * bi
        a_u, a_l = bi >= 1, bj >= 1
        a_ul, a_ur = a_u & a_l, a_u & (bj < nbw - 1)
        up, left = (bi - 1).clamp(min=0), (bj - 1).clamp(min=0)
        right = (bj + 1).clamp(max=nbw - 1)
        u, l, ul, ur = _fill(rec[:, up, bj][..., 3, :],
                             rec[:, bi, left][..., :, 3],
                             rec[:, up, left][..., 3, 3],
                             rec[:, up, right][..., 3, :],
                             a_u, a_l, a_ul, a_ur, fill)
        oblk = orig[:, bi, bj]
        preds = _preds9(u, l, ul, ur, a_u, a_l, a_ur)
        sads = (preds - oblk[None]).abs().sum(dim=(-2, -1), dtype=torch.int32)
        keys = sads * 16 + idx9
        kmin = keys.amin(dim=0)
        esc = kmin > SENTINEL * 16
        mode = torch.where(esc, 0, (kmin & 15) - 1)
        pred = torch.gather(preds, 0, mode.clamp(0, 8).to(torch.int64)[
            None, ..., None, None].expand(1, *mode.shape, 4, 4))[0]
        pred = torch.where((~esc)[..., None, None], pred, 0)
        q = _iround_div(_both_sides(cf, oblk - pred) * gn, 400 * qstep)
        q_out[:, bi, bj] = q
        modes[:, bi, bj] = mode
        escape[:, bi, bj] = esc
        rec[:, bi, bj] = (pred + _iround_div(
            _both_sides(ci, q * qstep), 4)).clamp(0, 255)
    return (blocks_to_plane(q_out).to(torch.int16), modes.to(torch.int8),
            escape, blocks_to_plane(rec).to(torch.uint8))
