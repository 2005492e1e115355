"""The 4:2:0 codec mode: Y plus quarter-resolution chroma through the whole
codec (counterpart of `vcs_h264_tpu/models/pipeline420.py`).

Frames are ingested once to planar Y [H, W] and Cr/Cb [H/2, W/2] (the
cv2-exact colour conversion and the box-filter decimation), the motion
search runs on luma alone, chroma rides the floor-halved luma vectors on
4-pixel cells, and the residual of each plane is coded by an 8x8 DCT with
the JPEG luma table on Y and the chroma table on Cr and Cb, rounded to
int16 (the production path; `CodecConfig` refuses 4:2:0 otherwise). With
`intra_qstep > 0` the I planes are lossy intra-coded, luma and chroma as
separate plane batches, and every other frame references their
reconstruction.

On a GPU the P-frames take the search (K2), the fused bare-plane encode and
decode on luma (the C == 1 case of K3/K4) and the fused chroma encode and
decode (K7). B-frames reference the DECODED anchors: two searches (K2),
the compensation of both planes sets (K1, at block size 8 on Y and 4 on
the two chroma planes), a per-block choice of forward, backward or their
rounded average made on luma SAD alone, and the residual of the chosen
prediction through the plain per-plane DCT, which the JAX package also
computes outside any kernel.

`backend` as in `models/pipeline.py`. Planes are uint8 on the device; the
leading axis of the batched entry points is the GOP batch.
"""

from __future__ import annotations

import dataclasses

import torch

from vcs_h264_tpu_torch.config import CodecConfig
from vcs_h264_tpu_torch.models import intra_codec
from vcs_h264_tpu_torch.models.gop import EncodedGOP420
from vcs_h264_tpu_torch.models.pipeline import (_bi_average, gop_layout,
                                                put_frames, take_frames)
from vcs_h264_tpu_torch.ops import (color, inter_cuda, intra, motion,
                                    subsample)
from vcs_h264_tpu_torch.ops.quant import quant_tables

__all__ = ["EncodedGOP420", "decode_gop_batch_420", "decode_intra_420",
           "emit_bgr", "encode_gop_batch_420", "encode_intra_420",
           "ingest_420"]


def ingest_420(bgr_planes: torch.Tensor):
    """Planar BGR [..., 3, H, W] (uint8 values) -> (y uint8 [..., H, W],
    c uint8 [..., 2, H/2, W/2] holding Cr and Cb)."""
    y, cr, cb = subsample.encode_420(color.bgr_to_ycrcb_planes(bgr_planes))
    return y.to(torch.uint8), torch.stack([cr, cb], dim=-3).to(torch.uint8)


def emit_bgr(y: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(y [..., H, W], c [..., 2, H/2, W/2]) -> planar BGR uint8
    [..., 3, H, W], chroma upsampled to its nearest neighbour."""
    ycc = subsample.decode_420(y, c[..., 0, :, :], c[..., 1, :, :])
    return color.ycrcb_to_bgr_planes(ycc).to(torch.uint8)


def _tables(cfg: CodecConfig, device):
    """(QY, QC), float32 [8, 8] each."""
    q = quant_tables(cfg.quality_factor, device)
    return q[0], q[1]


def _chroma_mv(mv: torch.Tensor) -> torch.Tensor:
    """Luma vectors -> chroma vectors on the half-resolution planes, by
    floor division (-1 -> -1, -3 -> -2), not truncation."""
    return torch.div(mv, 2, rounding_mode="floor")


def _search(y_cur, y_ref, cfg: CodecConfig, backend: str) -> torch.Tensor:
    """Luma-only search: y_cur [B, F, H, W] against y_ref [B, H, W]. The
    static threshold is denominated in 3-channel SAD, so one plane takes a
    third of it."""
    return motion.motion_search_gops(
        y_cur[:, :, None], y_ref[:, None], bs=cfg.block_size,
        reach=cfg.search_reach, step=cfg.search_step,
        static_threshold=cfg.static_threshold // 3, backend=backend)


def _predict(mv, y_ref, c_ref, cfg: CodecConfig, backend: str):
    """(luma mv [B, F, nbh, nbw, 2], reference planes y_ref [B, H, W] and
    c_ref [B, 2, H/2, W/2]) -> (pred_y [B, F, H, W], pred_c
    [B, F, 2, H/2, W/2]).

    Both go to K1 on a GPU. The JAX package sends the 4-pixel chroma blocks
    to its XLA gather, because its TPU kernel needs block rows that are
    multiples of 8, and passes a reach its kernel pads by; K1 takes any
    block size >= 2 and any vector, so neither choice exists here."""
    bs = cfg.block_size
    pred_y = motion.motion_compensate_gops(mv, y_ref[:, None], bs=bs,
                                           backend=backend)[:, :, 0]
    pred_c = motion.motion_compensate_gops(_chroma_mv(mv), c_ref, bs=bs // 2,
                                           backend=backend)
    return pred_y, pred_c


def _b_choice(mode, pred_f, pred_b, cell: int) -> torch.Tensor:
    """Per-block choice among forward, backward and their rounded average
    by mode [N, nbh, nbw] on cells of `cell` pixels; predictions
    [N, ..., H, W] with the block grid on the last two axes."""
    mpix = mode.repeat_interleave(cell, -2).repeat_interleave(cell, -1)
    mpix = mpix.reshape(mpix.shape[0], *(1,) * (pred_f.ndim - 3),
                        *mpix.shape[1:])
    return torch.where(mpix == 0, pred_f, torch.where(
        mpix == 1, pred_b, _bi_average(pred_f, pred_b)))


def _b_refs(anch_y, anch_c, cfg: CodecConfig):
    """Anchors [B, NA, ...] -> each B-frame's forward and backward
    reference planes, flattened over (gop, B-frame): (prev_y, next_y,
    prev_c, next_c)."""
    _, _, prev_slot, next_slot, _, _ = gop_layout(cfg.gop_pattern)

    def pick(x, slots):
        return take_frames(x, slots).flatten(0, 1)

    return (pick(anch_y, prev_slot), pick(anch_y, next_slot),
            pick(anch_c, prev_slot), pick(anch_c, next_slot))


def _code(resid_of, pred, table):
    """The plain per-plane residual coding of cur - pred (uint8 both)."""
    return inter_cuda.code_planes(
        resid_of.to(torch.int32) - pred.to(torch.int32), table)


def _add_back(pred, coeffs, table) -> torch.Tensor:
    """clip(pred + decoded residual, 0, 255) as uint8."""
    out = pred.to(torch.int32) + inter_cuda.decode_planes(coeffs, table)
    return out.clamp_(0, 255).to(torch.uint8)


def _encode_b(yb, cb, prev_y, next_y, prev_c, next_c, cfg: CodecConfig,
              backend: str):
    """The B stage on N B-frames, each against its own anchors: planes yb
    [N, H, W] and cb [N, 2, H/2, W/2], references prev_* and next_* of the
    same shapes -> (b_mv [N, 2, nbh, nbw, 2], mode int8 [N, nbh, nbw], the
    chosen predictions pred_y and pred_c, bres_y, bres_c)."""
    # the B-frame axis is the search's GOP axis, one frame each
    mv_f = _search(yb[:, None], prev_y, cfg, backend)     # [N, 1, nbh, nbw, 2]
    mv_b = _search(yb[:, None], next_y, cfg, backend)
    pf_y, pf_c = (x[:, 0] for x in _predict(mv_f, prev_y, prev_c, cfg,
                                            backend))
    pb_y, pb_c = (x[:, 0] for x in _predict(mv_b, next_y, next_c, cfg,
                                            backend))
    return (torch.stack([mv_f[:, 0], mv_b[:, 0]], dim=1),
            *_choose_and_code(yb, cb, pf_y, pb_y, pf_c, pb_c, cfg))


def _choose_and_code(yb, cb, pf_y, pb_y, pf_c, pb_c, cfg: CodecConfig):
    """The B stage after its predictions, block by block: the per-block
    mode by the smallest luma SAD and the residual of the chosen
    prediction -> (mode int8 [N, nbh, nbw], pred_y, pred_c, bres_y,
    bres_c)."""
    bs = cfg.block_size
    qy, qc = _tables(cfg, yb.device)
    # argmin takes the first minimum, so ties prefer forward, then
    # backward, then the average
    cur = yb.to(torch.int32)
    sads = torch.stack([
        motion.tile_sums((p.to(torch.int32) - cur).abs()[:, None], bs)
        for p in (pf_y, pb_y, _bi_average(pf_y, pb_y))])
    mode = torch.argmin(sads, dim=0).to(torch.int8)
    pred_y = _b_choice(mode, pf_y, pb_y, bs)
    pred_c = _b_choice(mode, pf_c, pb_c, bs // 2)
    return (mode, pred_y, pred_c, _code(yb, pred_y, qy),
            _code(cb, pred_c, qc))


def encode_intra_420(y_i: torch.Tensor, c_i: torch.Tensor, qstep: int,
                     backend: str = "auto"):
    """Lossy intra coding of I planes y_i uint8 [B, H, W] and c_i uint8
    [B, 2, H/2, W/2], luma and chroma as separate plane batches -> (the
    reconstructions (y, c) the other frames reference, the six payload
    fields of `EncodedGOP420` with the leading B)."""
    pay_y, rec_y = intra_codec.encode_intra_frames_lossy_batch(
        y_i[:, None], qstep, backend)
    pay_c, rec_c = intra_codec.encode_intra_frames_lossy_batch(
        c_i, qstep, backend)
    return (rec_y[:, 0], rec_c), dict(
        iq_y=pay_y.qcoef, im_y=pay_y.modes, ie_y=pay_y.escape,
        iq_c=pay_c.qcoef, im_c=pay_c.modes, ie_c=pay_c.escape)


def encode_gop_batch_420(i_frames: torch.Tensor, p_frames: torch.Tensor,
                         cfg: CodecConfig,
                         backend: str = "auto") -> EncodedGOP420:
    """i_frames planar BGR uint8 [B, 3, H, W]; p_frames uint8
    [B, F, 3, H, W], all non-I frames in display order (F >= 1) -> a batch
    of EncodedGOP420. H and W must be multiples of 2 * block_size. A B
    pattern is used only when the GOP is complete; a shorter GOP is coded
    all-P."""
    bs = cfg.block_size
    if i_frames.shape[-2] % (2 * bs) or i_frames.shape[-1] % (2 * bs):
        raise ValueError(f"4:2:0 needs H and W multiples of {2 * bs}, got "
                         f"{tuple(i_frames.shape[-2:])}")
    qf = cfg.quality_factor
    y_i, c_i = ingest_420(i_frames)                  # [B, H, W], [B, 2, h, w]
    y_p, c_p = ingest_420(p_frames)                  # [B, F, H, W], ...
    use_b = cfg.has_b and p_frames.shape[1] == cfg.gop_len - 1
    if use_b:
        _, _, _, _, p_sel, b_sel = gop_layout(cfg.gop_pattern)
        y_b, c_b = take_frames(y_p, b_sel), take_frames(c_p, b_sel)
        y_p, c_p = take_frames(y_p, p_sel), take_frames(c_p, p_sel)

    payload = {}
    if cfg.intra_qstep:
        (y_i, c_i), payload = encode_intra_420(y_i, c_i, cfg.intra_qstep,
                                               backend)
    y_i, c_i = y_i.contiguous(), c_i.contiguous()
    y_p, c_p = y_p.contiguous(), c_p.contiguous()

    mv = _search(y_p, y_i, cfg, backend)             # [B, NP, nbh, nbw, 2]
    mv_c = _chroma_mv(mv)
    res_y = inter_cuda.encode_p_coeffs(mv, y_i[:, None], y_p[:, :, None], qf,
                                       backend)[:, :, 0]
    res_c = inter_cuda.encode_c420_coeffs(mv_c, c_i, c_p, qf, backend)
    gop = EncodedGOP420(i_y=y_i, i_c=c_i, mv=mv, res_y=res_y, res_c=res_c,
                        **payload)
    if not use_b:
        return gop

    # closed loop: B-frames reference the decoded anchors
    dec_y = inter_cuda.decode_p_frames(mv, y_i[:, None], res_y[:, :, None],
                                       qf, backend)[:, :, 0]
    dec_c = inter_cuda.decode_c420_frames(mv_c, c_i, res_c, qf, backend)
    refs = _b_refs(torch.cat([y_i[:, None], dec_y], dim=1),
                   torch.cat([c_i[:, None], dec_c], dim=1), cfg)
    bb, nb = y_b.shape[:2]
    b_mv, mode, _, _, bres_y, bres_c = _encode_b(
        y_b.flatten(0, 1), c_b.flatten(0, 1), *refs, cfg, backend)

    def unflat(x):
        return x.reshape(bb, nb, *x.shape[1:])

    return dataclasses.replace(gop, b_mv=unflat(b_mv), b_mode=unflat(mode),
                               bres_y=unflat(bres_y), bres_c=unflat(bres_c))


def decode_gop_batch_420(gop: EncodedGOP420, cfg: CodecConfig,
                         as_bgr: bool = True, backend: str = "auto"):
    """Batched EncodedGOP420 with F >= 1 P-frames -> planar BGR uint8
    [B, num_coded, 3, H, W] in display order, or with as_bgr=False the
    plane stacks (y [B, num_coded, H, W], c [B, num_coded, 2, H/2, W/2])."""
    bs, qf = cfg.block_size, cfg.quality_factor
    y_i, c_i = gop.i_y.contiguous(), gop.i_c.contiguous()
    mv = gop.mv.contiguous()
    rec_y = inter_cuda.decode_p_frames(
        mv, y_i[:, None], gop.res_y[:, :, None].contiguous(), qf,
        backend)[:, :, 0]
    rec_c = inter_cuda.decode_c420_frames(
        _chroma_mv(mv), c_i, gop.res_c.contiguous(), qf, backend)
    y = torch.cat([y_i[:, None], rec_y], dim=1)           # [B, NA, H, W]
    c = torch.cat([c_i[:, None], rec_c], dim=1)
    if gop.b_mv is not None:
        qy, qc = _tables(cfg, y.device)
        anchor_pos, b_pos, _, _, _, _ = gop_layout(cfg.gop_pattern)
        prev_y, next_y, prev_c, next_c = _b_refs(y, c, cfg)
        bb, nb = gop.b_mv.shape[:2]
        bmv = gop.b_mv.flatten(0, 1)                      # [B*NB, 2, ...]
        pf_y, pf_c = (x[:, 0] for x in _predict(
            bmv[:, 0:1].contiguous(), prev_y, prev_c, cfg, backend))
        pb_y, pb_c = (x[:, 0] for x in _predict(
            bmv[:, 1:2].contiguous(), next_y, next_c, cfg, backend))
        mode = gop.b_mode.flatten(0, 1)
        by = _add_back(_b_choice(mode, pf_y, pb_y, bs),
                       gop.bres_y.flatten(0, 1), qy)
        bc = _add_back(_b_choice(mode, pf_c, pb_c, bs // 2),
                       gop.bres_c.flatten(0, 1), qc)
        yo = y.new_empty((bb, cfg.gop_len, *y.shape[2:]))
        co = c.new_empty((bb, cfg.gop_len, *c.shape[2:]))
        put_frames(yo, anchor_pos, y)
        put_frames(co, anchor_pos, c)
        put_frames(yo, b_pos, by.reshape(bb, nb, *by.shape[1:]))
        put_frames(co, b_pos, bc.reshape(bb, nb, *bc.shape[1:]))
        y, c = yo, co
    if not as_bgr:
        return y, c
    return emit_bgr(y, c)


def decode_intra_420(gop: EncodedGOP420, qstep: int,
                     backend: str = "auto") -> EncodedGOP420:
    """One GOP, or a batch with a leading axis, with `i_y` / `i_c` decoded
    from the lossy-intra payload: bit for bit the encoder's
    reconstruction."""
    def planes(q, modes, escape):
        out = intra.intra_decode4x4_lossy_batch(
            *(x.flatten(0, -3).contiguous() for x in (q, modes, escape)),
            qstep, backend)
        return out.reshape(q.shape)

    return dataclasses.replace(
        gop, i_y=planes(gop.iq_y, gop.im_y, gop.ie_y)[..., 0, :, :],
        i_c=planes(gop.iq_c, gop.im_c, gop.ie_c))
