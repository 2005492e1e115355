"""The plain reference codec: whole GOPs of BGR uint8 frames -> the stream's
fields and the frames a correct decoder gives back.

Two layouts, as a configuration file states them:
  * full resolution (4:4:4 BGR planes): lossy-intra I-frame, P-frames
    searched against it and coded as the signed residual through the RCT,
    the 8x8 DCT and round-half-even quantisation; B-frames (closed loop)
    searched against the decoded anchors before and after them, each block
    predicted forward, backward or by their rounded average, and coded the
    same way;
  * 4:2:0 (`chroma_420`): frames ingested to Y and half-resolution Cr/Cb,
    the search on luma with a third of the static threshold, chroma riding
    the floor-halved luma vectors on 4-pixel cells, each plane's residual
    through the DCT alone (luma table on Y, chroma table on Cr and Cb), the
    B mode chosen on luma SAD.

A pattern with no P-anchor (all-intra, `("I",)`; a B needs a P after it)
codes each GOP as its lossy-intra I-frame alone, in either layout, with no
vectors and no residual. Under `search_luma_only` a full-resolution search
compares the G channel alone (4:2:0 searches luma anyway).

Only whole GOPs of the configuration's pattern are coded, with lossy intra
I-frames and the production residual (`quant_mode` "rounded", signed, DCT,
block 8): the configurations the benchmark serves. Everything is plain
PyTorch on the device of the input frames; nothing of the program is
imported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from . import plain_ops as ops


@dataclasses.dataclass(frozen=True)
class Config:
    """The codec settings a configuration file states (its `codec`)."""
    block_size: int
    gop_pattern: Tuple[str, ...]
    search_reach: int
    static_threshold: int
    search_step: int
    search_luma_only: bool
    quality_factor: float
    with_residual: bool
    with_dct: bool
    quant_mode: str
    intra_i: bool
    intra_qstep: int
    signed_residual: bool
    chroma_420: bool
    dtype: str

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        d = dict(d)
        d["gop_pattern"] = tuple(d["gop_pattern"])
        cfg = cls(**d)
        if not (cfg.quant_mode == "rounded" and cfg.with_dct
                and cfg.with_residual and cfg.signed_residual
                and cfg.intra_i and cfg.intra_qstep > 0
                and cfg.block_size == 8 and cfg.dtype == "float32"):
            raise ValueError("the reference codes the production path with "
                             "lossy intra I-frames at block 8 in float32")
        return cfg

    @property
    def layout(self):
        """(anchor positions, B positions, per B its previous and next
        anchor slot) of the GOP pattern."""
        pat = self.gop_pattern
        anchors = tuple(t for t, x in enumerate(pat) if x != "B")
        b_pos = tuple(t for t, x in enumerate(pat) if x == "B")
        slot = {t: s for s, t in enumerate(anchors)}
        prev = tuple(slot[max(a for a in anchors if a < t)] for t in b_pos)
        nxt = tuple(slot[min(a for a in anchors if a > t)] for t in b_pos)
        return anchors, b_pos, prev, nxt


def _planar(frames):
    """BGR [..., H, W, 3] -> planar [..., 3, H, W]."""
    return frames.movedim(-1, -3).contiguous()


def _search(curs, refs, cfg, threshold, log):
    """Under `search_luma_only` a full-resolution search compares the G
    channel (index 1 of planar BGR) alone, against a third of the threshold,
    which is denominated in 3-channel SAD; the vectors still move all
    three channels."""
    if cfg.search_luma_only and not cfg.chroma_420:
        curs, refs, threshold = curs[:, :, 1:2], refs[:, 1:2], threshold // 3
    return ops.motion_search(curs, refs, cfg.block_size, cfg.search_reach,
                             cfg.search_step, threshold, log)


def _intra(planes, qstep):
    """Lossy intra of [G, C, H, W] planes -> (qcoef, modes, escape, recon)
    with the leading [G, C]."""
    g, c = planes.shape[:2]
    out = ops.intra_encode_lossy(planes.reshape(g * c, *planes.shape[2:]),
                                 qstep)
    return tuple(x.reshape(g, c, *x.shape[1:]) for x in out)


def encode(frames: torch.Tensor, cfg: Config, ftype=torch.float32,
           log: Optional[list] = None):
    """frames uint8 [G, L, H, W, 3] (G whole GOPs, L the pattern's length)
    -> (fields: the stream's integer fields with a leading G, named as the
    `.vcs` reader names them; recon: the decoded frames uint8
    [G, L, H, W, 3])."""
    if frames.shape[1] != len(cfg.gop_pattern):
        raise ValueError("the reference codes whole GOPs only")
    if "P" not in cfg.gop_pattern:
        return encode_intra_only(frames, cfg)
    if cfg.chroma_420:
        return _encode_420(_planar(frames), cfg, ftype, log)
    return _encode_444(_planar(frames), cfg, ftype, log)


def encode_intra_only(frames: torch.Tensor, cfg: Config, intra=_intra):
    """GOPs of one I-frame, uint8 [G, 1, H, W, 3] -> (the intra payload and
    vectors int32 [G, 0, nbh, nbw, 2], the intra reconstruction as the
    decoded frames). `intra` codes planes [G, C, H, W] as `_intra` does; a
    control puts a broken one in its place."""
    x = _planar(frames)
    g, _, _, h, w = x.shape
    mv = torch.zeros((g, 0, h // cfg.block_size, w // cfg.block_size, 2),
                     dtype=torch.int32, device=x.device)
    if not cfg.chroma_420:
        iq, im, ie, i_rec = intra(x[:, 0], cfg.intra_qstep)
        fields = dict(i_qcoef=iq, i_modes=im, i_escape=ie, mv=mv)
        return fields, i_rec[:, None].movedim(-3, -1).contiguous()
    y, c = ops.ingest_420(x[:, 0])
    iq_y, im_y, ie_y, y_i = intra(y[:, None], cfg.intra_qstep)
    iq_c, im_c, ie_c, c_i = intra(c, cfg.intra_qstep)
    fields = dict(iq_y=iq_y, im_y=im_y, ie_y=ie_y, iq_c=iq_c, im_c=im_c,
                  ie_c=ie_c, mv=mv)
    return fields, ops.emit_bgr(y_i, c_i[:, None]).movedim(-3, -1).contiguous()


def _encode_444(x, cfg, ftype, log):
    anchors, b_pos, prev, nxt = cfg.layout
    qf, bs = cfg.quality_factor, cfg.block_size
    iq, im, ie, i_rec = _intra(x[:, 0], cfg.intra_qstep)
    p_f = torch.stack([x[:, t] for t in anchors[1:]], dim=1)
    mv = _search(p_f, i_rec, cfg, cfg.static_threshold, log)
    pred = ops.motion_compensate(mv, i_rec, bs)
    res = ops.code_residual_rgb(p_f.to(torch.int32) - pred.to(torch.int32),
                                qf, ftype)
    dec_p = (pred.to(torch.int32) + ops.decode_residual_rgb(res, qf, ftype)
             ).clamp_(0, 255).to(torch.uint8)
    fields = dict(i_qcoef=iq, i_modes=im, i_escape=ie, mv=mv, residuals=res)
    anch = torch.cat([i_rec[:, None], dec_p], dim=1)
    out = torch.empty_like(x)
    for s, t in enumerate(anchors):
        out[:, t] = anch[:, s]
    if b_pos:
        g, nb = x.shape[0], len(b_pos)
        fsh = x.shape[2:]
        cur = torch.stack([x[:, t] for t in b_pos], dim=1).reshape(-1, *fsh)
        ref_f = torch.stack([anch[:, s] for s in prev], 1).reshape(-1, *fsh)
        ref_b = torch.stack([anch[:, s] for s in nxt], 1).reshape(-1, *fsh)
        mv_f = _search(cur[:, None], ref_f, cfg, cfg.static_threshold,
                       log)[:, 0]
        mv_b = _search(cur[:, None], ref_b, cfg, cfg.static_threshold,
                       log)[:, 0]
        pf = ops.motion_compensate(mv_f[:, None], ref_f, bs)[:, 0]
        pb = ops.motion_compensate(mv_b[:, None], ref_b, bs)[:, 0]
        mode = ops.choose_mode(cur, (pf, pb, ops.bi_average(pf, pb)), bs)
        bpred = ops.block_choice(mode, pf, pb, bs)
        bres = ops.code_residual_rgb(
            cur.to(torch.int32) - bpred.to(torch.int32), qf, ftype)
        dec_b = (bpred.to(torch.int32) + ops.decode_residual_rgb(
            bres, qf, ftype)).clamp_(0, 255).to(torch.uint8)
        fields.update(
            b_mv=torch.stack([mv_f, mv_b], dim=1).reshape(
                g, nb, 2, *mv_f.shape[1:]),
            b_mode=mode.reshape(g, nb, *mode.shape[1:]),
            b_residuals=bres.reshape(g, nb, *bres.shape[1:]))
        dec_b = dec_b.reshape(g, nb, *fsh)
        for k, t in enumerate(b_pos):
            out[:, t] = dec_b[:, k]
    return fields, out.movedim(-3, -1).contiguous()


def _encode_420(x, cfg, ftype, log):
    anchors, b_pos, prev, nxt = cfg.layout
    bs = cfg.block_size
    tables = ops.quant_tables(cfg.quality_factor, ftype, x.device)
    qy, qc = tables[0], tables[1]
    y, c = ops.ingest_420(x)                      # [G, L, H, W], [G, L, 2, ..]
    iq_y, im_y, ie_y, y_i = _intra(y[:, 0:1], cfg.intra_qstep)
    iq_c, im_c, ie_c, c_i = _intra(c[:, 0], cfg.intra_qstep)
    y_i = y_i[:, 0]
    thr = cfg.static_threshold // 3

    def predict(mv, y_ref, c_ref):
        """luma mv [N, F, nbh, nbw, 2] against y_ref [N, H, W] and c_ref
        [N, 2, h, w] -> (pred_y [N, F, H, W], pred_c [N, F, 2, h, w])."""
        return (ops.motion_compensate(mv, y_ref[:, None], bs)[:, :, 0],
                ops.motion_compensate(torch.div(mv, 2, rounding_mode="floor"),
                                      c_ref, bs // 2))

    def add_back(pred, coeffs, table):
        return (pred.to(torch.int32) + ops.decode_planes(coeffs, table)
                ).clamp_(0, 255).to(torch.uint8)

    def resid(cur, pred):
        return cur.to(torch.int32) - pred.to(torch.int32)

    y_p = torch.stack([y[:, t] for t in anchors[1:]], dim=1)
    c_p = torch.stack([c[:, t] for t in anchors[1:]], dim=1)
    mv = _search(y_p[:, :, None], y_i[:, None], cfg, thr, log)
    py, pc = predict(mv, y_i, c_i)
    res_y = ops.code_planes(resid(y_p, py), qy)
    res_c = ops.code_planes(resid(c_p, pc), qc)
    fields = dict(iq_y=iq_y, im_y=im_y, ie_y=ie_y, iq_c=iq_c, im_c=im_c,
                  ie_c=ie_c, mv=mv, res_y=res_y, res_c=res_c)
    anch_y = torch.cat([y_i[:, None], add_back(py, res_y, qy)], dim=1)
    anch_c = torch.cat([c_i[:, None], add_back(pc, res_c, qc)], dim=1)
    out_y, out_c = torch.empty_like(y), torch.empty_like(c)
    for s, t in enumerate(anchors):
        out_y[:, t], out_c[:, t] = anch_y[:, s], anch_c[:, s]
    if b_pos:
        g, nb = y.shape[0], len(b_pos)

        def pick(a, slots):
            return torch.stack([a[:, s] for s in slots], 1).flatten(0, 1)

        yb = torch.stack([y[:, t] for t in b_pos], 1).flatten(0, 1)
        cb = torch.stack([c[:, t] for t in b_pos], 1).flatten(0, 1)
        fy, by = pick(anch_y, prev), pick(anch_y, nxt)
        fc, bc = pick(anch_c, prev), pick(anch_c, nxt)
        mv_f = _search(yb[:, None, None], fy[:, None], cfg, thr, log)
        mv_b = _search(yb[:, None, None], by[:, None], cfg, thr, log)
        pfy, pfc = (p[:, 0] for p in predict(mv_f, fy, fc))
        pby, pbc = (p[:, 0] for p in predict(mv_b, by, bc))
        mode = ops.choose_mode(yb[:, None], (
            pfy[:, None], pby[:, None], ops.bi_average(pfy, pby)[:, None]), bs)
        pred_y = ops.block_choice(mode, pfy, pby, bs)
        pred_c = ops.block_choice(mode, pfc, pbc, bs // 2)
        bres_y = ops.code_planes(resid(yb, pred_y), qy)
        bres_c = ops.code_planes(resid(cb, pred_c), qc)
        fields.update(
            b_mv=torch.stack([mv_f[:, 0], mv_b[:, 0]], dim=1).reshape(
                g, nb, 2, *mv_f.shape[2:]),
            b_mode=mode.reshape(g, nb, *mode.shape[1:]),
            bres_y=bres_y.reshape(g, nb, *bres_y.shape[1:]),
            bres_c=bres_c.reshape(g, nb, *bres_c.shape[1:]))
        dy = add_back(pred_y, bres_y, qy).reshape(g, nb, *y.shape[2:])
        dc = add_back(pred_c, bres_c, qc).reshape(g, nb, *c.shape[2:])
        for k, t in enumerate(b_pos):
            out_y[:, t], out_c[:, t] = dy[:, k], dc[:, k]
    return fields, ops.emit_bgr(out_y, out_c).movedim(-3, -1).contiguous()
