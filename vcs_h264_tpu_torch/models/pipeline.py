"""GOP encode / decode (counterpart of `vcs_h264_tpu/models/pipeline.py`,
full resolution; the 4:2:0 mode is `models/pipeline420.py`).

Every P-frame of a GOP references the GOP's I-frame. Two compositions code
the P-frames, chosen by the config as the JAX package chooses them:
  * production (rounded quant, signed residual, DCT, residual, bs 8): the
    motion search (K2), then the fused residual coding (K3); decode is the
    fused reconstruction (K4);
  * otherwise (reference mode, no DCT, no residual): the search, the block
    compensation (K1), then the residual coding of `_encode_residual`;
    decode compensates (K1) and adds the residual back (`_apply_residual`).
Reference mode reproduces the original reference's residual: the uint8
wrap residual through cv2 BGR->YCrCb and -128, the 8x8 DCT and an
unrounded division by the JPEG table, stored as float32; decode rounds,
wraps, converts back and adds mod 256.

With a B pattern, a full GOP codes its anchors (I and P) as above, then
each B-frame against the DECODED anchors before and after it (closed loop):
a search against each (K2), their compensations (K1), and a per-block
choice of forward, backward or their rounded average. A GOP shorter than
the pattern is coded all-P.

`backend` is passed down to the ops: "auto" runs the CUDA kernels on CUDA
tensors and the plain PyTorch versions on CPU tensors; "plain" runs the
plain versions on either, the reference the kernels are compared with.
Frames are uint8 throughout; the leading axis of the batched entry points
is the GOP batch.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from vcs_h264_tpu_torch.config import CodecConfig
from vcs_h264_tpu_torch.models.gop import EncodedGOP
from vcs_h264_tpu_torch.ops import color, inter_cuda, motion
from vcs_h264_tpu_torch.ops.blocks import blocks_to_plane, plane_to_blocks
from vcs_h264_tpu_torch.ops.dct import dct2_blocks, idct2_blocks
from vcs_h264_tpu_torch.ops.quant import quant_tables


def dct_compress_residual(resid_bgr: torch.Tensor,
                          cfg: CodecConfig) -> torch.Tensor:
    """uint8-valued planar BGR residual [..., 3, H, W] -> coefficient planes
    [..., 3, H, W]: float32 and unrounded in reference mode, int16 rounded
    otherwise."""
    planes = color.bgr_to_ycrcb_planes(resid_bgr) - 128
    d = dct2_blocks(plane_to_blocks(planes.to(torch.float32), cfg.block_size))
    d = d / quant_tables(cfg.quality_factor, resid_bgr.device)[:, None, None]
    if cfg.quant_mode == "rounded":
        return blocks_to_plane(torch.round(d)).to(torch.int16)
    return blocks_to_plane(d)


def dct_decompress_residual(coeffs: torch.Tensor,
                            cfg: CodecConfig) -> torch.Tensor:
    """Coefficient planes [..., 3, H, W] -> uint8-valued planar BGR residual
    [..., 3, H, W] int32.

    Reference mode rounds the IDCT output and wraps it,
    ((round(x) & 255) + 128) & 255: the original truncates values that sit
    within float noise of integers, and rounding recovers the integer it
    meant (PARITY.md). `torch.round` rounds half to even, as `jnp.round`
    does. Otherwise clip(round(x) + 128, 0, 255)."""
    q = quant_tables(cfg.quality_factor, coeffs.device)[:, None, None]
    v = idct2_blocks(plane_to_blocks(coeffs.to(torch.float32),
                                     cfg.block_size) * q)
    plane = torch.round(blocks_to_plane(v))
    if cfg.quant_mode == "reference":
        ycc = ((plane.to(torch.int32) & 255) + 128) & 255
    else:
        ycc = (plane + 128).clamp_(0, 255).to(torch.int32)
    return color.ycrcb_to_bgr_planes(ycc)


@functools.lru_cache(maxsize=None)
def gop_layout(gop_pattern):
    """-> (anchor_pos, b_pos, prev_slot, next_slot, p_sel, b_sel) tuples.

    anchor_pos/b_pos: display positions of anchors (I, P) and of B-frames.
    prev_slot/next_slot: per B-frame, the index into the anchor list (I at
    slot 0, the P anchors after it) of its forward / backward reference.
    p_sel/b_sel: indices of the P / B frames among the non-I frames."""
    anchors = tuple(t for t, x in enumerate(gop_pattern) if x != "B")
    b_pos = tuple(t for t, x in enumerate(gop_pattern) if x == "B")
    slot = {t: s for s, t in enumerate(anchors)}
    prev_slot = tuple(slot[max(a for a in anchors if a < t)] for t in b_pos)
    next_slot = tuple(slot[min(a for a in anchors if a > t)] for t in b_pos)
    p_sel = tuple(t - 1 for t in anchors[1:])
    b_sel = tuple(t - 1 for t in b_pos)
    return anchors, b_pos, prev_slot, next_slot, p_sel, b_sel


def take_frames(x: torch.Tensor, idx) -> torch.Tensor:
    """x[:, idx] for a tuple of frame indices, stacked slice by slice:
    indexing a CUDA tensor with a list uploads the list, a host sync."""
    return torch.stack([x[:, i] for i in idx], dim=1)


def put_frames(out: torch.Tensor, idx, values: torch.Tensor) -> None:
    """out[:, idx] = values, slice by slice (no host sync)."""
    for k, i in enumerate(idx):
        out[:, i] = values[:, k]


def _signed_dct(cfg: CodecConfig) -> bool:
    """The production residual: signed, through the RCT and a rounded DCT."""
    return cfg.with_dct and cfg.quant_mode == "rounded" and cfg.signed_residual


def _use_fused_inter(cfg: CodecConfig, n_p: int) -> bool:
    """The fused P-frame path (K3/K4 on a GPU), under the production
    conditions of the JAX package's `_use_fused_inter`; the plain versions
    the port runs on the CPU are the JAX CPU composition."""
    return (n_p > 0 and cfg.with_residual and _signed_dct(cfg)
            and not cfg.chroma_420 and cfg.block_size == 8)


def _apply_residual(recon: torch.Tensor, resid: Optional[torch.Tensor],
                    cfg: CodecConfig) -> torch.Tensor:
    """Decoder-side residual add-back on predicted uint8 frames -> uint8."""
    if not cfg.with_residual or resid is None:
        return recon
    if _signed_dct(cfg):
        out = recon.to(torch.int32) + inter_cuda.dct_decompress_residual_signed(
            resid, cfg.quality_factor)
        return out.clamp_(0, 255).to(torch.uint8)
    if cfg.with_dct:
        resid = dct_decompress_residual(resid, cfg)
    return motion.reconstruct_wrap(recon, resid).to(torch.uint8)


def _encode_residual(cur: torch.Tensor, recon: torch.Tensor,
                     cfg: CodecConfig) -> Optional[torch.Tensor]:
    """Encoder-side residual coding of cur - prediction, in the mode's
    stored dtype (`models.gop.residual_dtype`)."""
    if not cfg.with_residual:
        return None
    if _signed_dct(cfg):
        return inter_cuda.dct_compress_residual_signed(
            cur.to(torch.int32) - recon.to(torch.int32), cfg.quality_factor)
    resid = motion.residuals_wrap(cur, recon)
    if cfg.with_dct:
        return dct_compress_residual(resid, cfg)
    return resid.to(torch.uint8)


def _search_inputs(curs, refs, cfg: CodecConfig):
    """What the search compares: curs [G, F, C, H, W] and refs [G, C, H, W]
    as they are, or under `search_luma_only` their G channel (index 1 of
    planar BGR) alone, with the static threshold, which is denominated in
    3-channel SAD, divided by 3. Encoder-side only: the vectors drive the
    compensation of all channels. -> (curs, refs, static_threshold)."""
    if not cfg.search_luma_only:
        return curs, refs, cfg.static_threshold
    return (curs[:, :, 1:2].contiguous(), refs[:, 1:2].contiguous(),
            cfg.static_threshold // 3)


def _search(curs, refs, cfg: CodecConfig, backend: str) -> torch.Tensor:
    curs, refs, threshold = _search_inputs(curs, refs, cfg)
    return motion.motion_search_gops(
        curs, refs, bs=cfg.block_size, reach=cfg.search_reach,
        step=cfg.search_step, static_threshold=threshold, backend=backend)


def _compensate_frames(mv, refs, cfg: CodecConfig, backend: str):
    """Per-frame refs: mv [N, nbh, nbw, 2] x refs [N, C, H, W] ->
    [N, C, H, W]."""
    return motion.motion_compensate_gops(mv[:, None], refs, bs=cfg.block_size,
                                         backend=backend)[:, 0]


def _bi_average(pred_f, pred_b) -> torch.Tensor:
    """The bi-predictive average (f + b + 1) >> 1, taken in int32 (it
    overflows uint8) -> uint8."""
    return ((pred_f.to(torch.int32) + pred_b.to(torch.int32) + 1) >> 1
            ).to(torch.uint8)


def _b_prediction(mode, pred_f, pred_b, pred_bi, bs: int) -> torch.Tensor:
    """Per-block choice among the forward, backward and average predictions
    [N, C, H, W] by mode [N, nbh, nbw] (0, 1, 2)."""
    mpix = mode.repeat_interleave(bs, -2).repeat_interleave(bs, -1)[:, None]
    return torch.where(mpix == 0, pred_f, torch.where(mpix == 1, pred_b,
                                                      pred_bi))


def _b_mode_select(b_frames, pred_f, pred_b, bs: int):
    """Per-block bidirectional mode decision: 0 forward, 1 backward, 2 the
    average, by the smallest SAD over the channels; `torch.argmin` takes
    the first minimum, as `jnp.argmin` does, so ties prefer the cheaper
    single-reference modes. -> (mode int8 [N, nbh, nbw], uint8 prediction
    [N, C, H, W])."""
    cur = b_frames.to(torch.int32)
    pred_bi = _bi_average(pred_f, pred_b)
    sads = torch.stack([motion.tile_sums((p.to(torch.int32) - cur).abs(), bs)
                        for p in (pred_f, pred_b, pred_bi)])
    mode = torch.argmin(sads, dim=0).to(torch.int8)
    return mode, _b_prediction(mode, pred_f, pred_b, pred_bi, bs)


def _b_refs(anchors, cfg: CodecConfig):
    """Anchors [B, NA, C, H, W] -> the forward and backward reference of
    every B-frame, [B*NB, C, H, W] each (flattened (gop, B-frame) axis)."""
    _, _, prev_slot, next_slot, _, _ = gop_layout(cfg.gop_pattern)
    fsh = anchors.shape[2:]
    return (take_frames(anchors, prev_slot).reshape(-1, *fsh),
            take_frames(anchors, next_slot).reshape(-1, *fsh))


def _b_predict_batch(anchors, b_mv, b_mode, cfg: CodecConfig,
                     backend: str) -> torch.Tensor:
    """Decoder-side B prediction: anchors [B, NA, C, H, W], b_mv
    [B, NB, 2, nbh, nbw, 2], b_mode [B, NB, nbh, nbw] -> uint8
    [B*NB, C, H, W]."""
    prev_r, next_r = _b_refs(anchors, cfg)
    mv = b_mv.reshape(-1, *b_mv.shape[2:])
    pred_f = _compensate_frames(mv[:, 0], prev_r, cfg, backend)
    pred_b = _compensate_frames(mv[:, 1], next_r, cfg, backend)
    mode = b_mode.reshape(-1, *b_mode.shape[2:])
    return _b_prediction(mode, pred_f, pred_b, _bi_average(pred_f, pred_b),
                         cfg.block_size)


def encode_gop_batch(i_frames: torch.Tensor, p_frames: torch.Tensor,
                     cfg: CodecConfig, backend: str = "auto") -> EncodedGOP:
    """i_frames uint8 [B, 3, H, W]; p_frames uint8 [B, F, 3, H, W], all
    non-I frames in display order (F >= 1), on one device -> EncodedGOP
    with a leading batch axis. A B pattern is used only when the GOP is
    complete (F == gop_len - 1); a shorter GOP is coded all-P."""
    use_b = cfg.has_b and p_frames.shape[1] == cfg.gop_len - 1
    if use_b:
        _, _, _, _, p_sel, b_sel = gop_layout(cfg.gop_pattern)
        p_f = take_frames(p_frames, p_sel)
    else:
        p_f = p_frames
    mv = _search(p_f, i_frames, cfg, backend)          # [B, NP, nbh, nbw, 2]
    if not cfg.with_residual and not use_b:
        return EncodedGOP(i_frame=i_frames, mv=mv, residuals=None)

    if _use_fused_inter(cfg, p_f.shape[1]):
        resid = inter_cuda.encode_p_coeffs(mv, i_frames, p_f,
                                           cfg.quality_factor, backend)
        if not use_b:
            return EncodedGOP(i_frame=i_frames, mv=mv, residuals=resid)
        # closed loop: B-frames reference the decoded anchors, so encoder
        # and decoder predictions agree under lossy quantization
        dec_p = inter_cuda.decode_p_frames(mv, i_frames, resid,
                                           cfg.quality_factor, backend)
    else:
        recon = motion.motion_compensate_gops(mv, i_frames, bs=cfg.block_size,
                                              backend=backend)
        resid = _encode_residual(p_f, recon, cfg)
        if not use_b:
            return EncodedGOP(i_frame=i_frames, mv=mv, residuals=resid)
        dec_p = _apply_residual(recon, resid, cfg)

    b_f = take_frames(p_frames, b_sel)                 # [B, NB, C, H, W]
    bb, nb = b_f.shape[:2]
    prev_r, next_r = _b_refs(torch.cat([i_frames[:, None], dec_p], dim=1),
                             cfg)
    # the (gop, B-frame) axis is the search's GOP axis, one frame each
    b_flat = b_f.reshape(bb * nb, 1, *b_f.shape[2:])
    mv_f = _search(b_flat, prev_r, cfg, backend)[:, 0]
    mv_b = _search(b_flat, next_r, cfg, backend)[:, 0]
    pred_f = _compensate_frames(mv_f, prev_r, cfg, backend)
    pred_b = _compensate_frames(mv_b, next_r, cfg, backend)
    mode, pred = _b_mode_select(b_flat[:, 0], pred_f, pred_b, cfg.block_size)
    b_resid = _encode_residual(b_flat[:, 0], pred, cfg)

    def unflat(x):
        return None if x is None else x.reshape(bb, nb, *x.shape[1:])

    return EncodedGOP(i_frame=i_frames, mv=mv, residuals=resid,
                      b_mv=unflat(torch.stack([mv_f, mv_b], dim=1)),
                      b_mode=unflat(mode), b_residuals=unflat(b_resid))


def decode_gop_batch(gop: EncodedGOP, cfg: CodecConfig,
                     backend: str = "auto") -> torch.Tensor:
    """Batched EncodedGOP with F >= 1 P-frames -> uint8 frames
    [B, num_coded, 3, H, W] in display order."""
    i_frames = gop.i_frame
    if gop.residuals is not None and _use_fused_inter(cfg, gop.mv.shape[1]):
        out_p = inter_cuda.decode_p_frames(gop.mv, i_frames, gop.residuals,
                                           cfg.quality_factor, backend)
    else:
        recon = motion.motion_compensate_gops(gop.mv, i_frames,
                                              bs=cfg.block_size,
                                              backend=backend)
        out_p = _apply_residual(recon, gop.residuals, cfg)
    anchors = torch.cat([i_frames[:, None], out_p], dim=1)
    if gop.b_mv is None:
        return anchors
    anchor_pos, b_pos, _, _, _, _ = gop_layout(cfg.gop_pattern)
    bb, nb = gop.b_mv.shape[:2]
    fsh = anchors.shape[2:]
    pred = _b_predict_batch(anchors, gop.b_mv, gop.b_mode, cfg, backend)
    b_res = gop.b_residuals
    if b_res is not None:
        b_res = b_res.reshape(bb * nb, *b_res.shape[2:])
    out_b = _apply_residual(pred, b_res, cfg).reshape(bb, nb, *fsh)
    out = torch.empty((bb, cfg.gop_len, *fsh), dtype=torch.uint8,
                      device=anchors.device)
    put_frames(out, anchor_pos, anchors)
    put_frames(out, b_pos, out_b)
    return out


def encode_gop(i_frame: torch.Tensor, p_frames: torch.Tensor,
               cfg: CodecConfig, backend: str = "auto") -> EncodedGOP:
    """One GOP: i_frame [3, H, W], p_frames [F, 3, H, W] (F >= 1, fewer than
    the pattern's for a tail GOP)."""
    return encode_gop_batch(i_frame[None], p_frames[None], cfg,
                            backend).select(0)


def decode_gop(gop: EncodedGOP, cfg: CodecConfig,
               backend: str = "auto") -> torch.Tensor:
    """One GOP -> uint8 frames [num_coded, 3, H, W]."""
    batch = EncodedGOP.stack([gop], gop.i_frame.device)
    return decode_gop_batch(batch, cfg, backend)[0]
