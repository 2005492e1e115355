"""Row tiles with a halo exchange on the (gop x tile) mesh (counterpart of
`vcs_h264_tpu/parallel/spatial.py`).

The GOP batch is split over the mesh's gop rows and each frame's rows over
its tiles (`parallel/mesh.py`). A block's search and compensation read
reference rows up to `reach + bs` beyond its tile, so before each search
or compensation every tile receives that many rows from each neighbour
(`_halo_exchange`): a copy to the tile's device, where the JAX package
sends them with `lax.ppermute`.

A tile's *strip* is its rows with its neighbours' halo rows above and
below. At a frame edge, where there is no neighbour, it has none (the JAX
package fills zeros there), and on such an edge-exact strip the port's own
kernels run unchanged:
  * the search (K2) runs on the strip, the tile's frames padded by zero
    rows, and the tile's block rows of its vectors are the unsharded
    vectors. A block's window is clamped to [max(c - reach, 0),
    min(c + reach, H)) (`ops/motion.py` `make_plan`): on the first and the
    last tile the strip's edge is the frame's, and on an interior edge
    neither clamp bites, since the halo exceeds the reach;
  * compensation (K1) and the fused residual coding (K3/K4, and in 4:2:0
    the bare-plane K3/K4 and K7) read only the rows the tile's vectors
    point at, inside the strip, and code 8x8 blocks whose grid the strip
    shares with the frame, since the rows exchanged are a multiple of the
    block (and of 8 on the half-resolution chroma planes);
  * the halo rows of every strip output are cut off.

Constraints, the JAX package's: the tile height th is a multiple of bs (of
2 * bs in 4:2:0) and, with more than one tile, th >= halo = reach + bs, so
each halo comes from one neighbour. The rows exchanged are the halo
rounded up to a multiple of bs, and on the 4:2:0 chroma planes the JAX
package's halo max(1, reach // 2) + bs // 2 rounded up to 8 (16 rows for
bs 8, reach 16), which the constraint still provides. One more, which the
JAX package leaves unchecked: a block with no candidate in its window
falls back to the vector to the frame's top-left corner, outside an
interior strip, so row tiles refuse a search geometry (block size against
reach) that leaves a block of an interior tile without one.

The lossy-intra stage runs once per gop row on the row's first device (the
wavefront is sequential over a frame's rows), and its reconstruction is
then split into tiles; the JAX package replicates it over the tile axis,
with the same result. Under 4:2:0 the planes are ingested before the split
and emitted as BGR after the gather, each on its gop row's first device.

The sharded path gives the unsharded port's output (`models/pipeline.py`,
`models/pipeline420.py`) bit for bit. Inputs are uint8, as theirs; the
encoded batch and the decoded frames are gathered onto the mesh's first
device. Each kernel runs on the strips of its device; a CUDA device
launches the kernels (or raises) and the CPU runs their plain versions.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import torch
import torch.nn.functional as F

from vcs_h264_tpu_torch.config import CodecConfig
from vcs_h264_tpu_torch.models import intra_codec, pipeline420
from vcs_h264_tpu_torch.models.gop import EncodedGOP, EncodedGOP420
from vcs_h264_tpu_torch.models.pipeline import (_apply_residual,
                                                _b_mode_select, _b_prediction,
                                                _b_refs, _bi_average,
                                                _encode_residual, _search,
                                                _use_fused_inter, gop_layout,
                                                put_frames, take_frames)
from vcs_h264_tpu_torch.ops import inter_cuda, motion
from vcs_h264_tpu_torch.parallel.mesh import (Layout, Mesh, gather, shard,
                                              split_rows)

_DCT = 8                       # the transform block of the residual coding
_FRAMES = Layout(rows=-2)      # [B, ..., H, W]
_VECTORS = Layout(rows=-3)     # [B, ..., nbh, nbw, 2]


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _edges(t: int, n: int, halo: int):
    """(top, bottom): the halo rows tile t of n receives from each side."""
    return (halo if t > 0 else 0), (halo if t < n - 1 else 0)


def _halo_exchange(tiles: Sequence[torch.Tensor], halo: int,
                   mesh_row: Sequence[torch.device]) -> List[torch.Tensor]:
    """The tiles [..., C, th, W] of one gop row, tile t on mesh_row[t] ->
    one strip per tile on its device, [..., C, top + th + bottom, W]: the
    last `halo` rows of tile t - 1, the tile, the first `halo` rows of tile
    t + 1; none at a frame edge (`_edges`). Each halo is copied to the
    tile's device; between two GPUs the copy is ordered after the work that
    wrote the rows."""
    strips = []
    for t, dev in enumerate(mesh_row):
        parts = [tiles[t]]
        if t > 0:
            parts.insert(0, tiles[t - 1][..., -halo:, :].to(
                dev, non_blocking=True))
        if t < len(tiles) - 1:
            parts.append(tiles[t + 1][..., :halo, :].to(dev,
                                                        non_blocking=True))
        strips.append(torch.cat(parts, dim=-2) if len(parts) > 1
                      else tiles[t])
    return strips


def _pad_rows(x: torch.Tensor, top: int, bottom: int,
              axis: int = -2) -> torch.Tensor:
    """x with `top` and `bottom` zero rows added along `axis` (< 0)."""
    if not (top or bottom):
        return x
    return F.pad(x, [0, 0] * (-axis - 1) + [top, bottom])


def _strip_mv(mv: torch.Tensor, top: int, bottom: int,
              cell: int) -> torch.Tensor:
    """A tile's vectors [..., th/cell, nbw, 2] padded with zero vectors to
    the block rows of its strip, whose halos are top and bottom rows."""
    return _pad_rows(mv, top // cell, bottom // cell, axis=-3)


def tile_motion_search(curs: torch.Tensor, strip: torch.Tensor, top: int,
                       bs: int, search) -> torch.Tensor:
    """The vectors of a tile's frames: curs [G, F, ..., th, W] against the
    strip of their reference [G, ..., top + th + bottom, W], searched by
    `search(curs, refs)` (the pipeline's) with curs padded by zero rows to
    the strip -> the tile's block rows, [G, F, th/bs, nbw, 2], equal to
    those rows of the unsharded search (see the module's docstring)."""
    th = curs.shape[-2]
    mv = search(_pad_rows(curs, top, strip.shape[-2] - top - th), strip)
    return mv[:, :, top // bs:(top + th) // bs]


def tile_motion_compensate(mv: torch.Tensor, strip: torch.Tensor, top: int,
                           bs: int) -> torch.Tensor:
    """mv [G, F, th/bs, nbw, 2] of a tile against the strip of its
    reference [G, C, top + th + bottom, W] -> the tile's prediction
    [G, F, C, th, W] (K1 on a CUDA tensor, the plain gather on the CPU).
    A vector whose source block lies inside the frame, as every vector of
    the search does, reads inside the strip, so neither the gather's wrap
    of a negative origin nor its clamp acts on a tile block; a vector out
    of the frame (a foreign stream's) may read rows no strip holds."""
    th = mv.shape[2] * bs
    bottom = strip.shape[-2] - top - th
    out = motion.motion_compensate_gops(_strip_mv(mv, top, bottom, bs),
                                        strip, bs=bs)
    return out[..., top:top + th, :]


def _tile_encode_p(p_f, strip, top: int, cfg: CodecConfig, decoded: bool):
    """The P-frames p_f [G, NP, 3, th, W] of a tile against the strip of
    their I-frame -> (mv, residuals or None, the decoded P-frames when
    `decoded` else None), as `pipeline.encode_gop_batch` codes them: the
    fused K3 (and K4 for the decoded frames) on the strip, or the
    compensation and `_encode_residual` / `_apply_residual` on the tile."""
    bs, th = cfg.block_size, p_f.shape[-2]
    mv = tile_motion_search(p_f, strip, top, bs,
                            lambda c, r: _search(c, r, cfg, "auto"))
    if not cfg.with_residual and not decoded:
        return mv, None, None
    if _use_fused_inter(cfg, p_f.shape[1]):
        bottom = strip.shape[-2] - top - th
        mv_s = _strip_mv(mv, top, bottom, bs)
        res_s = inter_cuda.encode_p_coeffs(
            mv_s, strip, _pad_rows(p_f, top, bottom), cfg.quality_factor)
        dec = None
        if decoded:
            dec = inter_cuda.decode_p_frames(mv_s, strip, res_s,
                                             cfg.quality_factor)
            dec = dec[..., top:top + th, :]
        return mv, res_s[..., top:top + th, :], dec
    recon = tile_motion_compensate(mv, strip, top, bs)
    resid = _encode_residual(p_f, recon, cfg)
    return mv, resid, (_apply_residual(recon, resid, cfg) if decoded
                       else None)


def _tile_decode_p(mv, strip, resid, top: int, cfg: CodecConfig):
    """A tile's P-frames back from their vectors and residuals against the
    strip of their I-frame, as `pipeline.decode_gop_batch` decodes them."""
    bs, th = cfg.block_size, mv.shape[2] * cfg.block_size
    if resid is not None and _use_fused_inter(cfg, mv.shape[1]):
        bottom = strip.shape[-2] - top - th
        out = inter_cuda.decode_p_frames(
            _strip_mv(mv, top, bottom, bs), strip,
            _pad_rows(resid, top, bottom), cfg.quality_factor)
        return out[..., top:top + th, :]
    return _apply_residual(tile_motion_compensate(mv, strip, top, bs),
                           resid, cfg)


def _check_tiles(mesh: Mesh, cfg: CodecConfig, h: int, w: int,
                 mult: int, suffix: str = "") -> int:
    """The tile height, after the JAX package's checks (and the window
    check of the module's docstring)."""
    n_tile = mesh.shape["tile"]
    bs = cfg.block_size
    halo = cfg.search_reach + bs
    if h % n_tile:
        raise ValueError(f"{h} rows do not split into {n_tile} tiles")
    th = h // n_tile
    if th % mult or (n_tile > 1 and th < halo):
        raise ValueError(f"tile height {th} must be a multiple of {mult} "
                         f"and >= halo {halo}{suffix}")
    if n_tile > 1:
        plan = motion.make_plan(h, w, bs, cfg.search_reach, cfg.search_step)
        if not (plan.valid_i[th // bs:].any(1).all()
                and plan.valid_j.any(1).all()):
            raise ValueError(
                f"row tiles need a search candidate in every block's "
                f"window: block {bs} is too large for reach "
                f"{cfg.search_reach}")
    return th


def _gop_rows(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """x's batch split over the gop rows, each part on its row's first
    device."""
    column = Mesh(tuple(row[:1] for row in mesh.devices))
    return [s[0] for s in shard(x, column, Layout())]


def _gather_rows(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """One tensor per gop row -> their concatenation on the first device."""
    return gather([[p] for p in parts], mesh, Layout())


@functools.lru_cache(maxsize=None)
def make_sharded_encoder(mesh: Mesh, cfg: CodecConfig, h: int, w: int):
    """-> fn(i_frames uint8 [B, 3, H, W], p_frames uint8 [B, F, 3, H, W])
    -> EncodedGOP batch on the mesh's first device, equal to the
    Encoder's: lossy intra (when intra_qstep > 0) and then
    `pipeline.encode_gop_batch` on its reconstruction.

    With a B pattern and complete GOPs (F == gop_len - 1) the anchors are
    decoded tile by tile and exchanged again (their halo rows), and each
    B-frame is searched and compensated on the strips of its two anchors;
    a shorter GOP is coded all-P, as unsharded."""
    bs = cfg.block_size
    _check_tiles(mesh, cfg, h, w, bs, " (reach + block)")
    hx = _round_up(cfg.search_reach + bs, bs)
    n_tile = mesh.shape["tile"]
    _, _, _, _, p_sel, b_sel = gop_layout(cfg.gop_pattern)

    def run(i_frames: torch.Tensor, p_frames: torch.Tensor) -> EncodedGOP:
        use_b = cfg.has_b and p_frames.shape[1] == cfg.gop_len - 1
        p_tiles = shard(p_frames, mesh, _FRAMES)
        fields = {k: [] for k in ("i_frame", "mv", "residuals", "b_mv",
                                  "b_mode", "b_residuals")}
        payload = []
        for g, (row, i_g) in enumerate(zip(mesh.devices,
                                           _gop_rows(i_frames, mesh))):
            if cfg.intra_qstep:
                pay, i_g = intra_codec.encode_intra_frames_lossy_batch(
                    i_g, cfg.intra_qstep)
                payload.append(pay)
            fields["i_frame"].append(i_g)
            i_t = split_rows(i_g, row)
            strips = _halo_exchange(i_t, hx, row)
            mv, res, dec = [], [], []
            for t in range(n_tile):
                p_f = (take_frames(p_tiles[g][t], p_sel) if use_b
                       else p_tiles[g][t])
                out = _tile_encode_p(p_f, strips[t], _edges(t, n_tile, hx)[0],
                                     cfg, use_b)
                for acc, x in zip((mv, res, dec), out):
                    acc.append(x)
            fields["mv"].append(mv)
            fields["residuals"].append(res)
            if not use_b:
                continue
            anchors = [torch.cat([i_t[t][:, None], dec[t]], dim=1)
                       for t in range(n_tile)]
            a_strips = _halo_exchange(anchors, hx, row)
            b_mv, b_mode, b_res = [], [], []
            for t in range(n_tile):
                b_f = take_frames(p_tiles[g][t], b_sel)
                out = _tile_encode_b(b_f, a_strips[t],
                                     _edges(t, n_tile, hx)[0], cfg)
                for acc, x in zip((b_mv, b_mode, b_res), out):
                    acc.append(x)
            fields["b_mv"].append(b_mv)
            fields["b_mode"].append(b_mode)
            fields["b_residuals"].append(b_res)

        def tiled(name, layout):
            parts = fields[name]
            if not parts or parts[0][0] is None:
                return None
            return gather(parts, mesh, layout)

        def paid(name):
            return (_gather_rows([getattr(p, name) for p in payload], mesh)
                    if payload else None)

        return EncodedGOP(
            i_frame=_gather_rows(fields["i_frame"], mesh),
            mv=tiled("mv", _VECTORS), residuals=tiled("residuals", _FRAMES),
            b_mv=tiled("b_mv", _VECTORS), b_mode=tiled("b_mode", _FRAMES),
            b_residuals=tiled("b_residuals", _FRAMES),
            i_qcoef=paid("qcoef"), i_modes=paid("modes"),
            i_escape=paid("escape"))

    return run


def _tile_encode_b(b_f, a_strip, top: int, cfg: CodecConfig):
    """A tile's B-frames b_f [G, NB, 3, th, W] against the strips of the
    decoded anchors [G, NA, 3, top + th + bottom, W] -> (b_mv, b_mode,
    b_residuals or None) of the tile, as `pipeline.encode_gop_batch` codes
    them."""
    bs = cfg.block_size
    gb, nb = b_f.shape[:2]
    prev_r, next_r = _b_refs(a_strip, cfg)          # [G*NB, 3, SH, W]
    b_flat = b_f.reshape(gb * nb, 1, *b_f.shape[2:])

    def search(c, r):
        return _search(c, r, cfg, "auto")

    mv_f = tile_motion_search(b_flat, prev_r, top, bs, search)
    mv_b = tile_motion_search(b_flat, next_r, top, bs, search)
    pred_f = tile_motion_compensate(mv_f, prev_r, top, bs)[:, 0]
    pred_b = tile_motion_compensate(mv_b, next_r, top, bs)[:, 0]
    mode, pred = _b_mode_select(b_flat[:, 0], pred_f, pred_b, bs)
    b_res = _encode_residual(b_flat[:, 0], pred, cfg)

    def unflat(x):
        return None if x is None else x.reshape(gb, nb, *x.shape[1:])

    return (unflat(torch.stack([mv_f[:, 0], mv_b[:, 0]], dim=1)),
            unflat(mode), unflat(b_res))


def _tile_decode_b(a_strip, b_mv, b_mode, b_res, top: int,
                   cfg: CodecConfig):
    """A tile's B-frames back from their fields (b_mv [G, NB, 2, th/bs,
    nbw, 2], b_mode, b_residuals or None) against the strips of the
    decoded anchors [G, NA, 3, top + th + bottom, W] -> uint8
    [G, NB, 3, th, W], as `pipeline.decode_gop_batch` decodes them."""
    bs = cfg.block_size
    gb, nb = b_mv.shape[:2]
    prev_r, next_r = _b_refs(a_strip, cfg)
    mv = b_mv.flatten(0, 1)
    pred_f = tile_motion_compensate(mv[:, 0:1], prev_r, top, bs)[:, 0]
    pred_b = tile_motion_compensate(mv[:, 1:2], next_r, top, bs)[:, 0]
    pred = _b_prediction(b_mode.flatten(0, 1), pred_f, pred_b,
                         _bi_average(pred_f, pred_b), bs)
    out = _apply_residual(pred, None if b_res is None
                          else b_res.flatten(0, 1), cfg)
    return out.reshape(gb, nb, *out.shape[1:])


def _with_b(anchors, b, anchor_pos, b_pos, gop_len):
    """Anchor planes [G, NA, ...] and B planes [G, NB, ...] -> [G, gop_len,
    ...] in display order."""
    out = anchors.new_empty((anchors.shape[0], gop_len, *anchors.shape[2:]))
    put_frames(out, anchor_pos, anchors)
    put_frames(out, b_pos, b)
    return out


@functools.lru_cache(maxsize=None)
def make_sharded_decoder(mesh: Mesh, cfg: CodecConfig, h: int, w: int):
    """-> fn(EncodedGOP batch) -> uint8 frames [B, num_coded, 3, H, W] in
    display order on the mesh's first device, equal to
    `pipeline.decode_gop_batch`'s. With B-frames the decoded anchors are
    exchanged again and each B-frame is compensated on their strips."""
    _check_tiles(mesh, cfg, h, w, cfg.block_size, " (reach + block)")
    hx = _round_up(cfg.search_reach + cfg.block_size, cfg.block_size)
    n_tile = mesh.shape["tile"]
    anchor_pos, b_pos, _, _, _, _ = gop_layout(cfg.gop_pattern)

    def run(gop: EncodedGOP) -> torch.Tensor:
        i_tiles = shard(gop.i_frame, mesh, _FRAMES)
        mv_tiles = shard(gop.mv, mesh, _VECTORS)
        res_tiles = (None if gop.residuals is None
                     else shard(gop.residuals, mesh, _FRAMES))
        use_b = gop.b_mv is not None
        if use_b:
            bmv_tiles = shard(gop.b_mv, mesh, _VECTORS)
            bmode_tiles = shard(gop.b_mode, mesh, _FRAMES)
            bres_tiles = (None if gop.b_residuals is None
                          else shard(gop.b_residuals, mesh, _FRAMES))
        frames = []
        for g, row in enumerate(mesh.devices):
            strips = _halo_exchange(i_tiles[g], hx, row)
            anchors = []
            for t in range(n_tile):
                out_p = _tile_decode_p(
                    mv_tiles[g][t], strips[t],
                    None if res_tiles is None else res_tiles[g][t],
                    _edges(t, n_tile, hx)[0], cfg)
                anchors.append(torch.cat([i_tiles[g][t][:, None], out_p],
                                         dim=1))
            if not use_b:
                frames.append(anchors)
                continue
            a_strips = _halo_exchange(anchors, hx, row)
            out = []
            for t in range(n_tile):
                out_b = _tile_decode_b(
                    a_strips[t], bmv_tiles[g][t], bmode_tiles[g][t],
                    None if bres_tiles is None else bres_tiles[g][t],
                    _edges(t, n_tile, hx)[0], cfg)
                out.append(_with_b(anchors[t], out_b, anchor_pos, b_pos,
                                   cfg.gop_len))
            frames.append(out)
        return gather(frames, mesh, _FRAMES)

    return run


def sharded_encode_gop_batch(i_frames, p_frames, cfg: CodecConfig,
                             mesh: Mesh) -> EncodedGOP:
    h, w = i_frames.shape[-2:]
    return make_sharded_encoder(mesh, cfg, h, w)(i_frames, p_frames)


def sharded_decode_gop_batch(gop: EncodedGOP, cfg: CodecConfig,
                             mesh: Mesh) -> torch.Tensor:
    h, w = gop.i_frame.shape[-2:]
    return make_sharded_decoder(mesh, cfg, h, w)(gop)


# ---------------------------------------------------------------------------
# 4:2:0 (models/pipeline420.py on the mesh). Luma rows split over the tiles
# as at full resolution; the chroma planes split at half the tile height,
# with their own halo, and ride the floor-halved luma vectors on cells of
# bs / 2.


def _halos_420(cfg: CodecConfig):
    """(luma rows, chroma rows) exchanged: the halo rounded up to the block,
    and the JAX package's chroma halo rounded up to the 8x8 transform
    block, so the transform cells of K7 on a strip are the frame's."""
    bs = cfg.block_size
    return (_round_up(cfg.search_reach + bs, bs),
            _round_up(max(1, cfg.search_reach // 2) + bs // 2, _DCT))


def _check_420(mesh: Mesh, cfg: CodecConfig, h: int, w: int) -> int:
    bs = cfg.block_size
    if w % (2 * bs):
        raise ValueError(f"4:2:0 needs H and W multiples of {2 * bs}, got "
                         f"{(h, w)}")
    return _check_tiles(mesh, cfg, h, w, 2 * bs)


class _Tile420:
    """Tile t of n in 4:2:0: the rows its luma and chroma strips add on
    each side, and the stages of `pipeline420` on those strips."""

    def __init__(self, t: int, n: int, cfg: CodecConfig):
        hx, hx_c = _halos_420(cfg)
        self.cfg = cfg
        self.bs = cfg.block_size
        self.top, self.bottom = _edges(t, n, hx)
        self.top_c, self.bottom_c = _edges(t, n, hx_c)

    def _mv_y(self, mv):
        """The tile's luma vectors padded to its luma strip's block rows."""
        return _strip_mv(mv, self.top, self.bottom, self.bs)

    def _mv_c(self, mv):
        """... the chroma vectors, on the chroma strip's cells."""
        return pipeline420._chroma_mv(
            _strip_mv(mv, self.top_c, self.bottom_c, self.bs // 2))

    def _crop(self, y, c):
        """Strip planes (y [..., SH, W], c [..., 2, SHc, Wc]) -> the tile's."""
        th = y.shape[-2] - self.top - self.bottom
        return (y[..., self.top:self.top + th, :],
                c[..., self.top_c:self.top_c + th // 2, :])

    def search(self, y_cur, y_strip):
        """The luma search of y_cur [G, F, th, W] on the strip [G, SH, W]."""
        return tile_motion_search(
            y_cur, y_strip, self.top, self.bs,
            lambda c, r: pipeline420._search(c, r, self.cfg, "auto"))

    def predict(self, mv, y_strip, c_strip):
        """mv [G, F, th/bs, nbw, 2] of the tile against the strips of its
        reference planes -> (pred_y [G, F, th, W], pred_c
        [G, F, 2, th/2, W/2]), `pipeline420._predict` on strips."""
        pred_y = tile_motion_compensate(mv, y_strip[:, None], self.top,
                                        self.bs)[:, :, 0]
        pred_c = tile_motion_compensate(pipeline420._chroma_mv(mv), c_strip,
                                        self.top_c, self.bs // 2)
        return pred_y, pred_c

    def encode_p(self, y_p, c_p, y_strip, c_strip, decoded: bool):
        """The tile's P planes (y_p [G, NP, th, W], c_p [G, NP, 2, th/2,
        W/2]) against the strips of the I planes -> (mv, res_y, res_c, and
        with `decoded` the decoded planes dec_y, dec_c, else None, None):
        the luma search, the bare-plane K3 (K4) and K7 on the strips."""
        qf = self.cfg.quality_factor
        mv = self.search(y_p, y_strip)
        mv_y, mv_c = self._mv_y(mv), self._mv_c(mv)
        ry = inter_cuda.encode_p_coeffs(
            mv_y, y_strip[:, None],
            _pad_rows(y_p, self.top, self.bottom)[:, :, None], qf)
        rc = inter_cuda.encode_c420_coeffs(
            mv_c, c_strip, _pad_rows(c_p, self.top_c, self.bottom_c), qf)
        dec = (None, None)
        if decoded:
            dec = self._crop(inter_cuda.decode_p_frames(
                mv_y, y_strip[:, None], ry, qf)[:, :, 0],
                inter_cuda.decode_c420_frames(mv_c, c_strip, rc, qf))
        return (mv, *self._crop(ry[:, :, 0], rc), *dec)

    def decode_p(self, mv, res_y, res_c, y_strip, c_strip):
        """The tile's P planes back from mv, res_y, res_c against the strips
        of the I planes: the bare-plane K4 and K7 on the strips."""
        qf = self.cfg.quality_factor
        ry = inter_cuda.decode_p_frames(
            self._mv_y(mv), y_strip[:, None],
            _pad_rows(res_y, self.top, self.bottom)[:, :, None], qf)
        rc = inter_cuda.decode_c420_frames(
            self._mv_c(mv), c_strip,
            _pad_rows(res_c, self.top_c, self.bottom_c), qf)
        return self._crop(ry[:, :, 0], rc)

    def encode_b(self, y_b, c_b, ay, ac):
        """The tile's B planes y_b [G, NB, th, W], c_b against the strips of
        the decoded anchors ay [G, NA, SH, W], ac -> (b_mv, b_mode, bres_y,
        bres_c), as `pipeline420.encode_gop_batch_420` codes them."""
        gb, nb = y_b.shape[:2]
        prev_y, next_y, prev_c, next_c = pipeline420._b_refs(ay, ac,
                                                             self.cfg)
        yb, cb = y_b.flatten(0, 1), c_b.flatten(0, 1)
        mv_f = self.search(yb[:, None], prev_y)
        mv_b = self.search(yb[:, None], next_y)
        pf_y, pf_c = (x[:, 0] for x in self.predict(mv_f, prev_y, prev_c))
        pb_y, pb_c = (x[:, 0] for x in self.predict(mv_b, next_y, next_c))
        mode, _, _, bres_y, bres_c = pipeline420._choose_and_code(
            yb, cb, pf_y, pb_y, pf_c, pb_c, self.cfg)
        return tuple(x.reshape(gb, nb, *x.shape[1:]) for x in (
            torch.stack([mv_f[:, 0], mv_b[:, 0]], dim=1), mode, bres_y,
            bres_c))

    def decode_b(self, b_mv, b_mode, bres_y, bres_c, ay, ac):
        """The tile's B planes back from their fields against the strips
        of the decoded anchors -> (y [G, NB, th, W], c)."""
        bs = self.bs
        gb, nb = b_mv.shape[:2]
        qy, qc = pipeline420._tables(self.cfg, b_mv.device)
        prev_y, next_y, prev_c, next_c = pipeline420._b_refs(ay, ac,
                                                             self.cfg)
        mv = b_mv.flatten(0, 1)
        pf_y, pf_c = (x[:, 0] for x in self.predict(mv[:, 0:1], prev_y,
                                                    prev_c))
        pb_y, pb_c = (x[:, 0] for x in self.predict(mv[:, 1:2], next_y,
                                                    next_c))
        mode = b_mode.flatten(0, 1)
        by = pipeline420._add_back(pipeline420._b_choice(mode, pf_y, pb_y, bs),
                                   bres_y.flatten(0, 1), qy)
        bc = pipeline420._add_back(
            pipeline420._b_choice(mode, pf_c, pb_c, bs // 2),
            bres_c.flatten(0, 1), qc)
        return (by.reshape(gb, nb, *by.shape[1:]),
                bc.reshape(gb, nb, *bc.shape[1:]))


@functools.lru_cache(maxsize=None)
def make_sharded_encoder_420(mesh: Mesh, cfg: CodecConfig, h: int, w: int):
    """-> fn(i_frames uint8 [B, 3, H, W] BGR, p_frames uint8
    [B, F, 3, H, W]) -> EncodedGOP420 batch on the mesh's first device,
    equal to `pipeline420.encode_gop_batch_420`'s. The tile height must be
    a multiple of 2 * block_size (half-resolution chroma blocks) and
    >= halo. B patterns (complete GOPs) exchange the decoded anchors at
    both resolutions; chroma rides the halved B vectors."""
    _check_420(mesh, cfg, h, w)
    hx, hx_c = _halos_420(cfg)
    n_tile = mesh.shape["tile"]
    tiles = [_Tile420(t, n_tile, cfg) for t in range(n_tile)]
    _, _, _, _, p_sel, b_sel = gop_layout(cfg.gop_pattern)
    p_names = ("mv", "res_y", "res_c")
    b_names = ("b_mv", "b_mode", "bres_y", "bres_c")

    def run(i_frames: torch.Tensor, p_frames: torch.Tensor) -> EncodedGOP420:
        use_b = cfg.has_b and p_frames.shape[1] == cfg.gop_len - 1
        fields = {k: [] for k in ("i_y", "i_c") + p_names + b_names}
        payload = []
        for row, i_g, p_g in zip(mesh.devices, _gop_rows(i_frames, mesh),
                                 _gop_rows(p_frames, mesh)):
            y_i, c_i = pipeline420.ingest_420(i_g)
            y_p, c_p = pipeline420.ingest_420(p_g)
            if use_b:
                y_b = split_rows(take_frames(y_p, b_sel), row)
                c_b = split_rows(take_frames(c_p, b_sel), row)
                y_p, c_p = take_frames(y_p, p_sel), take_frames(c_p, p_sel)
            if cfg.intra_qstep:
                (y_i, c_i), pay = pipeline420.encode_intra_420(
                    y_i, c_i, cfg.intra_qstep)
                payload.append(pay)
            fields["i_y"].append(y_i)
            fields["i_c"].append(c_i)
            y_t, c_t = split_rows(y_i, row), split_rows(c_i, row)
            ys = _halo_exchange(y_t, hx, row)
            cs = _halo_exchange(c_t, hx_c, row)
            outs = [tile.encode_p(yp, cp, ys[t], cs[t], use_b)
                    for t, (tile, yp, cp) in enumerate(zip(
                        tiles, split_rows(y_p, row), split_rows(c_p, row)))]
            for i, k in enumerate(p_names):
                fields[k].append([o[i] for o in outs])
            if not use_b:
                continue
            # closed loop: B-frames reference the decoded anchors
            ay = _halo_exchange([torch.cat([y_t[t][:, None], o[3]], 1)
                                 for t, o in enumerate(outs)], hx, row)
            ac = _halo_exchange([torch.cat([c_t[t][:, None], o[4]], 1)
                                 for t, o in enumerate(outs)], hx_c, row)
            b_outs = [tile.encode_b(y_b[t], c_b[t], ay[t], ac[t])
                      for t, tile in enumerate(tiles)]
            for i, k in enumerate(b_names):
                fields[k].append([o[i] for o in b_outs])

        def tiled(name, layout):
            return gather(fields[name], mesh, layout) if fields[name] \
                else None

        pay = {k: (_gather_rows([p[k] for p in payload], mesh)
                   if payload else None)
               for k in ("iq_y", "im_y", "ie_y", "iq_c", "im_c", "ie_c")}
        return EncodedGOP420(
            i_y=_gather_rows(fields["i_y"], mesh),
            i_c=_gather_rows(fields["i_c"], mesh),
            mv=tiled("mv", _VECTORS), res_y=tiled("res_y", _FRAMES),
            res_c=tiled("res_c", _FRAMES), b_mv=tiled("b_mv", _VECTORS),
            b_mode=tiled("b_mode", _FRAMES),
            bres_y=tiled("bres_y", _FRAMES),
            bres_c=tiled("bres_c", _FRAMES), **pay)

    return run


@functools.lru_cache(maxsize=None)
def make_sharded_decoder_420(mesh: Mesh, cfg: CodecConfig, h: int, w: int):
    """-> fn(EncodedGOP420 batch) -> BGR uint8 frames [B, num_coded, 3, H,
    W] on the mesh's first device, equal to
    `pipeline420.decode_gop_batch_420`'s."""
    _check_420(mesh, cfg, h, w)
    hx, hx_c = _halos_420(cfg)
    n_tile = mesh.shape["tile"]
    tiles = [_Tile420(t, n_tile, cfg) for t in range(n_tile)]
    anchor_pos, b_pos, _, _, _, _ = gop_layout(cfg.gop_pattern)

    def run(gop: EncodedGOP420) -> torch.Tensor:
        use_b = gop.b_mv is not None
        names = (("i_y", _FRAMES), ("i_c", _FRAMES), ("mv", _VECTORS),
                 ("res_y", _FRAMES), ("res_c", _FRAMES))
        if use_b:
            names += (("b_mv", _VECTORS), ("b_mode", _FRAMES),
                      ("bres_y", _FRAMES), ("bres_c", _FRAMES))
        sh = {k: shard(getattr(gop, k), mesh, layout) for k, layout in names}
        bgr = []
        for g, row in enumerate(mesh.devices):
            ys = _halo_exchange(sh["i_y"][g], hx, row)
            cs = _halo_exchange(sh["i_c"][g], hx_c, row)
            y, c = [], []
            for t, tile in enumerate(tiles):
                ry, rc = tile.decode_p(sh["mv"][g][t], sh["res_y"][g][t],
                                       sh["res_c"][g][t], ys[t], cs[t])
                y.append(torch.cat([sh["i_y"][g][t][:, None], ry], dim=1))
                c.append(torch.cat([sh["i_c"][g][t][:, None], rc], dim=1))
            if use_b:
                ay = _halo_exchange(y, hx, row)
                ac = _halo_exchange(c, hx_c, row)
                for t, tile in enumerate(tiles):
                    by, bc = tile.decode_b(
                        *(sh[k][g][t] for k in ("b_mv", "b_mode", "bres_y",
                                                "bres_c")), ay[t], ac[t])
                    y[t] = _with_b(y[t], by, anchor_pos, b_pos, cfg.gop_len)
                    c[t] = _with_b(c[t], bc, anchor_pos, b_pos, cfg.gop_len)
            bgr.append(pipeline420.emit_bgr(
                torch.cat([p.to(row[0]) for p in y], dim=-2),
                torch.cat([p.to(row[0]) for p in c], dim=-2)))
        return _gather_rows(bgr, mesh)

    return run


def sharded_encode_gop_batch_420(i_frames, p_frames, cfg: CodecConfig,
                                 mesh: Mesh) -> EncodedGOP420:
    h, w = i_frames.shape[-2:]
    return make_sharded_encoder_420(mesh, cfg, h, w)(i_frames, p_frames)


def sharded_decode_gop_batch_420(gop: EncodedGOP420, cfg: CodecConfig,
                                 mesh: Mesh) -> torch.Tensor:
    h, w = gop.i_y.shape[-2:]
    return make_sharded_decoder_420(mesh, cfg, h, w)(gop)
