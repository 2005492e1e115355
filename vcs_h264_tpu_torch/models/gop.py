"""Encoded-stream data model and the `.npz` container (counterpart of
`vcs_h264_tpu/models/gop.py`).

The `.npz` layout is key for key and dtype for dtype the JAX package's
(`EncodedVideo.save_npz` / `load_npz`), so each package loads the other's
files: a `_meta` JSON string, then per GOP g `gop{g}_i` uint8 [3, H, W],
`gop{g}_mv` int16 [P, nbh, nbw, 2], when the GOP codes residuals `gop{g}_res`
[P, 3, H, W] in the mode's residual dtype (`residual_dtype`), with B-frames
`gop{g}_bmv` int16 [NB, 2, nbh, nbw, 2], `gop{g}_bmode` int8 [NB, nbh, nbw]
and `gop{g}_bres` [NB, 3, H, W], and with lossy intra I-frames the payload
`gop{g}_iq` int16 [3, H, W], `gop{g}_imodes` int8 and `gop{g}_iesc` bool
[3, H/4, W/4].

A 4:2:0 stream (`chroma_420`) stores per GOP the planes `gop{g}_y` uint8
[H, W] and `gop{g}_c` uint8 [2, H/2, W/2], `gop{g}_mv` int16, the int16
coefficients `gop{g}_resy` [P, H, W] and `gop{g}_resc` [P, 2, H/2, W/2],
with B-frames `gop{g}_bmv`, `gop{g}_bmode`, `gop{g}_bresy` and
`gop{g}_bresc`, and with lossy intra the payloads of the luma plane
(`gop{g}_iqy` int16 [1, H, W], `_imy` int8, `_iey` bool [1, H/4, W/4]) and
of the chroma planes (`gop{g}_iqc` [2, H/2, W/2], `_imc`, `_iec`
[2, H/8, W/8]).

`npz_fields(cfg)` holds either layout as a table (field -> key, stored
dtype, dtype in memory); `gop_to_npz` / `gop_from_npz` turn one GOP into
those arrays and back, under the prefix `gop{g}_` in a stream's file and
under none in a checkpoint file (`save_gop_npz` / `load_gop_npz`), which
adds the configuration's fingerprint as `cfg`.
"""

from __future__ import annotations

import ast
import dataclasses
import json
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from vcs_h264_tpu_torch.config import CodecConfig


def residual_dtype(cfg: CodecConfig) -> np.dtype:
    """The stored residuals' dtype: float32 unrounded coefficients in
    reference mode, int16 rounded coefficients, uint8 wrap residuals without
    a DCT."""
    if not cfg.with_dct:
        return np.dtype(np.uint8)
    return np.dtype(np.int16 if cfg.quant_mode == "rounded" else np.float32)


class _GOPFields:
    """What the two GOP records share: the tensor fields handled as one (a
    None field stays None) and the frame counts. Both have `mv` and `b_mv`."""

    def _fields(self) -> tuple:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))

    def _map(self, fn):
        """Apply fn to every tensor field, keeping the None ones."""
        return type(self)(*(None if v is None else fn(v)
                            for v in self._fields()))

    @property
    def num_p(self) -> int:
        return self.mv.shape[-4]

    @property
    def num_b(self) -> int:
        return 0 if self.b_mv is None else self.b_mv.shape[-5]

    @property
    def num_coded(self) -> int:
        """Frames the GOP codes: I + P + B."""
        return 1 + self.num_p + self.num_b

    def select(self, b: int):
        """GOP b of a batch."""
        return self._map(lambda v: v[b])

    def to(self, device):
        return self._map(lambda v: v.to(device))

    def without_intra_payload(self):
        """The GOP without the lossy-intra payload, which the P-frame decode
        never reads: the stored I planes already hold its reconstruction."""
        return dataclasses.replace(self, **{k: None for k in self.PAYLOAD})

    @classmethod
    def stack(cls, gops: Sequence, device, upload=None):
        """Batch GOPs of one shape onto `device`. A field whose tensors are
        all in host memory is stacked there and moved in one copy, or goes
        through `upload` (host tensors -> their stack on the device) when
        one is given; a field already on the device is stacked there; a
        mix moves tensor by tensor."""
        device = torch.device(device)

        def one(vs):
            if vs[0] is None:
                return None
            if all(v.device.type == "cpu" for v in vs):
                return upload(vs) if upload else torch.stack(vs).to(device)
            return torch.stack([v.to(device) for v in vs])

        return cls(*(one(vs) for vs in zip(*(g._fields() for g in gops))))


@dataclasses.dataclass
class EncodedGOP(_GOPFields):
    """One encoded GOP, or a batch of them with a leading GOP axis.

    i_frame:   uint8 [3, H, W]             the I-frame: raw, or with lossy
                                            intra its reconstruction, the
                                            plane the P/B-frames reference
    mv:        int32 [P, nbh, nbw, 2]       (dx, dy) per block per P-frame
    residuals: [P, 3, H, W] or None         in the mode's residual dtype:
                                            float32 coefficients (reference
                                            mode), int16 (rounded), uint8
                                            wrap residuals (no DCT)

    B-frame fields (None unless the GOP is a full GOP of a B pattern):
    b_mv:        int32 [NB, 2, nbh, nbw, 2]  forward and backward vectors
    b_mode:      int8  [NB, nbh, nbw]        0 forward, 1 backward, 2 average
    b_residuals: as `residuals`, [NB, 3, H, W], or None

    Lossy-intra payload (None unless the config's intra_qstep > 0), which
    decodes bit for bit to `i_frame`:
    i_qcoef:   int16 [3, H, W]              quantized 4x4 core-transform
                                            coefficients, block layout
    i_modes:   int8  [3, H/4, W/4]
    i_escape:  bool  [3, H/4, W/4]
    """
    i_frame: torch.Tensor
    mv: torch.Tensor
    residuals: Optional[torch.Tensor]
    b_mv: Optional[torch.Tensor] = None
    b_mode: Optional[torch.Tensor] = None
    b_residuals: Optional[torch.Tensor] = None
    i_qcoef: Optional[torch.Tensor] = None
    i_modes: Optional[torch.Tensor] = None
    i_escape: Optional[torch.Tensor] = None

    PAYLOAD = ("i_qcoef", "i_modes", "i_escape")


@dataclasses.dataclass
class EncodedGOP420(_GOPFields):
    """One encoded 4:2:0 GOP, or a batch of them with a leading GOP axis
    (counterpart of `vcs_h264_tpu/models/pipeline420.py:EncodedGOP420`,
    field for field and in its order).

    i_y:    uint8 [H, W]                 the I-frame's luma plane and
    i_c:    uint8 [2, H/2, W/2]          chroma planes (Cr, Cb): ingested,
                                         or with lossy intra reconstructed
    mv:     int32 [P, nbh, nbw, 2]       luma vectors; chroma rides their
                                         floor-halved values on 4-px cells
    res_y:  int16 [P, H, W] or None      quantized luma coefficients
    res_c:  int16 [P, 2, H/2, W/2]       quantized chroma coefficients

    Lossy-intra payloads (None unless intra_qstep > 0), per resolution:
    iq_y int16 [1, H, W], im_y int8 and ie_y bool [1, H/4, W/4];
    iq_c int16 [2, H/2, W/2], im_c int8 and ie_c bool [2, H/8, W/8].

    B-frame fields (None unless the GOP is a full GOP of a B pattern):
    b_mv int32 [NB, 2, nbh, nbw, 2], b_mode int8 [NB, nbh, nbw] (decided on
    luma SAD), bres_y int16 [NB, H, W], bres_c int16 [NB, 2, H/2, W/2].
    """
    i_y: torch.Tensor
    i_c: torch.Tensor
    mv: torch.Tensor
    res_y: Optional[torch.Tensor]
    res_c: Optional[torch.Tensor]
    iq_y: Optional[torch.Tensor] = None
    im_y: Optional[torch.Tensor] = None
    ie_y: Optional[torch.Tensor] = None
    iq_c: Optional[torch.Tensor] = None
    im_c: Optional[torch.Tensor] = None
    ie_c: Optional[torch.Tensor] = None
    b_mv: Optional[torch.Tensor] = None
    b_mode: Optional[torch.Tensor] = None
    bres_y: Optional[torch.Tensor] = None
    bres_c: Optional[torch.Tensor] = None

    PAYLOAD = ("iq_y", "im_y", "ie_y", "iq_c", "im_c", "ie_c")


# 4:2:0: EncodedGOP420 field -> (.npz key suffix, stored dtype, dtype in
# memory), both as the JAX package has them.
NPZ_420 = dict(
    i_y=("y", np.uint8, np.uint8), i_c=("c", np.uint8, np.uint8),
    mv=("mv", np.int16, np.int32),
    res_y=("resy", np.int16, np.int16), res_c=("resc", np.int16, np.int16),
    iq_y=("iqy", np.int16, np.int16), im_y=("imy", np.int8, np.int8),
    ie_y=("iey", bool, bool),
    iq_c=("iqc", np.int16, np.int16), im_c=("imc", np.int8, np.int8),
    ie_c=("iec", bool, bool),
    b_mv=("bmv", np.int16, np.int32), b_mode=("bmode", np.int8, np.int8),
    bres_y=("bresy", np.int16, np.int16),
    bres_c=("bresc", np.int16, np.int16))


def npz_fields(cfg: CodecConfig) -> dict:
    """The GOP record's fields under `cfg` -> (.npz key suffix, stored
    dtype, dtype in memory), both as the JAX package has them: `NPZ_420`
    under chroma_420, else the 4:4:4 record's, its residuals in
    `residual_dtype(cfg)`."""
    if cfg.chroma_420:
        return NPZ_420
    res = residual_dtype(cfg)
    return dict(
        i_frame=("i", np.uint8, np.uint8), mv=("mv", np.int16, np.int32),
        residuals=("res", res, res), b_mv=("bmv", np.int16, np.int32),
        b_mode=("bmode", np.int8, np.int8), b_residuals=("bres", res, res),
        i_qcoef=("iq", np.int16, np.int16),
        i_modes=("imodes", np.int8, np.int8), i_escape=("iesc", bool, bool))


# the fields every file holds: the I planes and the vectors
_NPZ_REQUIRED = ("i_frame", "i_y", "i_c", "mv")


def gop_to_npz(gop, cfg: CodecConfig, prefix: str = "") -> dict:
    """A GOP's fields that are not None -> {prefix + key: numpy array in
    the stored dtype}."""
    return {prefix + key: v.cpu().numpy().astype(stored, copy=False)
            for name, (key, stored, _) in npz_fields(cfg).items()
            if (v := getattr(gop, name)) is not None}


def gop_from_npz(data, cfg: CodecConfig, prefix: str = ""):
    """The inverse of `gop_to_npz` on an open `.npz`: the record of CPU
    tensors in the dtypes in memory, None where a field is absent. A file
    without the I planes or the vectors raises KeyError."""
    def one(name, key, mem):
        if name not in _NPZ_REQUIRED and prefix + key not in data.files:
            return None
        return torch.from_numpy(data[prefix + key].astype(mem))

    record = EncodedGOP420 if cfg.chroma_420 else EncodedGOP
    return record(**{name: one(name, key, mem)
                     for name, (key, _, mem) in npz_fields(cfg).items()})


def save_gop_npz(path: str, gop, cfg: CodecConfig,
                 fingerprint: str = "") -> None:
    """One GOP as a checkpoint file, as the JAX package writes it: its
    fields under their keys, and `cfg` the configuration's fingerprint."""
    np.savez_compressed(path, cfg=np.array([fingerprint]),
                        **gop_to_npz(gop, cfg))


def load_gop_npz(path: str, cfg: CodecConfig, fingerprint: str = ""):
    """A checkpointed GOP as host tensors in `EncodedVideo.load_npz`'s
    dtypes, or None when it was written under another fingerprint."""
    with np.load(path) as data:
        stored = str(data["cfg"][0]) if "cfg" in data.files else None
        if fingerprint and stored != fingerprint:
            return None
        return gop_from_npz(data, cfg)


@dataclasses.dataclass
class EncodedVideo:
    """A sequence of encoded GOPs plus stream metadata."""
    config: CodecConfig
    height: int
    width: int
    fps: float
    num_frames: int
    gops: List[Union[EncodedGOP, EncodedGOP420]]     # 420 under chroma_420

    def save_npz(self, path: str) -> None:
        arrays = {}
        for g, gop in enumerate(self.gops):
            arrays.update(gop_to_npz(gop, self.config, f"gop{g}_"))
        np.savez_compressed(path, _meta=np.array([json.dumps(
            self._meta_dict())]), **arrays)

    def _meta_dict(self) -> dict:
        c = self.config
        return dict(height=self.height, width=self.width, fps=self.fps,
                    num_frames=self.num_frames, num_gops=len(self.gops),
                    block_size=c.block_size,
                    gop_pattern=",".join(c.gop_pattern),
                    quality_factor=c.quality_factor,
                    with_dct=int(c.with_dct),
                    with_residual=int(c.with_residual),
                    quant_mode=c.quant_mode, search_reach=c.search_reach,
                    intra_i=int(c.intra_i), intra_qstep=c.intra_qstep,
                    chroma_420=int(c.chroma_420))

    @classmethod
    def load_npz(cls, path: str) -> "EncodedVideo":
        """Load a stream written by either package; tensors land on the
        CPU."""
        with np.load(path, allow_pickle=False) as data:
            raw_meta = str(data["_meta"][0])
            try:
                meta = json.loads(raw_meta)
            except json.JSONDecodeError:
                # the JAX package's first streams stored the repr of the dict
                meta = ast.literal_eval(raw_meta)
            cfg = CodecConfig(
                block_size=int(meta["block_size"]),
                gop_pattern=tuple(meta["gop_pattern"].split(",")),
                quality_factor=float(meta["quality_factor"]),
                with_dct=bool(meta["with_dct"]),
                with_residual=bool(meta["with_residual"]),
                quant_mode=meta["quant_mode"],
                search_reach=int(meta.get("search_reach", 16)),
                intra_i=bool(meta.get("intra_i", 0)),
                intra_qstep=int(meta.get("intra_qstep", 0)),
                chroma_420=bool(meta.get("chroma_420", 0)))
            return cls(cfg, int(meta["height"]), int(meta["width"]),
                       float(meta["fps"]), int(meta["num_frames"]),
                       [gop_from_npz(data, cfg, f"gop{g}_")
                        for g in range(int(meta["num_gops"]))])
