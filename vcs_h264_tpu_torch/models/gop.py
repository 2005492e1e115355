"""Encoded-stream data model and the `.npz` container (counterpart of
`vcs_h264_tpu/models/gop.py`).

The `.npz` layout is key for key and dtype for dtype the JAX package's
(`EncodedVideo.save_npz` / `load_npz`), so each package loads the other's
files: a `_meta` JSON string, then per GOP g `gop{g}_i` uint8 [3, H, W],
`gop{g}_mv` int16 [P, nbh, nbw, 2] and, when the GOP has P-frames,
`gop{g}_res` int16 [P, 3, H, W].
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence

import numpy as np
import torch

from vcs_h264_tpu_torch.config import CodecConfig, check_supported


@dataclasses.dataclass
class EncodedGOP:
    """One encoded GOP, or a batch of them with a leading GOP axis.

    i_frame:   uint8 [3, H, W]             the I-frame, stored raw
    mv:        int32 [P, nbh, nbw, 2]       (dx, dy) per block per P-frame
    residuals: int16 [P, 3, H, W] or None   quantized coefficient planes
    """
    i_frame: torch.Tensor
    mv: torch.Tensor
    residuals: Optional[torch.Tensor]

    @property
    def num_p(self) -> int:
        return self.mv.shape[-4]

    @property
    def num_coded(self) -> int:
        return 1 + self.num_p

    def select(self, b: int) -> "EncodedGOP":
        """GOP b of a batch."""
        return EncodedGOP(self.i_frame[b], self.mv[b],
                          None if self.residuals is None else self.residuals[b])

    def to(self, device) -> "EncodedGOP":
        return EncodedGOP(
            self.i_frame.to(device), self.mv.to(device),
            None if self.residuals is None else self.residuals.to(device))

    @staticmethod
    def stack(gops: Sequence["EncodedGOP"], device) -> "EncodedGOP":
        """Batch GOPs of one shape onto `device`."""
        res = [g.residuals for g in gops]
        return EncodedGOP(
            torch.stack([g.i_frame for g in gops]).to(device),
            torch.stack([g.mv for g in gops]).to(device),
            None if res[0] is None else torch.stack(res).to(device))


@dataclasses.dataclass
class EncodedVideo:
    """A sequence of encoded GOPs plus stream metadata."""
    config: CodecConfig
    height: int
    width: int
    fps: float
    num_frames: int
    gops: List[EncodedGOP]

    def save_npz(self, path: str) -> None:
        arrays = {}
        for g, gop in enumerate(self.gops):
            arrays[f"gop{g}_i"] = gop.i_frame.cpu().numpy().astype(np.uint8)
            arrays[f"gop{g}_mv"] = gop.mv.cpu().numpy().astype(np.int16)
            if gop.residuals is not None:
                arrays[f"gop{g}_res"] = gop.residuals.cpu().numpy().astype(np.int16)
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
        CPU. Raises NotImplementedError for a mode the port does not code."""
        with np.load(path, allow_pickle=False) as data:
            meta = json.loads(str(data["_meta"][0]))
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
            check_supported(cfg)
            gops = []
            for g in range(int(meta["num_gops"])):
                res = (data[f"gop{g}_res"] if f"gop{g}_res" in data.files
                       else None)
                gops.append(EncodedGOP(
                    torch.from_numpy(data[f"gop{g}_i"].astype(np.uint8)),
                    torch.from_numpy(data[f"gop{g}_mv"].astype(np.int32)),
                    None if res is None
                    else torch.from_numpy(res.astype(np.int16))))
        return cls(cfg, int(meta["height"]), int(meta["width"]),
                   float(meta["fps"]), int(meta["num_frames"]), gops)
