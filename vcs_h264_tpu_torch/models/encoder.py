"""Host-side encoder orchestration (counterpart of
`vcs_h264_tpu/models/encoder.py:149-357`).

Frames are grouped into GOPs (frame n is an I-frame when n % gop_len == 0),
full GOPs are encoded `gop_batch` at a time on the device, and a shorter
tail GOP (fewer P-frames, or the I-frame alone) on its own. Under a B
pattern a full GOP codes its B-frames; a tail GOP is coded all-P. With
`intra_qstep > 0` each batch's I-frames are lossy intra-coded first (K5 on
a GPU); the P-frames are then coded against that reconstruction, which is
what the decoder has, and each GOP carries the intra payload.

Under `chroma_420` the same grouping feeds `models/pipeline420.py`: each
batch is ingested to Y and half-resolution chroma planes on the device and
coded there, lossy intra included, and an I-frame-only GOP stores its
ingested (or intra-reconstructed) planes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from vcs_h264_tpu_torch.config import CodecConfig
from vcs_h264_tpu_torch.models import intra_codec, pipeline, pipeline420
from vcs_h264_tpu_torch.models.gop import (EncodedGOP, EncodedGOP420,
                                            EncodedVideo)
from vcs_h264_tpu_torch.ops.motion import check_backend


def resolve_device(device) -> torch.device:
    """The requested device, never silently replaced: asking for CUDA on a
    machine without a usable GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not "
                               "available")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def group_into_gops(frames: Sequence[np.ndarray], gop_len: int
                    ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """[frames] -> [(i_frame [H, W, 3], p_frames [P, H, W, 3])] with the
    dispatch `frame_num % gop_len == 0 -> I` (the JAX package's
    `vcs_h264_tpu/io/video.py:group_into_gops`)."""
    gops = []
    for start in range(0, len(frames), gop_len):
        chunk = frames[start:start + gop_len]
        i_frame = chunk[0]
        p = np.stack(chunk[1:]) if len(chunk) > 1 else \
            np.zeros((0, *i_frame.shape), i_frame.dtype)
        gops.append((i_frame, p))
    return gops


class Encoder:
    """Encode BGR uint8 frames on `device` ("cuda" by default). `cfg` and
    `gop_batch` are the JAX package's positional parameters, in its order;
    `device` and `backend` are the port's own and keyword-only.

    backend: "auto" (CUDA kernels on a GPU, plain PyTorch on the CPU) or
    "plain" (the plain PyTorch versions on any device)."""

    def __init__(self, cfg: CodecConfig = CodecConfig(), gop_batch: int = 8,
                 *, device="cuda", backend: str = "auto"):
        if gop_batch < 1:
            raise ValueError("gop_batch must be >= 1")
        check_backend(backend)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.gop_batch = gop_batch
        self.backend = backend

    def _upload(self, hwc: np.ndarray) -> torch.Tensor:
        """uint8 [..., H, W, 3] host frames -> planar [..., 3, H, W] on the
        device (uint8 crosses the host link, 4x less than int32)."""
        t = torch.from_numpy(np.ascontiguousarray(hwc, dtype=np.uint8))
        return t.to(self.device).movedim(-1, -3).contiguous()

    def _code_i_frames(self, i_b: torch.Tensor):
        """uint8 [B, 3, H, W] I-frames -> (the frames the P-frames reference,
        per-GOP payload fields). Raw I-frames carry no payload; lossy intra
        references its reconstruction and carries qcoef, modes, escape."""
        if not self.cfg.intra_qstep:
            return i_b, [{} for _ in range(i_b.shape[0])]
        payload, recon = intra_codec.encode_intra_frames_lossy_batch(
            i_b, self.cfg.intra_qstep, self.backend)
        return recon, [dict(i_qcoef=payload.qcoef[b], i_modes=payload.modes[b],
                            i_escape=payload.escape[b])
                       for b in range(i_b.shape[0])]

    def encode_frames(self, frames: Sequence[np.ndarray], fps: float = 25.0,
                      checkpoint_dir: Optional[str] = None) -> EncodedVideo:
        """Encode BGR uint8 frames [H, W, 3] of one shape, H and W multiples
        of the block size (of twice the block size under `chroma_420`: the
        half-resolution chroma planes hold whole transform blocks)."""
        if checkpoint_dir is not None:
            raise NotImplementedError(
                "vcs_h264_tpu_torch does not port per-GOP checkpoints yet "
                "(ROADMAP M5)")
        if not len(frames):
            raise ValueError("no frames to encode")
        cfg = self.cfg
        h, w, _ = frames[0].shape
        bs = cfg.block_size
        if cfg.chroma_420 and (h % (2 * bs) or w % (2 * bs)):
            raise ValueError(f"frame {h}x{w} must be a multiple of {2 * bs}, "
                             "twice the block size, under chroma_420")
        if h % bs or w % bs:
            raise ValueError(f"frame {h}x{w} must be a multiple of block {bs}")
        grouped = group_into_gops(frames, cfg.gop_len)
        # full GOPs are batched (with their B-frames under a B pattern); a
        # shorter tail GOP, coded all-P, or any GOP with no P-frame (an
        # all-I pattern), is coded on its own
        is_full = [p.shape[0] == cfg.gop_len - 1 > 0 for _, p in grouped]
        full = [i for i, f in enumerate(is_full) if f]
        tail = [i for i, f in enumerate(is_full) if not f]
        encoded: List[Optional[EncodedGOP]] = [None] * len(grouped)
        if cfg.chroma_420:
            self._encode_420(grouped, full, tail, encoded)
            return EncodedVideo(config=cfg, height=h, width=w, fps=fps,
                                num_frames=len(frames), gops=encoded)

        for start in range(0, len(full), self.gop_batch):
            idxs = full[start:start + self.gop_batch]
            i_b, payloads = self._code_i_frames(
                self._upload(np.stack([grouped[i][0] for i in idxs])))
            p_b = self._upload(np.stack([grouped[i][1] for i in idxs]))
            out = pipeline.encode_gop_batch(i_b, p_b, cfg, self.backend)
            for bi, idx in enumerate(idxs):
                encoded[idx] = dataclasses.replace(out.select(bi),
                                                   **payloads[bi])

        for idx in tail:
            i_f, p_f = grouped[idx]
            i_b, payloads = self._code_i_frames(self._upload(i_f[None]))
            if p_f.shape[0] == 0:
                gop = EncodedGOP(
                    i_frame=i_b[0],
                    mv=torch.zeros((0, h // bs, w // bs, 2), dtype=torch.int32,
                                   device=self.device),
                    residuals=None)
            else:
                gop = pipeline.encode_gop(i_b[0], self._upload(p_f), cfg,
                                          self.backend)
            encoded[idx] = dataclasses.replace(gop, **payloads[0])
        return EncodedVideo(config=cfg, height=h, width=w, fps=fps,
                            num_frames=len(frames), gops=encoded)

    def _encode_420(self, grouped, full, tail, encoded) -> None:
        """4:2:0: full GOPs batched, a shorter tail GOP as a batch of one,
        an I-frame-only GOP from its ingested planes."""
        cfg = self.cfg
        for start in range(0, len(full), self.gop_batch):
            idxs = full[start:start + self.gop_batch]
            out = pipeline420.encode_gop_batch_420(
                self._upload(np.stack([grouped[i][0] for i in idxs])),
                self._upload(np.stack([grouped[i][1] for i in idxs])),
                cfg, self.backend)
            for bi, idx in enumerate(idxs):
                encoded[idx] = out.select(bi)

        for idx in tail:
            i_f, p_f = grouped[idx]
            i_b = self._upload(i_f[None])
            if p_f.shape[0]:
                encoded[idx] = pipeline420.encode_gop_batch_420(
                    i_b, self._upload(p_f[None]), cfg, self.backend).select(0)
                continue
            h, w = i_f.shape[:2]
            y, c = pipeline420.ingest_420(i_b)
            payload = {}
            if cfg.intra_qstep:
                (y, c), payload = pipeline420.encode_intra_420(
                    y, c, cfg.intra_qstep, self.backend)
            encoded[idx] = EncodedGOP420(
                i_y=y, i_c=c,
                mv=torch.zeros((1, 0, h // cfg.block_size,
                                w // cfg.block_size, 2), dtype=torch.int32,
                               device=self.device),
                res_y=None, res_c=None, **payload).select(0)
