"""Host-side decoder orchestration (counterpart of
`vcs_h264_tpu/models/decoder.py:22-82`, full resolution).

Full GOPs (I + P + B frames as many as the pattern has) are decoded
`gop_batch` at a time on the device; a tail GOP on its own, and an
I-frame-only GOP straight from its stored frame. A GOP without residuals
(with_residual=False) decodes from the compensation alone. With lossy
intra the stored I-frame is already the reconstruction, so the intra
payload is dropped before any upload: the P-frame decode never reads it.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np
import torch

from vcs_h264_tpu_torch.config import check_supported
from vcs_h264_tpu_torch.models import pipeline
from vcs_h264_tpu_torch.models.encoder import resolve_device
from vcs_h264_tpu_torch.models.gop import EncodedGOP, EncodedVideo
from vcs_h264_tpu_torch.ops.motion import check_backend


class Decoder:
    """Decode an EncodedVideo on `device` ("cuda" by default). `backend` as
    for the Encoder."""

    def __init__(self, device="cuda", gop_batch: int = 8,
                 backend: str = "auto"):
        if gop_batch < 1:
            raise ValueError("gop_batch must be >= 1")
        check_backend(backend)
        self.device = resolve_device(device)
        self.gop_batch = gop_batch
        self.backend = backend

    def decode(self, video: EncodedVideo) -> List[np.ndarray]:
        """-> list of BGR uint8 [H, W, 3] frames, in stream order."""
        return list(self.iter_frames(video))

    def iter_frames(self, video: EncodedVideo) -> Iterator[np.ndarray]:
        """Yield BGR uint8 [H, W, 3] frames in stream order."""
        check_supported(video.config)
        for n, frame in enumerate(self._iter_fullres(video)):
            if n >= video.num_frames:
                return
            yield frame

    def _host_frames(self, planar: torch.Tensor) -> Iterator[np.ndarray]:
        """uint8 [N, 3, H, W] on the device -> N host frames [H, W, 3]."""
        yield from planar.movedim(-3, -1).contiguous().cpu().numpy()

    def _iter_fullres(self, video: EncodedVideo) -> Iterator[np.ndarray]:
        cfg = video.config
        buf: List[EncodedGOP] = []

        def flush():
            if not buf:
                return
            out = pipeline.decode_gop_batch(
                EncodedGOP.stack(buf, self.device), cfg, self.backend)
            buf.clear()
            yield from self._host_frames(out.flatten(0, 1))

        for gop in video.gops:
            gop = gop.without_intra_payload()
            if gop.num_coded == cfg.gop_len and gop.num_p:
                buf.append(gop)
                if len(buf) >= self.gop_batch:
                    yield from flush()
                continue
            yield from flush()
            if gop.num_p == 0:
                yield from self._host_frames(gop.i_frame[None])
            else:
                yield from self._host_frames(pipeline.decode_gop(
                    gop.to(self.device), cfg, self.backend))
        yield from flush()
