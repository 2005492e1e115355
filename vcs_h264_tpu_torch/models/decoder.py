"""Host-side decoder orchestration (counterpart of
`vcs_h264_tpu/models/decoder.py:22-126`).

Full GOPs (I + P + B frames as many as the pattern has) are decoded
`gop_batch` at a time on the device; a tail GOP on its own, and an
I-frame-only GOP straight from its stored frame. A GOP without residuals
(with_residual=False) decodes from the compensation alone. With lossy
intra the stored I-frame is already the reconstruction, so the intra
payload is dropped before any upload: the P-frame decode never reads it.
A 4:2:0 stream takes the same walk through `models/pipeline420.py`, and
its I-frame-only GOP is emitted from its stored planes.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np
import torch

from vcs_h264_tpu_torch.models import pipeline, pipeline420
from vcs_h264_tpu_torch.models.encoder import resolve_device
from vcs_h264_tpu_torch.models.gop import EncodedVideo
from vcs_h264_tpu_torch.ops.motion import check_backend


class Decoder:
    """Decode an EncodedVideo on `device` ("cuda" by default). `gop_batch`
    is positional as in the JAX package; `device` and `backend` (as for the
    Encoder) are keyword-only."""

    def __init__(self, gop_batch: int = 8, *, device="cuda",
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
        for n, frame in enumerate(self._iter_gops(video)):
            if n >= video.num_frames:
                return
            yield frame

    def _host_frames(self, planar: torch.Tensor) -> Iterator[np.ndarray]:
        """uint8 [N, 3, H, W] on the device -> N host frames [H, W, 3]."""
        yield from planar.movedim(-3, -1).contiguous().cpu().numpy()

    def _iter_gops(self, video: EncodedVideo) -> Iterator[np.ndarray]:
        cfg = video.config
        if cfg.chroma_420:
            def decode_batch(batch):
                return pipeline420.decode_gop_batch_420(
                    batch, cfg, backend=self.backend)

            def i_frame(gop):
                return pipeline420.emit_bgr(gop.i_y.to(self.device),
                                            gop.i_c.to(self.device))
        else:
            def decode_batch(batch):
                return pipeline.decode_gop_batch(batch, cfg, self.backend)

            def i_frame(gop):
                return gop.i_frame
        buf: List = []

        def flush():
            if not buf:
                return
            out = decode_batch(type(buf[0]).stack(buf, self.device))
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
                yield from self._host_frames(i_frame(gop)[None])
            else:
                yield from self._host_frames(decode_batch(
                    type(gop).stack([gop], self.device))[0])
        yield from flush()
