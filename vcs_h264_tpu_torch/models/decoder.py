"""Host-side decoder orchestration (counterpart of
`vcs_h264_tpu/models/decoder.py`).

Full GOPs (I + P + B frames as many as the pattern has) are decoded
`gop_batch` at a time on the device, and so are consecutive I-frame-only
GOPs, whose frames are their stored I-frames, stacked once a batch; a tail
GOP with P-frames is decoded on its own. Frames keep stream order where the
kinds mix. A GOP without residuals (with_residual=False) decodes from the
compensation alone. With lossy intra the stored I-frame is already the
reconstruction, so the intra payload is dropped before any upload: the
P-frame decode never reads it. A 4:2:0 stream takes the same walk through
`models/pipeline420.py`, and a batch of I-frame-only GOPs is emitted from
its stored planes in one call.

`iter_frames` is the streaming core. A stream in host memory goes up
through `models/host_path.py` (pinned staging, an upload stream); a GOP
already on the device (an encoder's output) is stacked there. Each batch's
frames come down into pinned buffers on a download stream, and are yielded,
as copies, once the next batch's decode is queued: the download and the
consumer's work on batch k (`decode_to_file`'s cv2 encode) overlap the
decode of batch k+1. A stream may mix host and device GOPs (a resumed
encode).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List

import numpy as np
import torch

from vcs_h264_tpu_torch.models import pipeline, pipeline420
from vcs_h264_tpu_torch.models.encoder import resolve_device
from vcs_h264_tpu_torch.models.gop import EncodedVideo
from vcs_h264_tpu_torch.models.host_path import Download, HostPath
from vcs_h264_tpu_torch.ops.motion import check_backend
from vcs_h264_tpu_torch.utils.profiling import trace_annotation


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
        self._host = HostPath(self.device)

    def decode(self, video: EncodedVideo) -> List[np.ndarray]:
        """-> list of BGR uint8 [H, W, 3] frames, in stream order."""
        return list(self.iter_frames(video))

    def iter_frames(self, video: EncodedVideo) -> Iterator[np.ndarray]:
        """Yield BGR uint8 [H, W, 3] frames in stream order."""
        for n, frame in enumerate(self._iter_gops(video)):
            if n >= video.num_frames:
                return
            yield frame

    def decode_to_file(self, video: EncodedVideo, path: str) -> None:
        """Stream-decode into a video file (written with cv2): the encode of
        each batch's frames overlaps the device's decode of the next."""
        from vcs_h264_tpu_torch.io.video import VideoWriter
        writer = VideoWriter(path, video.width, video.height, video.fps)
        try:
            for f in self.iter_frames(video):
                writer.write(f)
        finally:
            writer.close()

    def _stack(self, gops):
        """GOPs of one shape as one batch on the device."""
        return type(gops[0]).stack(gops, self.device,
                                   upload=self._host.upload_stack)

    def _iter_gops(self, video: EncodedVideo) -> Iterator[np.ndarray]:
        cfg = video.config
        if cfg.chroma_420:
            def decode_batch(batch):
                return pipeline420.decode_gop_batch_420(
                    batch, cfg, backend=self.backend)

            def i_frames(gops):
                # the stored planes alone: the vectors of such a GOP are empty
                one = self._stack([dataclasses.replace(g, mv=None)
                                   for g in gops])
                return pipeline420.emit_bgr(one.i_y, one.i_c)
        else:
            def decode_batch(batch):
                return pipeline.decode_gop_batch(batch, cfg, self.backend)

            def i_frames(gops):
                frames = [g.i_frame for g in gops]
                if all(f.device.type == "cpu" for f in frames):
                    return torch.stack(frames)      # nothing to upload
                return torch.stack([f.to(self.device) for f in frames])
        buf: List = []
        downloads: List[Download] = []

        def start(planar: torch.Tensor) -> None:
            """Start the download of uint8 [N, 3, H, W] frames."""
            downloads.append(self._host.download(
                planar.movedim(-3, -1).contiguous()))

        def ready() -> Iterator[np.ndarray]:
            """The frames of every download but the newest."""
            while len(downloads) > 1:
                yield from self._frames(downloads.pop(0))

        def flush():
            """Decode `buf`, GOPs of one kind: full ones or I-frame-only."""
            if not buf:
                return
            if buf[0].num_p:
                start(decode_batch(self._stack(buf)).flatten(0, 1))
            else:
                with trace_annotation("decode.intra_batch", frames=len(buf)):
                    start(i_frames(buf))
            buf.clear()
            yield from ready()

        for gop in video.gops:
            gop = gop.without_intra_payload()
            if gop.num_p and gop.num_coded != cfg.gop_len:
                yield from flush()
                start(decode_batch(self._stack([gop]))[0])
                yield from ready()
                continue
            if buf and bool(buf[0].num_p) != bool(gop.num_p):
                yield from flush()
            buf.append(gop)
            if len(buf) >= self.gop_batch:
                yield from flush()
        yield from flush()
        while downloads:
            yield from self._frames(downloads.pop(0))

    @staticmethod
    def _frames(download: Download) -> Iterator[np.ndarray]:
        """The frames of a finished download, each a copy: the buffer goes
        back to the allocator. The host's wait for the device's decode and
        the download is the span `decode.wait`."""
        with trace_annotation("decode.wait", d2h_copies=1,
                              d2h_bytes=download.nbytes):
            host = download.wait()
        for f in host.numpy():
            yield f.copy()
