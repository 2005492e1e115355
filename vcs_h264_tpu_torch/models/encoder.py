"""Host-side encoder orchestration (counterpart of
`vcs_h264_tpu/models/encoder.py`).

Frames are grouped into GOPs (frame n is an I-frame when n % gop_len == 0).
Full GOPs are encoded `gop_batch` at a time on the device, and so are GOPs
of an I-frame alone (every GOP of the all-intra pattern `("I",)`, or the
last GOP of a P/B stream): one upload and one intra call a batch. A shorter
tail GOP with P-frames is coded on its own. Under a B pattern a full GOP
codes its B-frames; a tail GOP is coded all-P. With `intra_qstep > 0` each
batch's I-frames are lossy intra-coded first (K5 on a GPU); the P-frames
are then coded against that reconstruction, which is what the decoder has,
and each GOP carries the intra payload.

Under `chroma_420` the same grouping feeds `models/pipeline420.py`: each
batch is ingested to Y and half-resolution chroma planes on the device and
coded there, lossy intra included; a batch of I-frame-only GOPs stores its
ingested (or intra-reconstructed) planes.

Frames reach the device through `models/host_path.py`: stacked into pinned
buffers and copied on an upload stream, so that the upload of one batch
overlaps the coding of the one before. Encoded GOPs stay on the device.

Per-GOP checkpoints: with `checkpoint_dir`, every encoded GOP is written as
`gop_{index:06d}.npz` (`models.gop.save_gop_npz`) as soon as it is coded,
and a GOP already there is loaded instead of encoded, unless it was written
under another configuration (`_cfg_fingerprint`), when it is encoded
again. The files are key for key and dtype for dtype the JAX package's, and
the fingerprint the same string, so each package resumes the other's
directory. A loaded GOP
holds host tensors, an encoded one device tensors; the decoder and both
containers take either.

Metrics and stage timings: with `metrics` (a `utils.metrics.MetricsLogger`)
each GOP logs its static-block ratio and, with a DCT, its share of nonzero
coefficients, and each call an `encode_summary`; with `profile=True` the
stages `intra_i_encode`, `encode_gop_batch`, `encode_gop_batch_420` and
`checkpoint_write` are timed (`utils.profiling.StageTimer`, which waits for
the device at each stage's end, so it defeats the overlap: keep it off for
throughput) and their means logged as `stage_timings`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from vcs_h264_tpu_torch.config import CodecConfig
from vcs_h264_tpu_torch.io.video import group_into_gops
from vcs_h264_tpu_torch.models import intra_codec, pipeline, pipeline420
from vcs_h264_tpu_torch.models.gop import (EncodedGOP, EncodedGOP420,
                                            EncodedVideo, load_gop_npz,
                                            save_gop_npz)
from vcs_h264_tpu_torch.models.host_path import HostPath
from vcs_h264_tpu_torch.ops.motion import check_backend
from vcs_h264_tpu_torch.utils.profiling import StageTimer, trace_annotation

__all__ = ["Encoder", "group_into_gops", "resolve_device"]


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


def _cfg_fingerprint(cfg: CodecConfig) -> str:
    """Stable string of every knob that changes what a checkpointed GOP
    contains, the same string as the JAX package's. A checkpoint written
    under another fingerprint is encoded again, never reused: the
    lossy-intra payload, for one, depends on intra_qstep."""
    return json.dumps(dict(
        block_size=cfg.block_size, gop_pattern=",".join(cfg.gop_pattern),
        search_reach=cfg.search_reach, search_step=cfg.search_step,
        static_threshold=cfg.static_threshold,
        quality_factor=cfg.quality_factor, with_dct=cfg.with_dct,
        with_residual=cfg.with_residual, quant_mode=cfg.quant_mode,
        intra_i=cfg.intra_i, intra_qstep=cfg.intra_qstep,
        chroma_420=cfg.chroma_420), sort_keys=True)


class Encoder:
    """Encode BGR uint8 frames on `device` ("cuda" by default). `cfg`,
    `gop_batch`, `metrics` and `profile` are the JAX package's positional
    parameters, in its order; `device` and `backend` are the port's own and
    keyword-only.

    metrics: a `utils.metrics.MetricsLogger` (anything with `log(event,
    **fields)`), or None.
    profile: time each stage (see the module's docstring).
    backend: "auto" (CUDA kernels on a GPU, plain PyTorch on the CPU) or
    "plain" (the plain PyTorch versions on any device)."""

    def __init__(self, cfg: CodecConfig = CodecConfig(), gop_batch: int = 8,
                 metrics=None, profile: bool = False, *, device="cuda",
                 backend: str = "auto"):
        if gop_batch < 1:
            raise ValueError("gop_batch must be >= 1")
        if metrics is not None and not callable(getattr(metrics, "log",
                                                        None)):
            raise TypeError(f"metrics must have a log method, got "
                            f"{metrics!r}")
        if not isinstance(profile, bool):
            raise TypeError(f"profile must be a bool, got {profile!r}")
        check_backend(backend)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.gop_batch = gop_batch
        self.backend = backend
        self.metrics = metrics
        self.stage_timer = StageTimer() if profile else None
        self._host = HostPath(self.device)

    def _stage(self, name: str):
        """Profiler-annotated (and, with profile=True, timed) stage scope."""
        if self.stage_timer is not None:
            return self.stage_timer.stage(name)
        return trace_annotation(name)

    def _upload(self, frames: Sequence[np.ndarray], lead) -> torch.Tensor:
        """uint8 host frames [H, W, 3] -> planar [*lead, 3, H, W] on the
        device, stacked once, straight into the staging buffer."""
        t = self._host.upload_frames(frames)
        return t.view(*lead, *t.shape[1:]).movedim(-1, -3).contiguous()

    def _upload_batch(self, grouped, idxs):
        """The I-frames [B, 3, H, W] and the other frames [B, F, 3, H, W] of
        the GOPs `idxs` on the device."""
        return (self._upload([grouped[i][0] for i in idxs], (len(idxs),)),
                self._upload([f for i in idxs for f in grouped[i][1]],
                             (len(idxs), self.cfg.gop_len - 1)))

    def _batches(self, idxs: List[int]):
        """`idxs` in runs of `gop_batch`."""
        for start in range(0, len(idxs), self.gop_batch):
            yield idxs[start:start + self.gop_batch]

    def _no_mv(self, n: int, h: int, w: int) -> torch.Tensor:
        """The vectors of `n` GOPs of an I-frame alone: int32 [n, 0, nbh,
        nbw, 2]."""
        bs = self.cfg.block_size
        return torch.zeros((n, 0, h // bs, w // bs, 2), dtype=torch.int32,
                           device=self.device)

    def _code_i_frames(self, i_b: torch.Tensor):
        """uint8 [B, 3, H, W] I-frames -> (the frames the P-frames reference,
        per-GOP payload fields). Raw I-frames carry no payload; lossy intra,
        the stage `intra_i_encode`, references its reconstruction and
        carries qcoef, modes, escape."""
        if not self.cfg.intra_qstep:
            return i_b, [{} for _ in range(i_b.shape[0])]
        with self._stage("intra_i_encode") as box:
            payload, recon = intra_codec.encode_intra_frames_lossy_batch(
                i_b, self.cfg.intra_qstep, self.backend)
            if box is not None:
                box["result"] = recon
        return recon, [dict(i_qcoef=payload.qcoef[b], i_modes=payload.modes[b],
                            i_escape=payload.escape[b])
                       for b in range(i_b.shape[0])]

    def encode_frames(self, frames: Sequence[np.ndarray], fps: float = 25.0,
                      checkpoint_dir: Optional[str] = None,
                      gop_index_offset: int = 0) -> EncodedVideo:
        """Encode BGR uint8 frames [H, W, 3] of one shape, H and W multiples
        of the block size (of twice the block size under `chroma_420`: the
        half-resolution chroma planes hold whole transform blocks).

        gop_index_offset: the index of the first GOP of `frames` in the
        whole video, which names its checkpoint file (a stream encoded in
        chunks, or by several processes into one directory)."""
        if not len(frames):
            raise ValueError("no frames to encode")
        t_start = time.perf_counter()
        cfg = self.cfg
        h, w, _ = frames[0].shape
        bs = cfg.block_size
        if cfg.chroma_420 and (h % (2 * bs) or w % (2 * bs)):
            raise ValueError(f"frame {h}x{w} must be a multiple of {2 * bs}, "
                             "twice the block size, under chroma_420")
        if h % bs or w % bs:
            raise ValueError(f"frame {h}x{w} must be a multiple of block {bs}")
        # (I-frame, [P/B-frames]) per GOP, as group_into_gops groups them,
        # without its copy: the frames are stacked once, for the upload
        grouped = [(frames[s], frames[s + 1:s + cfg.gop_len])
                   for s in range(0, len(frames), cfg.gop_len)]
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)

        def ckpt_path(idx: int) -> Optional[str]:
            return (os.path.join(
                checkpoint_dir, f"gop_{idx + gop_index_offset:06d}.npz")
                if checkpoint_dir else None)

        fingerprint = _cfg_fingerprint(cfg)
        encoded: List = [None] * len(grouped)
        pending = []
        for idx in range(len(grouped)):
            path = ckpt_path(idx)
            gop = (load_gop_npz(path, cfg, fingerprint)
                   if path and os.path.exists(path) else None)
            if gop is not None:
                encoded[idx] = gop
            else:
                pending.append(idx)

        # full GOPs (with their B-frames under a B pattern) and GOPs of an
        # I-frame alone are batched, each kind apart; a shorter tail GOP
        # with P-frames, coded all-P, is coded on its own
        full, intra, tail = [], [], []
        for i in pending:
            n_other = len(grouped[i][1])
            (intra if not n_other else
             full if n_other == cfg.gop_len - 1 else tail).append(i)
        encode = self._encode_420 if cfg.chroma_420 else self._encode_full_res
        encode(grouped, full, intra, tail, encoded, ckpt_path, fingerprint)
        video = EncodedVideo(config=cfg, height=h, width=w, fps=fps,
                             num_frames=len(frames), gops=encoded)
        self._log_summary(len(frames), len(encoded),
                          time.perf_counter() - t_start)
        return video

    def _encode_full_res(self, grouped, full, intra, tail, encoded,
                         ckpt_path, fingerprint) -> None:
        cfg = self.cfg

        def finish(idx, gop):
            encoded[idx] = gop
            self._log_gop(idx, gop)
            if ckpt_path(idx):
                with self._stage("checkpoint_write"):
                    save_gop_npz(ckpt_path(idx), gop, cfg, fingerprint)

        for idxs in self._batches(full):
            i_b, p_b = self._upload_batch(grouped, idxs)
            i_b, payloads = self._code_i_frames(i_b)
            with self._stage("encode_gop_batch") as box:
                out = pipeline.encode_gop_batch(i_b, p_b, cfg, self.backend)
                if box is not None:
                    box["result"] = out
            for bi, idx in enumerate(idxs):
                finish(idx, dataclasses.replace(out.select(bi),
                                                **payloads[bi]))

        for idxs in self._batches(intra):
            with trace_annotation("encode.intra_batch", frames=len(idxs)):
                i_b, payloads = self._code_i_frames(self._upload(
                    [grouped[i][0] for i in idxs], (len(idxs),)))
                mv = self._no_mv(len(idxs), *i_b.shape[-2:])
            for bi, idx in enumerate(idxs):
                finish(idx, EncodedGOP(i_frame=i_b[bi], mv=mv[bi],
                                       residuals=None, **payloads[bi]))

        for idx in tail:
            i_f, p_f = grouped[idx]
            i_b, payloads = self._code_i_frames(self._upload([i_f], (1,)))
            gop = pipeline.encode_gop(i_b[0], self._upload(p_f, (len(p_f),)),
                                      cfg, self.backend)
            finish(idx, dataclasses.replace(gop, **payloads[0]))

    def _encode_420(self, grouped, full, intra, tail, encoded, ckpt_path,
                    fingerprint) -> None:
        """4:2:0: full GOPs batched; I-frame-only GOPs batched, each the
        batch's ingested (or intra-reconstructed) planes; a shorter tail GOP
        as a batch of one."""
        cfg = self.cfg

        def finish(idx, gop):
            encoded[idx] = gop
            self._log_gop(idx, gop)
            if ckpt_path(idx):
                save_gop_npz(ckpt_path(idx), gop, cfg, fingerprint)

        for idxs in self._batches(full):
            i_b, p_b = self._upload_batch(grouped, idxs)
            with self._stage("encode_gop_batch_420") as box:
                out = pipeline420.encode_gop_batch_420(i_b, p_b, cfg,
                                                       self.backend)
                if box is not None:
                    box["result"] = out
            for bi, idx in enumerate(idxs):
                finish(idx, out.select(bi))

        for idxs in self._batches(intra):
            with trace_annotation("encode.intra_batch", frames=len(idxs)):
                y, c = pipeline420.ingest_420(self._upload(
                    [grouped[i][0] for i in idxs], (len(idxs),)))
                payload = {}
                if cfg.intra_qstep:
                    (y, c), payload = pipeline420.encode_intra_420(
                        y, c, cfg.intra_qstep, self.backend)
                out = EncodedGOP420(
                    i_y=y, i_c=c, mv=self._no_mv(len(idxs), *y.shape[-2:]),
                    res_y=None, res_c=None, **payload)
            for bi, idx in enumerate(idxs):
                finish(idx, out.select(bi))

        for idx in tail:
            i_f, p_f = grouped[idx]
            i_b, p_b = (self._upload([i_f], (1,)),
                        self._upload(p_f, (1, len(p_f))))
            with self._stage("encode_gop_batch_420") as box:
                out = pipeline420.encode_gop_batch_420(i_b, p_b, cfg,
                                                       self.backend)
                if box is not None:
                    box["result"] = out
            finish(idx, out.select(0))

    def _log_gop(self, idx: int, gop) -> None:
        """A `gop` record: the share of blocks with a zero vector in every
        P-frame and, with a DCT, the share of nonzero coefficients (a proxy
        for the bits). Reads the GOP back to the host."""
        if not self.metrics:
            return
        mv = gop.mv.cpu().numpy()
        n_blocks = max(1, mv.shape[0] * mv.shape[1] * mv.shape[2]) \
            if mv.ndim >= 3 else 1
        static = int(np.sum(np.all(mv == 0, axis=-1))) if mv.size else 0
        rec = {"gop": idx, "static_block_ratio": static / n_blocks}
        res = getattr(gop, "residuals", None)
        if res is None:
            res = getattr(gop, "res_y", None)
        if res is not None and self.cfg.with_dct:
            res = res.cpu().numpy()
            nz = int(np.count_nonzero(np.round(res)))
            rec["nonzero_coeff_ratio"] = nz / res.size
        self.metrics.log("gop", **rec)

    def _log_summary(self, n_frames: int, n_gops: int, dt: float) -> None:
        """The `encode_summary` record and, when profiling, the mean
        milliseconds of each stage as `stage_timings`."""
        if not self.metrics:
            return
        self.metrics.log("encode_summary", frames=n_frames, seconds=dt,
                         fps=n_frames / dt, gops=n_gops)
        if self.stage_timer is not None and self.stage_timer.totals:
            self.metrics.log("stage_timings", **{
                k: round(v["mean_ms"], 3)
                for k, v in self.stage_timer.summary().items()})

    def encode_video(self, path: str, max_frames: Optional[int] = None,
                     checkpoint_dir: Optional[str] = None) -> EncodedVideo:
        """Encode a video file (read with cv2). With `checkpoint_dir` every
        frame is read first, as resuming wants the whole frame list."""
        from vcs_h264_tpu_torch.io.video import VideoReader
        # 4:2:0 needs dims divisible by 2*bs (half-res chroma DCT blocks)
        mult = self.cfg.block_size * (2 if self.cfg.chroma_420 else 1)
        reader = VideoReader(path, block_multiple=mult,
                             max_frames=max_frames)
        if checkpoint_dir:
            frames = reader.read_all()
            return self.encode_frames(frames, fps=reader.fps,
                                      checkpoint_dir=checkpoint_dir)
        return self.encode_stream(reader)

    def encode_stream(self, reader, *,
                      checkpoint_dir: Optional[str] = None) -> EncodedVideo:
        """Streaming encode of any iterable of frames with an `fps`
        attribute, in chunks of `gop_batch` GOPs: the reader's work on the
        next chunk (a video reader's decode, the host's stacking) and its
        upload overlap the device's coding of this one, whose GOPs stay on
        the device. With `checkpoint_dir` each chunk's GOPs are
        checkpointed under their index in the whole stream."""
        cfg = self.cfg
        chunk = self.gop_batch * cfg.gop_len
        gops: List = []
        total = 0
        height = width = None
        buf: List[np.ndarray] = []

        def flush():
            nonlocal total, height, width
            if not buf:
                return
            v = self.encode_frames(buf, fps=reader.fps,
                                   checkpoint_dir=checkpoint_dir,
                                   gop_index_offset=len(gops))
            gops.extend(v.gops)
            total += len(buf)
            height, width = v.height, v.width
            buf.clear()

        for frame in reader:
            buf.append(frame)
            if len(buf) == chunk:
                flush()
        flush()
        if total == 0:
            raise ValueError("no frames to encode")
        return EncodedVideo(config=cfg, height=height, width=width,
                            fps=reader.fps, num_frames=total, gops=gops)
