"""Command-line driver (counterpart of `vcs_h264_tpu/cli.py`), with the
same commands, flags, defaults and printed lines.

    python -m vcs_h264_tpu_torch.cli encode IN.mp4 -o OUT.vcs [--qf 50 ...]
    python -m vcs_h264_tpu_torch.cli decode IN.vcs -o OUT.mp4
    python -m vcs_h264_tpu_torch.cli roundtrip IN.mp4 -o OUT.mp4 [--metrics m.jsonl]
    python -m vcs_h264_tpu_torch.cli intra IN.png   (also dct, chroma)
    python -m vcs_h264_tpu_torch.cli encode IN.mp4 -o OUT.vcs --procs 2 \\
        --proc-id 0 --coordinator localhost:PORT --checkpoint-dir D

`--device {cuda,cpu}` (default cuda) takes the place of the JAX CLI's
`--platform`: cuda without a usable card raises, and nothing falls back
to the CPU.

Each command is a core and a file layer. The cores (`encode_reader`,
`decode_video`, `roundtrip_frames`, `intra_study`, `dct_study`,
`chroma_study`) take frames, images or streams, do the codec work and print
the statistics; they import no cv2. The file layer (`cmd_*`) reads and
writes images and videos with cv2, imported inside its functions, with the
JAX CLI's calls: a machine without OpenCV runs the cores.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

from vcs_h264_tpu_torch.config import CodecConfig
from vcs_h264_tpu_torch.models.encoder import resolve_device

DEVICES = ("cuda", "cpu")


def _add_codec_args(p: argparse.ArgumentParser):
    p.add_argument("--block-size", type=int, default=8)
    p.add_argument("--gop", type=str, default="IPPP",
                   help="GOP pattern, e.g. IPPP")
    p.add_argument("--qf", type=float, default=50.0, help="quality factor")
    p.add_argument("--no-dct", action="store_true")
    p.add_argument("--no-residual", action="store_true")
    p.add_argument("--quant-mode", choices=["reference", "rounded"],
                   default="reference")
    p.add_argument("--production", action="store_true",
                   help="rounded quant + intra-coded I-frames (the real "
                        "bitstream path; shorthand for CodecConfig."
                        "production())")
    p.add_argument("--intra-i", action="store_true",
                   help="intra-code I-frames (lossless) in the container")
    p.add_argument("--intra-qstep", type=int, default=0,
                   help="lossy intra quant step for I-frames (0 = lossless; "
                        "implies --intra-i)")
    p.add_argument("--chroma-420", action="store_true",
                   help="4:2:0 codec mode: Y + quarter-res chroma through "
                        "the whole pipeline (implies the production quant "
                        "path)")
    p.add_argument("--search-luma-only", action="store_true",
                   help="motion-search SAD on the G channel only "
                        "(H.264-style luma-only estimation; stored MVs "
                        "still drive full-channel compensation)")
    p.add_argument("--gop-batch", type=int, default=8)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--profile", action="store_true",
                   help="per-stage wall-clock timing (waits for the device "
                        "at stage exits; prints a summary and, with "
                        "--metrics, logs a stage_timings record)")
    p.add_argument("--trace-dir", default=None,
                   help="capture a TensorBoard-viewable trace of the "
                        "encode into this directory (torch.profiler)")


def _cfg(args) -> CodecConfig:
    """The codec configuration the flags ask for: --production forces
    rounded quantisation and intra-coded I-frames, --chroma-420 rounded
    quantisation, and --intra-qstep > 0 implies --intra-i."""
    kw = dict(
        block_size=args.block_size,
        gop_pattern=tuple(args.gop),
        quality_factor=args.qf,
        with_dct=not args.no_dct and not args.no_residual,
        with_residual=not args.no_residual,
        quant_mode=args.quant_mode,
        intra_i=args.intra_i or args.intra_qstep > 0,
        intra_qstep=args.intra_qstep,
        chroma_420=args.chroma_420,
        search_luma_only=getattr(args, "search_luma_only", False))
    if args.production:
        kw["quant_mode"] = "rounded"
        kw["intra_i"] = True
    if args.chroma_420:
        kw["quant_mode"] = "rounded"
    return CodecConfig(**kw)


def _block_multiple(cfg: CodecConfig) -> int:
    """Frames are cropped to this: 4:2:0 needs twice the block size (its
    half-resolution chroma planes hold whole blocks)."""
    return cfg.block_size * (2 if cfg.chroma_420 else 1)


def save_stream(video, path: str, device="cuda") -> str:
    """Write the stream, `.vcs` by extension and `.npz` otherwise; returns
    the path actually written (np.savez appends '.npz' to a name without
    it, so the given path may not exist)."""
    if path.endswith(".vcs"):
        from vcs_h264_tpu_torch.io.bitstream import save_vcs
        save_vcs(video, path, device=device)
        return path
    video.save_npz(path)
    return path if path.endswith(".npz") else path + ".npz"


def load_stream(path: str, device="cuda"):
    """Read a stream written by either package, `.vcs` by extension and
    `.npz` otherwise."""
    if path.endswith(".vcs"):
        from vcs_h264_tpu_torch.io.bitstream import load_vcs
        return load_vcs(path, device=device)
    from vcs_h264_tpu_torch.models.gop import EncodedVideo
    return EncodedVideo.load_npz(path)


def _maybe_trace(trace_dir):
    """A trace of the enclosed block into `trace_dir` (utils/profiling.py),
    or a no-op."""
    if not trace_dir:
        return contextlib.nullcontext()
    from vcs_h264_tpu_torch.utils.profiling import device_trace
    print(f"capturing device trace -> {trace_dir}")
    return device_trace(trace_dir)


def _print_stage_summary(enc) -> None:
    if enc.stage_timer is None or not enc.stage_timer.totals:
        return
    print("stage timings (wall-clock, device-synced at stage exits):")
    for name, s in enc.stage_timer.summary().items():
        print(f"  {name:24s} {s['mean_ms']:9.2f} ms/call "
              f"x{s['calls']} = {s['total_s']:.3f} s")


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work, so that a time means something."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# --- The cores: frames, images and streams in; no cv2 -----------------------


def encode_reader(reader, cfg: CodecConfig, output: str, *,
                  gop_batch: int = 8, profile: bool = False,
                  trace_dir=None, checkpoint_dir=None, device="cuda"):
    """Encode the frames of `reader` (any iterable of BGR uint8 [H, W, 3]
    frames with an `fps`) into the container `output`, streaming in chunks
    of `gop_batch` GOPs, with per-GOP checkpoints in `checkpoint_dir` when
    given (a GOP already there is loaded, not encoded). Prints the encode's
    frames, seconds, fps and the file's bytes; returns (the encoded video,
    the path written, the encode's seconds)."""
    from vcs_h264_tpu_torch.models.encoder import Encoder
    enc = Encoder(cfg, gop_batch, profile=profile, device=device)
    t0 = time.perf_counter()
    with _maybe_trace(trace_dir):
        video = enc.encode_stream(reader, checkpoint_dir=checkpoint_dir)
        _sync(enc.device)
    dt = time.perf_counter() - t0
    _print_stage_summary(enc)
    written = save_stream(video, output, enc.device)
    size = os.path.getsize(written)
    raw = video.num_frames * video.height * video.width * 3
    print(f"encoded {video.num_frames} frames in {dt:.2f}s "
          f"({video.num_frames / dt:.1f} fps) -> {written} "
          f"({size} bytes, {raw / max(size, 1):.2f}x vs raw)")
    return video, written, dt


def decode_video(video, sink, name: str, *, gop_batch: int = 8,
                 device="cuda") -> float:
    """Decode `video` frame by frame into `sink` (anything with `write(frame)`
    and `close()`, such as `io.video.VideoWriter`), which is closed at the
    end; prints the frames and seconds, naming the output `name`, and
    returns the seconds."""
    from vcs_h264_tpu_torch.models.decoder import Decoder
    t0 = time.perf_counter()
    try:
        for frame in Decoder(gop_batch, device=device).iter_frames(video):
            sink.write(frame)
    finally:
        sink.close()
    dt = time.perf_counter() - t0
    print(f"decoded {video.num_frames} frames in {dt:.2f}s -> {name}")
    return dt


def roundtrip_frames(frames, fps: float, cfg: CodecConfig, *,
                     gop_batch: int = 8, profile: bool = False,
                     trace_dir=None, metrics=None, device="cuda"):
    """Encode and decode BGR uint8 frames, print the fps and the mean PSNR
    (finite frames only); with `metrics` (a JSONL path) log the encoder's
    records, one `frame` record per frame and a `summary`. Returns (the
    encoded video, the decoded frames, the mean PSNR)."""
    from vcs_h264_tpu_torch.models.decoder import Decoder
    from vcs_h264_tpu_torch.models.encoder import Encoder
    from vcs_h264_tpu_torch.utils.metrics import MetricsLogger, psnr

    logger = MetricsLogger(metrics) if metrics else None
    try:
        enc = Encoder(cfg, gop_batch, logger, profile, device=device)
        t0 = time.perf_counter()
        with _maybe_trace(trace_dir):
            video = enc.encode_frames(frames, fps=fps)
            recon = Decoder(gop_batch, device=device).decode(video)
        dt = time.perf_counter() - t0
        _print_stage_summary(enc)
        psnrs = []
        for i, (f, r) in enumerate(zip(frames, recon)):
            p = psnr(f, r)
            psnrs.append(p)
            if logger:
                logger.log("frame", index=i, psnr_db=p)
        mean_psnr = float(np.mean([p for p in psnrs if np.isfinite(p)]
                                  or [np.inf]))
        print(f"{len(frames)} frames in {dt:.2f}s "
              f"({len(frames) / dt:.1f} fps), mean PSNR {mean_psnr:.2f} dB")
        if logger:
            logger.log("summary", frames=len(frames), seconds=dt,
                       fps=len(frames) / dt, mean_psnr_db=mean_psnr)
    finally:
        if logger:
            logger.close()
    return video, recon, mean_psnr


def _planes_of(img: np.ndarray, device) -> torch.Tensor:
    """HWC uint8 image -> planar [3, H, W] int32 on the device."""
    return torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1))).to(
        resolve_device(device), torch.int32)


def _image_of(planes: torch.Tensor) -> np.ndarray:
    """Planar [3, H, W] uint8 values -> HWC uint8 image on the host."""
    return planes.permute(1, 2, 0).to(torch.uint8).contiguous().cpu().numpy()


def intra_study(ycc: np.ndarray, mode: str = "4x4", device="cuda"):
    """The intra study on a YCrCb uint8 image [H, W, 3] (H, W multiples of
    16): the luma mode search (`mode` "4x4" or "16x16") and the joint
    chroma 8x8 search, with the printed sparsity of each residual. Returns
    (the prediction as a YCrCb uint8 image, the Y residual int32 [H, W],
    the Y modes int32 [nbh, nbw]) on the host."""
    from vcs_h264_tpu_torch.ops import intra
    from vcs_h264_tpu_torch.utils.metrics import sparsity

    y, cr, cb = _planes_of(ycc, device)
    yres, ypred, modes = (intra.luma4x4(y) if mode == "4x4"
                          else intra.luma16x16(y))
    crres, crpred, cbres, cbpred, _ = intra.chroma8x8(cr, cb)
    for name, r in (("Y", yres), ("Cb", cbres), ("Cr", crres)):
        print(f"sparsity ({name}): {sparsity(r):.6f}")
    pred = _image_of(torch.stack([ypred, crpred, cbpred]))
    return pred, yres.cpu().numpy(), modes.cpu().numpy()


def dct_study(img: np.ndarray, qf: float = 99.0, bs: int = 8,
              device="cuda") -> np.ndarray:
    """The DCT study on a BGR uint8 image (H, W multiples of bs): YCrCb
    less 128, the blockwise DCT, rounded quantisation at quality `qf`, and
    back; prints the coefficients' sparsity and the round trip's PSNR.
    Returns the reconstructed BGR uint8 image."""
    from vcs_h264_tpu_torch.ops import blocks, color, dct, quant
    from vcs_h264_tpu_torch.utils.metrics import psnr, sparsity

    planes = _planes_of(img, device)
    ycc = color.bgr_to_ycrcb_planes(planes).to(torch.float32) - 128
    q = quant.quant_tables(qf, planes.device)[:, None, None]
    coeffs = quant.quantize(
        dct.dct2_blocks(blocks.plane_to_blocks(ycc, bs)), q, rounded=True)
    print(f"sparsity: {sparsity(coeffs):.6f}")
    back = dct.idct2_blocks(quant.dequantize(coeffs, q))
    rec = (torch.round(blocks.blocks_to_plane(back)) + 128).clamp(0, 255)
    bgr = _image_of(color.ycrcb_to_bgr_planes(rec.to(torch.int32)))
    print(f"roundtrip PSNR at QF={qf}: {psnr(bgr, img):.2f} dB")
    return bgr


def chroma_study(img: np.ndarray, device="cuda") -> np.ndarray:
    """The 4:2:0 chroma study on a BGR uint8 image: prints the round trip's
    PSNR and returns its BGR uint8 image."""
    from vcs_h264_tpu_torch.ops import subsample
    from vcs_h264_tpu_torch.utils.metrics import psnr

    out = _image_of(subsample.chroma_420_roundtrip(_planes_of(img, device)))
    print(f"4:2:0 roundtrip PSNR: {psnr(out, img):.2f} dB")
    return out


# --- The file layer: cv2 (and matplotlib) imported inside ---------------------


def _encode_distributed(args, cfg: CodecConfig) -> None:
    """Multi-process encode: each process joins the process group, encodes
    its contiguous `assign_gops` span into the shared checkpoint directory,
    waits at the barrier, and process 0 assembles the container from the
    checkpoints (`parallel/distributed.py`)."""
    import cv2
    import torch.distributed as dist
    from vcs_h264_tpu_torch.io.video import VideoReader
    from vcs_h264_tpu_torch.parallel import distributed

    if not args.coordinator and not os.environ.get("VCS_COORDINATOR"):
        sys.exit("--procs > 1 requires --coordinator host:port")
    rank, world = distributed.init_distributed(args.coordinator, args.procs,
                                               args.proc_id)
    try:
        cap = cv2.VideoCapture(args.input)
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
        if args.max_frames:
            total = min(total, args.max_frames)
        reader = VideoReader(args.input, block_multiple=_block_multiple(cfg),
                             max_frames=total)
        frames = reader.read_all()
        ck = args.checkpoint_dir or args.output + ".ckpt"
        video = distributed.encode_distributed(
            frames, reader.fps, cfg, checkpoint_dir=ck, rank=rank,
            world=world, gop_batch=args.gop_batch, device=args.device)
        if video is not None:
            written = save_stream(video, args.output,
                                  distributed.rank_device(args.device, rank))
            print(f"[proc 0/{world}] wrote {written} ({len(video.gops)} "
                  f"GOPs, {world} procs)")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def cmd_encode(args) -> None:
    from vcs_h264_tpu_torch.io.video import VideoReader
    cfg = _cfg(args)
    if args.procs > 1:
        _encode_distributed(args, cfg)
        return
    reader = VideoReader(args.input, block_multiple=_block_multiple(cfg),
                         max_frames=args.max_frames)
    encode_reader(reader, cfg, args.output, gop_batch=args.gop_batch,
                  profile=args.profile, trace_dir=args.trace_dir,
                  checkpoint_dir=args.checkpoint_dir, device=args.device)


def cmd_decode(args) -> None:
    from vcs_h264_tpu_torch.io.video import VideoWriter
    video = load_stream(args.input, args.device)
    writer = VideoWriter(args.output, video.width, video.height, video.fps)
    decode_video(video, writer, args.output, gop_batch=args.gop_batch,
                 device=args.device)


def cmd_roundtrip(args) -> None:
    from vcs_h264_tpu_torch.io.video import VideoReader, VideoWriter
    cfg = _cfg(args)
    reader = VideoReader(args.input, block_multiple=_block_multiple(cfg),
                         max_frames=args.max_frames)
    frames = reader.read_all()
    video, recon, _ = roundtrip_frames(
        frames, reader.fps, cfg, gop_batch=args.gop_batch,
        profile=args.profile, trace_dir=args.trace_dir, metrics=args.metrics,
        device=args.device)
    if args.output:
        writer = VideoWriter(args.output, video.width, video.height,
                             video.fps)
        for r in recon:
            writer.write(r)
        writer.close()
        print(f"wrote {args.output}")


def _save_side_by_side(path: str, panels, titles) -> None:
    """The studies' side-by-side comparison, saved to a file (matplotlib's
    Agg backend). Panels are BGR or grayscale."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(1, len(panels), figsize=(6 * len(panels), 5))
    if len(panels) == 1:
        axes = [axes]
    for ax, img, title in zip(axes, panels, titles):
        if img.ndim == 3:
            ax.imshow(img[..., ::-1])          # BGR -> RGB
        else:
            ax.imshow(img, cmap="gray")
        ax.set_title(title)
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    print(f"wrote comparison plot -> {path}")


def _read_image(path: str, multiple: int = 0):
    """cv2.imread, resized down to a multiple of `multiple` when given;
    exits when the file cannot be read."""
    import cv2
    img = cv2.imread(path)
    if img is None:
        sys.exit(f"cannot read {path}")
    if multiple:
        h, w = img.shape[:2]
        img = cv2.resize(img, (multiple * (w // multiple),
                               multiple * (h // multiple)))
    return img


def cmd_intra(args) -> None:
    import cv2
    img = _read_image(args.input, 16)
    ycc = cv2.cvtColor(img, cv2.COLOR_BGR2YCR_CB)
    pred, yres, modes = intra_study(ycc, args.mode, args.device)
    pred_bgr = cv2.cvtColor(pred, cv2.COLOR_YCR_CB2BGR)
    if args.output:
        cv2.imwrite(args.output, pred_bgr)
        print(f"wrote prediction image -> {args.output}")
    if args.plot:
        _save_side_by_side(
            args.plot,
            [img, pred_bgr, np.abs(yres).astype(np.uint8),
             modes.astype(np.uint8)],
            ["original", "intra prediction", "|Y residual|", "Y mode map"])


def cmd_dct_study(args) -> None:
    import cv2
    img = _read_image(args.input, args.block_size)
    bgr = dct_study(img, args.qf, args.block_size, args.device)
    if args.output:
        cv2.imwrite(args.output, bgr)
        print(f"wrote {args.output}")
    if args.plot:
        _save_side_by_side(args.plot, [img, bgr],
                           ["original", f"DCT roundtrip QF={args.qf:.0f}"])


def cmd_chroma_study(args) -> None:
    import cv2
    img = _read_image(args.input)
    out = chroma_study(img, args.device)
    if args.output:
        cv2.imwrite(args.output, out)
        print(f"wrote {args.output}")
    if args.plot:
        _save_side_by_side(args.plot, [img, out],
                           ["original", "4:2:0 roundtrip"])


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="vcs_h264_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("encode", help="encode video -> .npz/.vcs bitstream")
    p.add_argument("input")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--procs", type=int, default=1,
                   help="total processes for a multi-process encode "
                        "(torch.distributed; GOP spans assigned per "
                        "process)")
    p.add_argument("--proc-id", type=int, default=None)
    p.add_argument("--coordinator", default=None,
                   help="host:port of the store that process 0 hosts")
    p.add_argument("--checkpoint-dir", default=None,
                   help="per-GOP checkpoint/resume dir (shared across "
                        "processes in distributed mode)")
    _add_codec_args(p)
    p.set_defaults(fn=cmd_encode)

    p = sub.add_parser("decode", help="decode .npz/.vcs bitstream -> video")
    p.add_argument("input")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--gop-batch", type=int, default=8)
    p.set_defaults(fn=cmd_decode)

    p = sub.add_parser("roundtrip", help="encode+decode, report PSNR")
    p.add_argument("input")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--metrics", default=None, help="JSONL metrics path")
    _add_codec_args(p)
    p.set_defaults(fn=cmd_roundtrip)

    p = sub.add_parser("intra", help="intra-frame study on an image")
    p.add_argument("input")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--mode", choices=["4x4", "16x16"], default="4x4")
    p.add_argument("--plot", default=None, help="side-by-side comparison PNG")
    p.set_defaults(fn=cmd_intra)

    p = sub.add_parser("dct", help="DCT+quant study on an image")
    p.add_argument("input")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--qf", type=float, default=99.0)
    p.add_argument("--plot", default=None, help="side-by-side comparison PNG")
    p.add_argument("--block-size", type=int, default=8)
    p.set_defaults(fn=cmd_dct_study)

    p = sub.add_parser("chroma", help="4:2:0 subsampling study on an image")
    p.add_argument("input")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--plot", default=None, help="side-by-side comparison PNG")
    p.set_defaults(fn=cmd_chroma_study)

    for sp in sub.choices.values():
        sp.add_argument("--device", choices=DEVICES, default="cuda",
                        help="run on the GPU (default; raises without one) "
                             "or on the CPU")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    args.fn(args)


if __name__ == "__main__":
    main()
