"""Sustained throughput from frames to `.vcs` and back (counterpart of
`tools/bench_sustained.py`): the streaming encoder (`encode_stream`:
reader prefetch and upload overlapped with the device's coding) and the
`.vcs` writer, then `load_vcs` and the streaming decoder, each timed after
a warm pass; and the range coder alone, single-threaded, on the zigzag
coefficient streams of the video's GOPs, in MB/s of uncompressed stream.

With `--video PATH` the frames come from a video file and go back into
one (`Encoder.encode_video`, `Decoder.decode_to_file`; cv2, which the GPU
machine lacks); `--res 720` first writes the 2x2-tiled file, as the JAX
tool does. With `--synthetic SEED` they come from the seeded synthetic
clip in memory and the decoded frames are counted, so the cv2 file decode
and encode are not in the timed window. Configuration:
`CodecConfig.production(intra_qstep=24)` (`--production`, set by
default, as in the JAX tool).

Run:  python -m vcs_h264_tpu_torch.tools.bench_sustained [--res 360|720]
          [--frames 64] [--video PATH | --synthetic SEED]
          [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from vcs_h264_tpu_torch.tools import _timing, clips

QSTEP = 24


def range_coder_streams(video, bs: int) -> list:
    """The int16 zigzag coefficient stream of every GOP with residuals."""
    from vcs_h264_tpu_torch.io.bitstream import _zigzag_plane
    return [_zigzag_plane(np.round(g.residuals.cpu().numpy())
                          .astype(np.int16), bs)
            for g in video.gops if g.residuals is not None]


def range_coder_bench(streams: list, bs: int) -> tuple:
    """rc_encode_i16_cbf and rc_decode_i16_cbf over `streams`, one thread ->
    (the blobs, encode s, decode s); a decode that differs raises."""
    from vcs_h264_tpu_torch.io.bitstream import (rc_decode_i16_cbf,
                                                 rc_encode_i16_cbf)
    t0 = time.perf_counter()
    blobs = [rc_encode_i16_cbf(s, bs * bs) for s in streams]
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoded = [rc_decode_i16_cbf(b, len(s), bs * bs)
               for s, b in zip(streams, blobs)]
    t_dec = time.perf_counter() - t0
    if any(not np.array_equal(s, d) for s, d in zip(streams, decoded)):
        raise RuntimeError("the range coder did not give its stream back")
    return blobs, t_enc, t_dec


def sustained(reader, cfg, *, gop_batch: int = 8, device: str = "cuda",
              max_frames=None, out_dir=None, sink=None) -> dict:
    """Time the encode (frames -> `.vcs`) and the decode (`.vcs` -> frames)
    of `reader`, after a warm pass of each, and the range coder alone ->
    the JAX tool's JSON fields, with `platform` the device's name and
    `source`.

    reader: a reader of frames that can be iterated more than once (an
    iterable with an `fps`), or the path of a video file, which is read
    with `Encoder.encode_video` (up to `max_frames`) and decoded with
    `Decoder.decode_to_file`. From a reader, the timed decode's frames go
    to `sink.write` if a sink is given. The files are written into
    `out_dir` (`out.vcs`, `out.mp4`), a temporary directory by default."""
    from vcs_h264_tpu_torch.io.bitstream import load_vcs, save_vcs
    from vcs_h264_tpu_torch.models import Decoder, Encoder
    from vcs_h264_tpu_torch.models.encoder import resolve_device

    dev = resolve_device(device)
    from_file = isinstance(reader, str)
    enc = Encoder(cfg, gop_batch, device=dev)
    dec = Decoder(gop_batch, device=dev)

    def encode():
        if from_file:
            return enc.encode_video(reader, max_frames=max_frames)
        return enc.encode_stream(reader)

    def decode(video, out_mp4, to=None) -> int:
        if from_file:
            dec.decode_to_file(video, out_mp4)
            return video.num_frames
        n = 0
        for frame in dec.iter_frames(video):
            if to is not None:
                to.write(frame)
            n += 1
        return n

    with tempfile.TemporaryDirectory() as tmp:
        out_vcs = os.path.join(out_dir or tmp, "out.vcs")
        out_mp4 = os.path.join(out_dir or tmp, "out.mp4")
        save_vcs(encode(), out_vcs, device=dev)                  # warm
        t0 = time.perf_counter()
        video = encode()
        save_vcs(video, out_vcs, device=dev)
        t_enc = time.perf_counter() - t0
        n = video.num_frames

        decode(video, out_mp4)                                   # warm
        load_vcs(out_vcs, device=dev)
        t0 = time.perf_counter()
        loaded = load_vcs(out_vcs, device=dev)
        got = decode(loaded, out_mp4, sink)
        t_dec = time.perf_counter() - t0
        if got != n:
            raise RuntimeError(f"decoded {got} frames of {n}")
        size = os.path.getsize(out_vcs)

    bs = cfg.block_size
    streams = range_coder_streams(video, bs)
    raw_mb = sum(2 * len(s) for s in streams) / 1e6
    _, t_rc_e, t_rc_d = range_coder_bench(streams, bs)
    out = {
        "res": video.height, "frames": n, "platform": _timing.device_name(dev),
        "encode_wall_fps": n / t_enc, "decode_wall_fps": n / t_dec,
        "encode_s": t_enc, "decode_s": t_dec,
        "vcs_bytes_per_frame": size // n,
        "range_coder_encode_MBps": raw_mb / t_rc_e,
        "range_coder_decode_MBps": raw_mb / t_rc_d,
        "source": reader if from_file else "synthetic",
    }
    if not from_file:
        out["note"] = ("frames from memory, decoded frames counted: the cv2 "
                       "file decode and encode are not in the timed window")
    return out


def _write_video(frames, path: str) -> None:
    from vcs_h264_tpu_torch.io.video import VideoWriter
    h, w = frames[0].shape[:2]
    writer = VideoWriter(path, w, h, 25.0)
    try:
        for f in frames:
            writer.write(f)
    finally:
        writer.close()


def cli(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", type=int, choices=[360, 720], default=360)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--production", action="store_true", default=True)
    clips.add_source_args(ap)
    args = ap.parse_args(argv)
    from vcs_h264_tpu_torch.config import CodecConfig
    cfg = CodecConfig.production(intra_qstep=QSTEP)
    with tempfile.TemporaryDirectory() as tmp:
        if args.video:
            src = args.video
            if args.res == 720:
                # a real 1280x720 input file (2x2-tiled frames)
                src = os.path.join(tmp, "in720.mp4")
                _write_video([np.tile(f, (2, 2, 1)) for f in clips.read_video(
                    args.video, args.frames)], src)
            result = sustained(src, cfg, device=args.device,
                               max_frames=args.frames)
        else:
            frames = clips.synthetic_clip(args.synthetic, args.frames, 360,
                                          640)
            if args.res == 720:
                frames = [np.tile(f, (2, 2, 1)) for f in frames]
            result = sustained(clips.ClipReader(frames), cfg,
                               device=args.device)
            result["source"] = f"synthetic:{args.synthetic}"
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    cli()
