"""Production stage split at tiled resolutions (counterpart of
`tools/exp_720_stages.py`): intra encode and decode, inter encode+decode,
the search alone, the fused inter encode (K3) and decode (K4) alone, and
the unfused encode, K1's compensation followed by the plain PyTorch chain
(`inter_cuda.dct_compress_residual_signed`), under the JAX tool's name
`xla_enc(comp+dctq)`. `CodecConfig.production(intra_qstep=24)`. The
640x360 source frames are tiled --tile x --tile: 2 -> 1280x720, 3 ->
1920x1080, where K5 takes its path with direct stores (270 block rows).
Each stage's `ms`, `device_ms` and `launches` are those of
`tools/_timing.py`.

Run:  python -m vcs_h264_tpu_torch.tools.exp_720_stages [--frames 32]
          [--iters 4] [--tile 2|3] [--video PATH | --synthetic SEED]
          [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from vcs_h264_tpu_torch.tools import _timing, clips

QSTEP = 24

# the kernels each stage launches on a GPU, by launch counter (see
# profile_stages.EXPECTED_KERNELS)
EXPECTED_KERNELS = {
    "intra_enc": {"intra_encode"},
    "intra_dec": {"intra_decode"},
    "inter_encdec": {"sad_search", "fused_p_encode", "fused_p_decode"},
    "search": {"sad_search"},
    "fused_enc": {"fused_p_encode"},
    "fused_dec": {"fused_p_decode"},
    "xla_enc(comp+dctq)": {"compensate"},
}


def build_stages(i_b, p_b) -> dict:
    """I-frames uint8 [B, 3, H, W] and P-frames [B, F, 3, H, W] on one
    device -> {stage name: fn(it)}, each returning its outputs; iteration
    `it` takes the inputs rolled by `it & 7` along the width, as the JAX
    tool's loop does."""
    from vcs_h264_tpu_torch.config import CodecConfig
    from vcs_h264_tpu_torch.models import intra_codec, pipeline
    from vcs_h264_tpu_torch.ops import inter_cuda, motion

    cfg = CodecConfig.production(intra_qstep=QSTEP)
    bs, qf = cfg.block_size, cfg.quality_factor
    search_kw = dict(bs=bs, reach=cfg.search_reach, step=cfg.search_step,
                     static_threshold=cfg.static_threshold)
    pr, ir = _timing.rolled(p_b), _timing.rolled(i_b)
    pay0, _ = intra_codec.encode_intra_frames_lossy_batch(i_b, QSTEP)
    qr = _timing.rolled(pay0.qcoef)
    mv0 = motion.motion_search_gops(p_b, i_b, **search_kw)
    cor = _timing.rolled(inter_cuda.encode_p_coeffs(mv0, i_b, p_b, qf))

    def inter(it):
        enc = pipeline.encode_gop_batch(i_b, pr[it & 7], cfg)
        return enc, pipeline.decode_gop_batch(enc, cfg)

    def unfused_enc(it):
        recon = motion.motion_compensate_gops(mv0, i_b, bs=bs)
        return inter_cuda.dct_compress_residual_signed(
            pr[it & 7].to(torch.int32) - recon.to(torch.int32), qf)

    return {
        "intra_enc": lambda it: intra_codec.encode_intra_frames_lossy_batch(
            ir[it & 7], QSTEP),
        "intra_dec": lambda it: intra_codec.decode_intra_frames_lossy_batch(
            intra_codec.IntraFrameLossy(qr[it & 7], pay0.modes, pay0.escape),
            QSTEP),
        "inter_encdec": inter,
        "search": lambda it: motion.motion_search_gops(pr[it & 7], i_b,
                                                       **search_kw),
        "fused_enc": lambda it: inter_cuda.encode_p_coeffs(
            mv0, i_b, pr[it & 7], qf),
        "fused_dec": lambda it: inter_cuda.decode_p_frames(
            mv0, i_b, cor[it & 7], qf),
        "xla_enc(comp+dctq)": unfused_enc,
    }


def main(arr: np.ndarray, iters: int = 4, device: str = "cuda",
         source: str = "synthetic:0") -> dict:
    """Time every stage on the frames `arr` (uint8 [N, 3, H, W], already
    tiled; its whole GOPs of 4), `iters` iterations each; prints the JAX
    tool's lines, then one JSON line, which it returns."""
    from vcs_h264_tpu_torch.models.encoder import resolve_device
    dev = resolve_device(device)
    i_b, p_b = clips.gop_batches(arr, 4, dev)
    print(f"frames={len(arr)} gops={i_b.shape[0]} i_b={tuple(i_b.shape)} "
          f"res={arr.shape[-1]}x{arr.shape[-2]}", flush=True)
    return _timing.run_stages("exp_720_stages", build_stages(i_b, p_b),
                              iters, dev, arr, source,
                              "{name:22s} {ms:8.2f} ms / {n} frames")


def cli(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--tile", type=int, default=2,
                    help="spatial tiling of the 640x360 source "
                         "(2=720p, 3=1080p)")
    clips.add_source_args(ap)
    args = ap.parse_args(argv)
    frames, source = clips.source_frames(args.video, args.synthetic,
                                         args.frames)
    return main(clips.tiled(clips.planar(frames), args.tile), args.iters,
                args.device, source)


if __name__ == "__main__":
    cli()
