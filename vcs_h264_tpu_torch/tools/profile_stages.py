"""Per-stage profile of the codec pipeline (counterpart of
`tools/profile_stages.py`).

Times ten stages on GOP batches of a 640x360 source, as the JAX tool does:
motion search, motion compensation, the residual DCT encode and its
encode+decode, the whole encode and encode+decode (all `CodecConfig()`,
reference mode), the lossy intra encode and decode (qstep 24), the
production loop (intra encode, inter encode and decode, no intra decode)
and the 4:2:0 loop (cropped to a multiple of 16 rows). `--res 720` tiles
the frames 2x2 to 1280x720, with fewer frames and iterations. Each stage's
`ms`, `device_ms` and `launches` are those of `tools/_timing.py`.

Run:  python -m vcs_h264_tpu_torch.tools.profile_stages [--res 360|720]
          [--video PATH | --synthetic SEED] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from vcs_h264_tpu_torch.tools import _timing, clips

FRAMES = {360: 64, 720: 32}
ITERS = {360: 16, 720: 4}
QSTEP = 24

# the kernels each stage launches on a GPU, by launch counter (K1
# compensate, K2 sad_search, K3/K4 fused_p_*, their bare-plane case
# plane_*, K5/K6 intra_*, K7 c420_*); the resid_dct stages run reference
# mode's elementwise chain, no kernel of the port
EXPECTED_KERNELS = {
    "search": {"sad_search"},
    "compensate": {"compensate"},
    "resid_dct_enc": set(),
    "resid_dct_encdec": set(),
    "encode": {"sad_search", "compensate"},
    "encode+decode": {"sad_search", "compensate"},
    "intra_lossy_enc": {"intra_encode"},
    "intra_lossy_dec": {"intra_decode"},
    "production_e2e": {"intra_encode", "sad_search", "fused_p_encode",
                       "fused_p_decode"},
    "chroma420_e2e": {"intra_encode", "sad_search", "plane_encode",
                      "plane_decode", "c420_encode", "c420_decode"},
}


def build_stages(i_b, p_b) -> dict:
    """I-frames uint8 [B, 3, H, W] and P-frames [B, F, 3, H, W] on one
    device -> {stage name: fn(it)}, each returning its outputs; iteration
    `it` takes the inputs rolled by `it & 7` along the width (the motion
    vectors by `it & 1` along the block rows), as the JAX tool's loop
    does."""
    from vcs_h264_tpu_torch.config import CodecConfig
    from vcs_h264_tpu_torch.models import intra_codec, pipeline, pipeline420
    from vcs_h264_tpu_torch.ops import motion

    cfg = CodecConfig()
    bs = cfg.block_size
    search_kw = dict(bs=bs, reach=cfg.search_reach, step=cfg.search_step,
                     static_threshold=cfg.static_threshold)
    pr, ir = _timing.rolled(p_b), _timing.rolled(i_b)
    mv0 = motion.motion_search_gops(p_b, i_b, **search_kw)
    recon0 = motion.motion_compensate_gops(mv0, i_b, bs=bs)
    mvr = _timing.rolled(mv0, 2, dim=2)
    pay0, _ = intra_codec.encode_intra_frames_lossy_batch(i_b, QSTEP)
    qr = _timing.rolled(pay0.qcoef)
    pcfg = CodecConfig.production(intra_qstep=QSTEP)
    ccfg = CodecConfig(quant_mode="rounded", chroma_420=True, intra_i=True,
                       intra_qstep=QSTEP)
    h420 = (i_b.shape[-2] // 16) * 16          # 2 * bs multiple for 4:2:0
    i420 = i_b[..., :h420, :].contiguous()
    p420 = pr if h420 == p_b.shape[-2] else _timing.rolled(
        p_b[..., :h420, :])

    def resid(it):
        return motion.residuals_wrap(pr[it & 7], recon0)

    def production(it):
        pay, i_rec = intra_codec.encode_intra_frames_lossy_batch(
            ir[it & 7], QSTEP)
        enc = pipeline.encode_gop_batch(i_rec, pr[it & 7], pcfg)
        return pay, enc, pipeline.decode_gop_batch(enc, pcfg)

    def chroma420(it):
        enc = pipeline420.encode_gop_batch_420(i420, p420[it & 7], ccfg)
        return enc, pipeline420.decode_gop_batch_420(enc, ccfg)

    def intra_enc(it):
        return intra_codec.encode_intra_frames_lossy_batch(ir[it & 7], QSTEP)

    def intra_dec(it):
        return intra_codec.decode_intra_frames_lossy_batch(
            intra_codec.IntraFrameLossy(qr[it & 7], pay0.modes, pay0.escape),
            QSTEP)

    def encode_decode(it):
        enc = pipeline.encode_gop_batch(i_b, pr[it & 7], cfg)
        return enc, pipeline.decode_gop_batch(enc, cfg)

    return {
        "search": lambda it: motion.motion_search_gops(pr[it & 7], i_b,
                                                       **search_kw),
        "compensate": lambda it: motion.motion_compensate_gops(
            mvr[it & 1], i_b, bs=bs),
        "resid_dct_enc": lambda it: pipeline.dct_compress_residual(
            resid(it), cfg),
        "resid_dct_encdec": lambda it: pipeline.dct_decompress_residual(
            pipeline.dct_compress_residual(resid(it), cfg), cfg),
        "encode": lambda it: pipeline.encode_gop_batch(i_b, pr[it & 7], cfg),
        "encode+decode": encode_decode,
        "intra_lossy_enc": intra_enc,
        "intra_lossy_dec": intra_dec,
        "production_e2e": production,
        "chroma420_e2e": chroma420,
    }


def main(arr: np.ndarray, iters: int, device: str = "cuda",
         source: str = "synthetic:0") -> dict:
    """Time every stage on the frames `arr` (uint8 [N, 3, H, W]; its whole
    GOPs of 4), `iters` iterations each; prints the JAX tool's line per
    stage, then one JSON line, which it returns."""
    from vcs_h264_tpu_torch.models.encoder import resolve_device
    dev = resolve_device(device)
    stages = build_stages(*clips.gop_batches(arr, 4, dev))
    return _timing.run_stages("profile_stages", stages, iters, dev, arr,
                              source, "{name:18s} {ms:7.2f} ms / {n} frames")


def cli(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", type=int, choices=sorted(FRAMES), default=360)
    clips.add_source_args(ap)
    args = ap.parse_args(argv)
    frames, source = clips.source_frames(args.video, args.synthetic,
                                         FRAMES[args.res])
    arr = clips.planar(frames)
    if args.res == 720:
        arr = clips.tiled(arr, 2)
    return main(arr, ITERS[args.res], args.device, source)


if __name__ == "__main__":
    cli()
