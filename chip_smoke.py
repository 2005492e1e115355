#!/usr/bin/env python3
"""Smoke run of vcs_h264_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout: it builds the CUDA kernels from
`vcs_h264_tpu_torch/csrc/` with nvcc and imports nothing of JAX or of the JAX
package. Phases, each of which exits nonzero on failure:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     TF32 off for matmul and cuDNN;
  2. the kernel build, timed;
  3. every kernel of the main path against its plain PyTorch version on the
     card: first at small edge shapes (one block row, frames narrower than
     the search window, partial CTAs, one P-frame), then at 1280x720, 8 GOPs
     of 3 P-frames: K2 motion vectors identical;
     K3 coefficients within 1 on at most 1e-5 of them; K4 pixels within 1
     on at most 1e-4 of them; median times of kernel and plain version
     (CUDA events, after warm-up);
  4. the main path: a seeded synthetic 1280x720 clip of 34 frames (8 full
     IPPP GOPs at gop_batch 8 plus a tail GOP of I + 1 P) through
     Encoder(CodecConfig.production(), device="cuda").encode_frames ->
     save_npz -> load_npz -> Decoder(device="cuda").decode, with every
     kernel's launch count > 0 and the mean P-frame PSNR within 0.01 dB of
     the same pipeline on the plain versions (backend="plain") on the card;
     encode+decode fps of both paths as medians of three interleaved runs.

The last two lines of standard output are the kernels' JSON record and the
device record {"ok": true, "device": {...}}; without a CUDA device the script
exits nonzero before printing either.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

H, W = 720, 1280
GOPS, P_PER_GOP = 8, 3
CLIP_FRAMES = 34
PSNR_TOL_DB = 0.01


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def synthetic_clip(seed: int, n: int) -> list:
    """Smooth random texture panned by at most 3 px/frame, a moving
    rectangle, and +-2 noise: BGR uint8 [H, W, 3] frames."""
    import torch
    rng = np.random.default_rng(seed)
    margin = 3 * n + 8
    ch, cw = H + 2 * margin, W + 2 * margin
    coarse = rng.uniform(0, 255, (1, 3, ch // 16 + 2, cw // 16 + 2))
    tex = torch.nn.functional.interpolate(
        torch.from_numpy(coarse), size=(ch, cw), mode="bicubic",
        align_corners=False)[0].clamp(0, 255).permute(1, 2, 0).numpy()
    vy, vx = rng.choice([-3, -2, -1, 1, 2, 3], 2)
    color = rng.integers(0, 256, 3)
    frames = []
    for t in range(n):
        oy, ox = margin + vy * t, margin + vx * t
        f = tex[oy:oy + H, ox:ox + W].copy()
        ry, rx = 200 + 2 * t, 300 + 5 * t
        f[ry:ry + 96, rx:rx + 160] = color
        f += rng.integers(-2, 3, f.shape)
        frames.append(np.clip(np.rint(f), 0, 255).astype(np.uint8))
    return frames


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def edge_shape_phase() -> None:
    """Phase 3a: kernels vs plain versions at small shapes the 720p clip
    does not reach: one block row (no valid candidate row), frames narrower
    than 2*reach, block columns not a multiple of the 4 blocks a K3/K4 CTA
    holds, and one P-frame per GOP. Bound: identical vectors; coefficients
    and pixels within 1 on at most 2 values per shape (at 720p the
    differing fractions are ~1e-6, so a few thousand values see none)."""
    import torch
    from vcs_h264_tpu_torch.ops import inter_cuda, motion, motion_cuda

    rng = np.random.default_rng(2)
    for g, f, h, w in ((2, 3, 48, 72), (1, 2, 8, 64), (2, 1, 48, 24),
                       (1, 3, 40, 104)):
        refs = torch.from_numpy(
            rng.integers(0, 256, (g, 3, h, w), dtype=np.uint8)).cuda()
        curs = torch.roll(refs[:, None].expand(g, f, 3, h, w), (2, -3),
                          dims=(-2, -1)).contiguous()
        curs[:, -1] = torch.from_numpy(
            rng.integers(0, 256, (g, 3, h, w), dtype=np.uint8)).cuda()
        mv_k = motion_cuda.sad_search(curs, refs)
        mv_p = motion.motion_search_plain(curs, refs)
        if not torch.equal(mv_k, mv_p):
            fail(f"K2 vectors differ from the plain search at {(g, f, h, w)}")
        mv_r = torch.from_numpy(
            rng.integers(-16, 17, mv_p.shape, dtype=np.int32)).cuda()
        worst = []
        for mv in (mv_p, mv_r):
            co = inter_cuda.encode_p_coeffs_plain(mv, refs, curs, 50.0)
            pairs = ((inter_cuda.fused_p_encode(mv, refs, curs, 50.0), co),
                     (inter_cuda.fused_p_decode(mv, refs, co, 50.0),
                      inter_cuda.decode_p_frames_plain(mv, refs, co, 50.0)))
            for got, want in pairs:
                d = (got.to(torch.int32) - want.to(torch.int32)).abs()
                worst.append((int(d.max()), int((d != 0).sum())))
                if worst[-1][0] > 1 or worst[-1][1] > 2:
                    fail(f"K3/K4 outside the bound at {(g, f, h, w)}: "
                         f"{worst[-1]}")
        print(f"[edge {g}x{f}x{h}x{w}] K2 vectors identical; K3/K4 "
              f"(max |diff|, count) searched/random: {worst}")


def kernel_phase(frames, card: str):
    """Phase 3: kernels vs plain versions at the main path's shapes."""
    import torch
    from vcs_h264_tpu_torch import CodecConfig
    from vcs_h264_tpu_torch.ops import inter_cuda, motion, motion_cuda

    cfg = CodecConfig.production()
    qf = cfg.quality_factor
    search = dict(bs=cfg.block_size, reach=cfg.search_reach,
                  step=cfg.search_step,
                  static_threshold=cfg.static_threshold)
    gop_len = P_PER_GOP + 1
    clip = torch.from_numpy(np.stack(frames[:GOPS * gop_len])).cuda()
    clip = clip.permute(0, 3, 1, 2).reshape(GOPS, gop_len, 3, H, W)
    refs = clip[:, 0].contiguous()
    curs = clip[:, 1:].contiguous()
    results = {}

    mv_k = motion_cuda.sad_search(curs, refs, **search)
    mv_p = motion.motion_search_plain(curs, refs, **search)
    torch.cuda.synchronize()
    n_bad = int((mv_k != mv_p).any(dim=-1).sum())
    err = int((mv_k - mv_p).abs().max())
    print(f"[K2 sad_search] {n_bad} of {mv_p[..., 0].numel()} vectors differ "
          f"from the plain search (max |diff| {err}); nonzero vectors "
          f"{float((mv_p != 0).any(-1).float().mean()):.4f}")
    if n_bad:
        fail("K2 motion vectors differ from the plain version")
    results["sad_search"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: motion_cuda.sad_search(curs, refs, **search), 20),
        plain_ms=time_ms(lambda: motion.motion_search_plain(curs, refs,
                                                             **search), 5))

    # K3/K4 on the searched vectors and on random in-reach vectors (the
    # latter exercise the source clamp at the frame edges)
    rng = np.random.default_rng(1)
    mv_rand = torch.from_numpy(rng.integers(
        -cfg.search_reach, cfg.search_reach + 1, mv_p.shape,
        dtype=np.int32)).cuda()
    enc_err = dec_err = 0
    for name, mv in (("searched", mv_p), ("random", mv_rand)):
        co_k = inter_cuda.fused_p_encode(mv, refs, curs, qf)
        co_p = inter_cuda.encode_p_coeffs_plain(mv, refs, curs, qf)
        d = (co_k.to(torch.int32) - co_p.to(torch.int32)).abs()
        e_max, e_frac = int(d.max()), float((d != 0).float().mean())
        dec_k = inter_cuda.fused_p_decode(mv, refs, co_p, qf)
        dec_p = inter_cuda.decode_p_frames_plain(mv, refs, co_p, qf)
        d = (dec_k.to(torch.int32) - dec_p.to(torch.int32)).abs()
        p_max, p_frac = int(d.max()), float((d != 0).float().mean())
        print(f"[K3 fused_p_encode, {name} mv] max |diff| {e_max}, "
              f"differing fraction {e_frac:.3e} (limit 1, 1e-5)")
        print(f"[K4 fused_p_decode, {name} mv] max |diff| {p_max}, "
              f"differing fraction {p_frac:.3e} (limit 1, 1e-4)")
        if e_max > 1 or e_frac > 1e-5:
            fail(f"K3 coefficients outside the bound ({name} mv)")
        if p_max > 1 or p_frac > 1e-4:
            fail(f"K4 pixels outside the bound ({name} mv)")
        enc_err, dec_err = max(enc_err, e_max), max(dec_err, p_max)

    co = inter_cuda.encode_p_coeffs_plain(mv_p, refs, curs, qf)
    results["fused_p_encode"] = dict(
        max_abs_err=enc_err,
        ms=time_ms(lambda: inter_cuda.fused_p_encode(mv_p, refs, curs, qf), 20),
        plain_ms=time_ms(lambda: inter_cuda.encode_p_coeffs_plain(
            mv_p, refs, curs, qf), 10))
    results["fused_p_decode"] = dict(
        max_abs_err=dec_err,
        ms=time_ms(lambda: inter_cuda.fused_p_decode(mv_p, refs, co, qf), 20),
        plain_ms=time_ms(lambda: inter_cuda.decode_p_frames_plain(
            mv_p, refs, co, qf), 10))
    for name, r in results.items():
        print(f"[time {name}] kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, at G={GOPS} F={P_PER_GOP} {W}x{H} "
              f"({card})")
    return results


def run_codec(frames, backend: str):
    """Encode -> .npz -> decode through the user entry points; returns
    (decoded frames, encoded video, encode s, decode s)."""
    import torch
    from vcs_h264_tpu_torch import CodecConfig
    from vcs_h264_tpu_torch.models import Decoder, EncodedVideo, Encoder

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    video = Encoder(CodecConfig.production(), device="cuda",
                    backend=backend).encode_frames(frames)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stream.npz")
        video.save_npz(path)
        loaded = EncodedVideo.load_npz(path)
    for a, b in zip(video.gops, loaded.gops):
        if not (torch.equal(a.mv.cpu(), b.mv)
                and (a.residuals is None) == (b.residuals is None)
                and (a.residuals is None
                     or torch.equal(a.residuals.cpu(), b.residuals))):
            fail(".npz roundtrip changed the stream")
    t0 = time.perf_counter()
    decoded = Decoder(device="cuda", backend=backend).decode(loaded)
    t_dec = time.perf_counter() - t0
    return decoded, video, t_enc, t_dec


def main_path_phase(frames, card: str):
    """Phase 4: the port's user entry points, kernels vs plain versions."""
    from vcs_h264_tpu_torch.ops import inter_cuda, motion_cuda
    from vcs_h264_tpu_torch.utils.metrics import psnr

    counters = (motion_cuda.LAUNCHES, inter_cuda.LAUNCHES)
    run_codec(frames, "auto")           # warm-up: allocator, cuBLAS, shapes
    run_codec(frames, "plain")
    for c in counters:
        for k in c:
            c[k] = 0
    decoded, video, t_enc, t_dec = run_codec(frames, "auto")
    launches = {k: v for c in counters for k, v in c.items()}
    print(f"[main path] kernel launches {launches}")
    if any(v == 0 for v in launches.values()):
        fail("a kernel of the main path was never launched")
    dec_plain, video_plain, tp_enc, tp_dec = run_codec(frames, "plain")
    # two more runs of each path, interleaved, for medians of three
    times = {"auto": [(t_enc, t_dec)], "plain": [(tp_enc, tp_dec)]}
    for backend in ("plain", "auto", "auto", "plain"):
        times[backend].append(run_codec(frames, backend)[2:])

    gop_len = 4
    if len(decoded) != len(frames) or decoded[0].shape != (H, W, 3):
        fail(f"decoded {len(decoded)} frames of {decoded[0].shape}")
    p_idx = [i for i in range(len(frames)) if i % gop_len]
    psnr_k = float(np.mean([psnr(decoded[i], frames[i]) for i in p_idx]))
    psnr_p = float(np.mean([psnr(dec_plain[i], frames[i]) for i in p_idx]))
    mvs = np.concatenate([g.mv.cpu().numpy().reshape(-1, 2)
                          for g in video.gops])
    mvs_plain = np.concatenate([g.mv.cpu().numpy().reshape(-1, 2)
                                for g in video_plain.gops])
    static = float(np.mean(np.all(mvs == 0, axis=-1)))
    pix_diff = max(int(np.abs(a.astype(np.int32) - b).max())
                   for a, b in zip(decoded, dec_plain))
    print(f"[main path] {len(frames)} frames {W}x{H}, {len(video.gops)} "
          f"GOPs; P-frame PSNR kernels {psnr_k:.4f} dB, plain {psnr_p:.4f} "
          f"dB; static-block ratio {static:.4f}; MVs identical to plain "
          f"{np.array_equal(mvs, mvs_plain)}; max decoded pixel diff "
          f"{pix_diff}")
    for backend, label in (("auto", "kernels"), ("plain", "plain")):
        runs = times[backend]
        fps = [len(frames) / (e + d) for e, d in runs]
        print(f"[main path] encode+decode fps, {label}: median "
              f"{float(np.median(fps)):.2f} of runs "
              f"{[round(x, 2) for x in fps]}; encode s "
              f"{[round(e, 4) for e, _ in runs]}, decode s "
              f"{[round(d, 4) for _, d in runs]} ({card})")
    if not np.isfinite(psnr_k) or psnr_k < 30.0:
        fail(f"P-frame PSNR {psnr_k} dB is implausible for QF 50")
    if abs(psnr_k - psnr_p) > PSNR_TOL_DB:
        fail(f"kernel PSNR {psnr_k} vs plain {psnr_p} dB differ by more "
             f"than {PSNR_TOL_DB}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from vcs_h264_tpu_torch.ops import _build

    # phase 1: the card
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[build] {time.perf_counter() - t0:.2f} s "
          f"({'nvcc' if _build.build_seconds is not None else 'cached'}) -> "
          f"{_build.library_path().name}")

    edge_shape_phase()
    frames = synthetic_clip(args.seed, CLIP_FRAMES)
    kernels = kernel_phase(frames, card)
    launches = main_path_phase(frames, card)

    meta = {
        "sad_search": ("vcs_h264_tpu_torch/csrc/motion_sad.cu",
                       "vcs_h264_tpu/ops/motion_pallas.py:80"),
        "fused_p_encode": ("vcs_h264_tpu_torch/csrc/inter_fused.cu",
                           "vcs_h264_tpu/ops/inter_pallas.py:387"),
        "fused_p_decode": ("vcs_h264_tpu_torch/csrc/inter_fused.cu",
                           "vcs_h264_tpu/ops/inter_pallas.py:413"),
    }
    record = [dict(name=name, route="cuda", source=src, replaces=rep,
                   launches=launches[name], **kernels[name])
              for name, (src, rep) in meta.items()]
    print(card)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
