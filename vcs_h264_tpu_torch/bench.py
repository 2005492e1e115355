"""Benchmark: end-to-end encode+decode throughput of the port on one GPU
(counterpart of the root `bench.py`, which times the JAX package).

Prints JSON lines of the form
  {"metric": ..., "value": N, "unit": "fps", "vs_baseline": N, ...extras}
progressively refined, with the keys of `bench.py` in its order and one
more, "source": a placeholder before the device is touched, a provisional
line from one synchronous step, then the headline and each extra as it
lands. The LAST printed line is the most complete.

Source: 64 frames of 640x360, the seeded synthetic clip of `tools/clips.py`
(seed 0 by default) or `--video PATH` read through cv2. `bench.py` reads
slow_traffic_small.mp4, which this repo does not hold, so the two benches
do not time the same content. The frames go to the device once, as uint8.

Headline (`encode_decode_fps_640x360`, `CodecConfig()`, 16 GOPs of 4):
N_ITERS iterations of encode -> decode, each on the P-frames rolled by
`it & 7` px along the width, each adding the sum of its vectors and decoded
frames into one device scalar. The iterations are queued with no host sync
and the scalar is read once at the end: the eager counterpart of
`bench.py`'s single `fori_loop` dispatch, with the Python launch cost of
every iteration inside the window. One warm run, then N_REPEAT timed runs;
the median. The provisional line times one synchronous step and carries
the PSNR (I-frames, raw in this mode, count as 99 dB).

Extras, each a loop of the same kind, run while BENCH_BUDGET_S (default
900 s, from the start of `run`) allows, each timed once after one warm run:
  * production_fps_640x360: `CodecConfig.production(intra_qstep=24)`, the
    loop of lossy intra encode -> inter encode -> decode and the loop of
    intra decodes, fps over the sum of the two windows (`bench.py` splits
    them to dodge a TPU compile crash; its key is defined by that sum);
  * encode_decode_fps_1280x720: the same on 32 frames tiled 2x2;
  * chroma420_fps_640x352: the 4:2:0 mode on the first 352 rows;
  * production_fps_1920x1080: the same as 720p on 16 frames tiled 3x3;
  * *_lumasearch: the 720p and 1080p keys with `search_luma_only`.

Baseline denominator: `end_to_end_fps` of `BASELINE_MEASURED.json` (the
Python reference on one CPU core, on the real video), read, not written.

`keys()` builds what each key times, in that order and under that budget;
`run` times it and `chip_smoke.py` checks the same steps on the card.

Run:  python -m vcs_h264_tpu_torch.bench [--video PATH | --synthetic SEED]
          [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import NamedTuple

import numpy as np
import torch

from vcs_h264_tpu_torch.config import CodecConfig
from vcs_h264_tpu_torch.models import intra_codec, pipeline, pipeline420
from vcs_h264_tpu_torch.models.encoder import resolve_device
from vcs_h264_tpu_torch.tools import clips

BASE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "BASELINE_MEASURED.json")
N_FRAMES = 64          # frames resident on the device (16 GOPs)
N_ITERS = 32           # headline loop iterations
N_REPEAT = 3           # timed headline runs; report the median
BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "900"))
QSTEP = 24             # production lossy-intra step
# loop iterations of each extra (its _lumasearch key takes the same)
EXTRA_ITERS = {"production_fps_640x360": 8, "encode_decode_fps_1280x720": 4,
               "chroma420_fps_640x352": 8, "production_fps_1920x1080": 4}
C420_ROWS = 352        # the 4:2:0 key's crop: a multiple of 2 * block size
# the 4:2:0 key's mode: lossy intra, luma search, chroma on halved vectors
C420 = CodecConfig(quant_mode="rounded", chroma_420=True, intra_i=True,
                   intra_qstep=QSTEP)


def now() -> float:
    return time.perf_counter()


def emit(result: dict) -> None:
    print(json.dumps(result), flush=True)


def sink(*tensors) -> torch.Tensor:
    """The device scalar a step adds to its loop's total: the sum of its
    outputs (int64; `bench.py`'s wraps in int32), so that none of the work
    is left unused."""
    return sum(t.sum(dtype=torch.int64) for t in tensors)


def roll(x: torch.Tensor, it: int) -> torch.Tensor:
    return torch.roll(x, it & 7, -1)


def encode_decode(i_frames, p_frames, cfg, backend="auto"):
    enc = pipeline.encode_gop_batch(i_frames, p_frames, cfg, backend)
    return enc, pipeline.decode_gop_batch(enc, cfg, backend)


def psnr_step(i_b, p_b, cfg, backend="auto") -> tuple:
    """One encode -> decode -> (per P-frame MSE [B, P] in float32, sink)."""
    enc, dec = encode_decode(i_b, p_b, cfg, backend)
    err = dec[:, 1:].float() - p_b.float()
    return (err * err).mean(dim=(2, 3, 4)), sink(enc.mv, dec)


def psnr_capped99(mse: np.ndarray, n_i: int) -> float:
    """Mean PSNR of the P-frames of `mse` and `n_i` I-frames, each frame's
    PSNR capped at 99 dB (a lossless frame's is infinite)."""
    mse = mse.ravel()
    p_psnr = np.where(mse > 0,
                      10 * np.log10(255.0 ** 2 / np.maximum(mse, 1e-12)),
                      np.inf)
    per_frame = np.concatenate([np.full(n_i, np.inf), p_psnr])
    return float(np.mean(np.minimum(per_frame, 99.0)))


# Each step below is fn(it, backend="auto") -> (its outputs, its sink);
# `backend` as in `models/pipeline.py` ("plain": the kernels' plain
# versions, which `chip_smoke.py` holds the kernels against).

def headline_step(i_b, p_b, cfg):
    def step(it, backend="auto"):
        enc, dec = encode_decode(i_b, roll(p_b, it), cfg, backend)
        return (enc, dec), sink(enc.mv, dec)
    return step


def production_steps(i_b, p_b, luma_search: bool = False) -> dict:
    """-> {"loop_enc", "loop_dec"}: lossy intra encode of the rolled
    I-frames, inter encode of the rolled P-frames against their
    reconstruction, decode; and the intra decode of the unrolled I-frames'
    payload with its coefficients rolled."""
    pcfg = CodecConfig.production(intra_qstep=QSTEP,
                                  search_luma_only=luma_search)

    def loop_enc(it, backend="auto"):
        payload, i_rec = intra_codec.encode_intra_frames_lossy_batch(
            roll(i_b, it), QSTEP, backend)
        enc, dec = encode_decode(i_rec, roll(p_b, it), pcfg, backend)
        return (payload, i_rec, enc, dec), sink(enc.mv, dec, payload.qcoef)

    payload, _ = intra_codec.encode_intra_frames_lossy_batch(i_b, QSTEP)

    def loop_dec(it, backend="auto"):
        i_dec = intra_codec.decode_intra_frames_lossy_batch(
            intra_codec.IntraFrameLossy(roll(payload.qcoef, it),
                                        payload.modes, payload.escape),
            QSTEP, backend)
        return i_dec, sink(i_dec)

    return {"loop_enc": loop_enc, "loop_dec": loop_dec}


def chroma420_step(i_b, p_b):
    """The 4:2:0 mode (C420) on the first C420_ROWS rows."""
    i_c, p_c = i_b[..., :C420_ROWS, :], p_b[..., :C420_ROWS, :]

    def step(it, backend="auto"):
        enc = pipeline420.encode_gop_batch_420(roll(i_c, it), roll(p_c, it),
                                               C420, backend)
        dec = pipeline420.decode_gop_batch_420(enc, C420, backend=backend)
        return (enc, dec), sink(dec, enc.mv)
    return step


# the kernels each step launches, by launch counter (`ops/*_cuda.py`
# LAUNCHES): reference mode K2 and K1 (compensation in encode and decode);
# production K5, K2, K3, K4, and K6 in its intra decode loop; 4:2:0 K5 (Y
# and chroma), K2 at C = 1, the bare-plane K3/K4 and K7
EXPECTED_KERNELS = {
    "psnr_step": {"sad_search", "compensate"},
    "headline": {"sad_search", "compensate"},
    "loop_enc": {"intra_encode", "sad_search", "fused_p_encode",
                 "fused_p_decode"},
    "loop_dec": {"intra_decode"},
    "loop_420": {"intra_encode", "sad_search", "plane_encode",
                 "plane_decode", "c420_encode", "c420_decode"},
}


class Key(NamedTuple):
    """What one key of the lines times: its loops ({name: step}), each
    timed over `n_iters` iterations; the key's fps is n_iters * frames
    over the sum of their windows."""
    name: str
    loops: dict
    n_iters: int
    frames: int          # frames one iteration codes


def keys(arr: np.ndarray, device, left=lambda: math.inf):
    """Every key the bench times, in `bench.py`'s order, each built when it
    is reached: the provisional line's step, the headline, then each extra
    while the budget `left()` (seconds) is above `bench.py`'s thresholds,
    45 s and 120 s before 1080p. The frames of each resolution go to the
    device once, as uint8, and are dropped when its keys are done."""
    cfg = CodecConfig()          # reference operating point: bs=8 IPPP QF=50
    g = cfg.gop_len
    i_b, p_b = clips.gop_batches(arr, g, device)
    n = i_b.shape[0] * g
    yield Key("provisional", {"psnr_step": lambda it, backend="auto":
                              psnr_step(i_b, p_b, cfg, backend)}, 1, n)
    yield Key("encode_decode_fps_640x360",
              {"headline": headline_step(i_b, p_b, cfg)}, N_ITERS, n)
    if left() <= 45:
        return
    yield Key("production_fps_640x360", production_steps(i_b, p_b),
              EXTRA_ITERS["production_fps_640x360"], n)
    if left() <= 45:
        return
    # the north-star operating point: the first 32 frames tiled 2x2
    i7, p7 = clips.gop_batches(clips.tiled(arr[:32], 2), g, device)
    for luma in (False, True):
        if luma and left() <= 45:
            return
        yield Key("encode_decode_fps_1280x720" + "_lumasearch" * luma,
                  production_steps(i7, p7, luma),
                  EXTRA_ITERS["encode_decode_fps_1280x720"], i7.shape[0] * g)
    del i7, p7
    if left() <= 45:
        return
    yield Key("chroma420_fps_640x352", {"loop_420": chroma420_step(i_b, p_b)},
              EXTRA_ITERS["chroma420_fps_640x352"], n)
    del i_b, p_b                 # the 640x360 frames, before 1080p
    if left() <= 120:
        return
    # 1080p production: the first 16 frames tiled 3x3, cropped
    i9, p9 = clips.gop_batches(clips.tiled(arr[:16], 3), g, device)
    for luma in (False, True):
        if luma and left() <= 45:
            return
        yield Key("production_fps_1920x1080" + "_lumasearch" * luma,
                  production_steps(i9, p9, luma),
                  EXTRA_ITERS["production_fps_1920x1080"], i9.shape[0] * g)


def fused_loop(step, n_iters: int, device) -> int:
    """`n_iters` steps queued with no host sync, their sinks added into one
    device scalar, which is read once at the end (the one sync)."""
    total = torch.zeros((), dtype=torch.int64, device=device)
    for it in range(n_iters):
        total += step(it)[1]
    return int(total)


def timed(step, n_iters: int, device) -> float:
    """Seconds of one loop after one warm loop."""
    fused_loop(step, n_iters, device)
    t0 = now()
    fused_loop(step, n_iters, device)
    return now() - t0


def load_baseline() -> tuple:
    """-> (end_to_end_fps, mean_psnr_capped99_db) of the measured Python
    reference, or (None, None) without the file."""
    if not os.path.exists(BASE):
        return None, None
    with open(BASE) as fh:
        base = json.load(fh)
    return base.get("end_to_end_fps"), base.get("mean_psnr_capped99_db")


def run(arr: np.ndarray, device: str = "cuda", *, source: str) -> dict:
    """The bench on the frames `arr` (uint8 [N, 3, H, W], 640x360 in the
    bench proper), whose origin `source` names; prints its lines and
    returns the last."""
    t_start = time.monotonic()

    def left():
        return BUDGET_S - (time.monotonic() - t_start)

    dev = resolve_device(device)
    base_fps, base_psnr = load_baseline()
    emit({"metric": "encode_decode_fps_640x360", "value": 0, "unit": "fps",
          "vs_baseline": 0, "provisional": True,
          "note": "pre-device placeholder; later lines override",
          "source": source})
    todo = keys(arr, dev, left)

    # ---- provisional: one synchronous step --------------------------------
    key = next(todo)
    step = key.loops["psnr_step"]
    mse = step(0)[0].cpu().numpy()
    t0 = now()
    int(step(0)[1])
    dt1 = now() - t0
    result = {
        "metric": "encode_decode_fps_640x360",
        "value": round(key.frames / dt1, 1),
        "unit": "fps",
        "vs_baseline": (round(key.frames / dt1 / base_fps, 1) if base_fps
                        else None),
        "psnr_capped99_db": round(psnr_capped99(mse, len(mse)), 2),
        "provisional": True,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "baseline_fps": base_fps,
        "baseline_psnr_capped99_db": base_psnr,
        "source": source,
    }
    emit(result)
    result.pop("provisional")

    # ---- headline: N_ITERS steps queued with no host sync ------------------
    key = next(todo)
    step = key.loops["headline"]
    fused_loop(step, key.n_iters, dev)                   # warm-up
    runs = []
    for _rep in range(N_REPEAT):
        t0 = now()
        fused_loop(step, key.n_iters, dev)
        runs.append(now() - t0)
        if left() < 120:
            break
    dt = sorted(runs)[len(runs) // 2]                    # median
    fps = key.n_iters * key.frames / dt
    result.update(value=round(fps, 1),
                  vs_baseline=round(fps / base_fps, 1) if base_fps else None,
                  frames=key.n_iters * key.frames, seconds=round(dt, 3),
                  runs_s=[round(r, 3) for r in runs])
    emit(result)
    del key, step

    # ---- extras: production mode, 720p, 4:2:0, 1080p, while budget allows --
    try:
        for key in todo:
            dt = sum(timed(step, key.n_iters, dev)
                     for step in key.loops.values())
            result[key.name] = round(key.n_iters * key.frames / dt, 1)
            emit(result)
            del key          # its frames go before the next key's are made
    except Exception as e:                               # extras must never
        traceback.print_exc()                            # kill the headline
        result["extras_error"] = repr(e)
        emit(result)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    clips.add_source_args(ap)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    try:
        frames, source = clips.source_frames(args.video, args.synthetic,
                                             N_FRAMES)
    except (OSError, ValueError):
        traceback.print_exc()
        emit({"metric": "encode_decode_fps", "value": 0, "unit": "fps",
              "vs_baseline": 0, "error": "video unavailable",
              "source": args.video})
        return 1
    run(clips.planar(frames), args.device, source=source)
    return 0


if __name__ == "__main__":
    sys.exit(main())
