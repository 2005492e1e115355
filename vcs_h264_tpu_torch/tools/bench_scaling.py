"""Scaling harness for the sharded pipeline (counterpart of
`tools/bench_scaling.py`).

Times the sharded encoder of `parallel/spatial.py`, `CodecConfig(with_dct=
True)` on 8 GOPs x 4 frames of 640x384 random frames, on each mesh of the
JAX tool's list. Mesh position i is `cuda:(i % device_count)`: on a host
with enough GPUs every position has its own card, and on one card every
position is `cuda:0`, where the run checks the program's structure (the
halo copies, the strips, one launch per tile) and does not measure
scaling. With `--device cpu` every position is the CPU, which runs the
plain versions of the kernels: a structural run too.

Run:  python -m vcs_h264_tpu_torch.tools.bench_scaling [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

MESHES = ((1, 1), (2, 1), (4, 1), (8, 1), (1, 2), (1, 4), (2, 4), (4, 2))


def _sync(device: str) -> None:
    if device == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def main(shape=(8, 3, 384, 640), device: str = "cuda") -> dict:
    """Time each mesh of MESHES on frames of `shape` = (GOPs, P-frames per
    GOP, H, W); prints the JAX tool's JSON (with the device it ran on) and
    returns it."""
    from vcs_h264_tpu_torch.config import CodecConfig
    from vcs_h264_tpu_torch.parallel.mesh import make_mesh
    from vcs_h264_tpu_torch.parallel.spatial import make_sharded_encoder

    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device (pass --device cpu for a "
                               "structural run on the CPU)")
        n_cards = torch.cuda.device_count()
        positions = [torch.device("cuda", i % n_cards) for i in range(8)]
        kind = f"{torch.cuda.get_device_name(0)} x{n_cards}"
    else:
        n_cards = 0
        positions = [torch.device("cpu")] * 8
        kind = "cpu"
    cfg = CodecConfig(with_dct=True)
    rng = np.random.default_rng(0)
    b, p, h, w = shape
    i_b = torch.from_numpy(rng.integers(0, 256, (b, 3, h, w), np.uint8))
    p_b = torch.from_numpy(rng.integers(0, 256, (b, p, 3, h, w), np.uint8))
    i_b, p_b = i_b.to(positions[0]), p_b.to(positions[0])

    results = {}
    for gop, tile in MESHES:
        n_dev = gop * tile
        mesh = make_mesh(gop=gop, tile=tile, devices=positions[:n_dev])
        enc = make_sharded_encoder(mesh, cfg, h, w)
        enc(i_b, p_b)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(3):
            enc(i_b, p_b)
        _sync(device)
        dt = (time.perf_counter() - t0) / 3
        fps = b * (p + 1) / dt
        results[f"gop{gop}x tile{tile}"] = {
            "devices": n_dev, "ms": round(dt * 1e3, 1), "fps": round(fps, 1)}

    base = results.get("gop1x tile1", {}).get("fps")
    for v in results.values():
        if base:
            v["speedup"] = round(v["fps"] / base, 2)
            v["efficiency"] = round(v["fps"] / base / v["devices"], 2)
    if n_cards >= 8:
        note = "one card per mesh position"
    elif n_cards:
        note = (f"{n_cards} card(s) shared by up to 8 mesh positions: "
                "structural validation, not a scaling measurement")
    else:
        note = ("CPU mesh (plain versions of the kernels): structural "
                "validation, not a scaling measurement")
    out = {"note": note, "device": kind,
           "shape": f"{b} GOPs x {p + 1} frames {w}x{h}", "results": results}
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(device=ap.parse_args().device)
