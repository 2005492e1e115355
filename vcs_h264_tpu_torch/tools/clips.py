"""Frame sources of the measurement tools.

The JAX package's tools read a 640x360 video and tile it to 1280x720 or
1920x1080. Here the 640x360 source is either a video file (`read_video`,
cv2 imported inside) or the seeded synthetic clip (`synthetic_clip`, which
`chip_smoke.py` drives at 1280x720 as well); the caller picks one. Tiling
repeats content across the frame, as the JAX tools' tiling does, which
matters for the search's static skip.
"""

from __future__ import annotations

import numpy as np
import torch


def synthetic_clip(seed: int, n: int, h: int = 720, w: int = 1280) -> list:
    """Smooth random texture panned by at most 3 px/frame, a moving
    rectangle, and +-2 noise: BGR uint8 [h, w, 3] frames."""
    rng = np.random.default_rng(seed)
    margin = 3 * n + 8
    ch, cw = h + 2 * margin, w + 2 * margin
    coarse = rng.uniform(0, 255, (1, 3, ch // 16 + 2, cw // 16 + 2))
    tex = torch.nn.functional.interpolate(
        torch.from_numpy(coarse), size=(ch, cw), mode="bicubic",
        align_corners=False)[0].clamp(0, 255).permute(1, 2, 0).numpy()
    vy, vx = rng.choice([-3, -2, -1, 1, 2, 3], 2)
    color = rng.integers(0, 256, 3)
    frames = []
    for t in range(n):
        oy, ox = margin + vy * t, margin + vx * t
        f = tex[oy:oy + h, ox:ox + w].copy()
        ry, rx = 200 + 2 * t, 300 + 5 * t
        f[ry:ry + 96, rx:rx + 160] = color
        f += rng.integers(-2, 3, f.shape)
        frames.append(np.clip(np.rint(f), 0, 255).astype(np.uint8))
    return frames


class ClipReader:
    """Frames in memory as a reader: any iterable of frames with an `fps`,
    which `Encoder.encode_stream` takes; it can be iterated again."""
    fps = 25.0

    def __init__(self, frames):
        self.frames = frames

    def __iter__(self):
        return iter(self.frames)


def read_video(path: str, n: int) -> list:
    """Up to n BGR uint8 frames of a video file, as the JAX tools read
    theirs (cv2.VideoCapture, first frames first)."""
    import cv2
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {path}")
    frames = []
    while len(frames) < n:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    if not frames:
        raise ValueError(f"no frames in {path}")
    return frames


def source_frames(video, seed: int, n: int) -> tuple:
    """The tools' 640x360 source: n frames of `video` if a path is given,
    else `synthetic_clip(seed, n, 360, 640)` -> (frames, its name)."""
    if video:
        return read_video(video, n), video
    return synthetic_clip(seed, n, 360, 640), f"synthetic:{seed}"


def add_source_args(ap) -> None:
    """The tools' flags for their source and device: --video PATH or
    --synthetic SEED (default 0), --device cuda|cpu (default cuda)."""
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--video", help="a 640x360 video file (needs cv2)")
    src.add_argument("--synthetic", type=int, default=0, metavar="SEED",
                     help="the seeded synthetic clip (default: seed 0)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")


def tiled(arr: np.ndarray, k: int) -> np.ndarray:
    """[N, 3, h, w] -> the frames tiled k x k, as `tools/exp_720_stages.py`
    tiles them; at k = 3 cropped to 1920x1080 as `bench.py`'s 1080p point
    is (a no-op for a 640x360 source)."""
    out = np.tile(arr, (1, 1, k, k))
    return out[..., :1080, :1920] if k == 3 else out


def planar(frames) -> np.ndarray:
    """BGR frames [h, w, 3] -> one uint8 array [N, 3, h, w]."""
    return np.ascontiguousarray(np.stack(frames).transpose(0, 3, 1, 2))


def gop_batches(arr: np.ndarray, gop_len: int, device) -> tuple:
    """[N, 3, H, W] -> (I-frames [B, 3, H, W], the other frames
    [B, gop_len - 1, 3, H, W]) of the N // gop_len whole GOPs, uint8 on
    `device`."""
    b = len(arr) // gop_len
    if b == 0:
        raise ValueError(f"{len(arr)} frames hold no GOP of {gop_len}")
    whole = torch.from_numpy(arr[:b * gop_len]).to(device)
    whole = whole.reshape(b, gop_len, *arr.shape[1:])
    return whole[:, 0].contiguous(), whole[:, 1:].contiguous()
