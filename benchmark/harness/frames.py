"""The source frames, made on the device from the seed.

A smooth random texture (a coarse grid of uniform values, upsampled
bicubically) panned by PAN pixels per frame; a rectangle of one colour
moving across it; and +-2 noise on every sample. The pool holds consecutive
frames, so the motion inside a run of them is real. It is made in a few
large calls with a generator on the device and brought to host memory
once, as BGR uint8 [N, H, W, 3].

The seed draws the texture, the rectangle's colour and the noise, which
are alike in what they cost the codec; the pan is the same for every seed,
because its speed changes the work (the share of static blocks, and the
nonzero coefficients by up to 40% between 1 and 3 pixels a frame).
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK = 16                      # frames made per call
PAN = (2, 3)                    # pixels a frame, down and right


def frame_pool(seed: int, n: int, h: int, w: int, device) -> np.ndarray:
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    vy, vx = PAN
    margin = max(abs(vy), abs(vx)) * n + 8
    ch, cw = h + 2 * margin, w + 2 * margin
    coarse = 255 * torch.rand((1, 3, ch // 16 + 2, cw // 16 + 2),
                              generator=g, device=device)
    tex = torch.nn.functional.interpolate(
        coarse, size=(ch, cw), mode="bicubic",
        align_corners=False)[0].clamp_(0, 255)
    color = torch.randint(0, 256, (3, 1, 1), generator=g,
                          device=device).to(torch.float32)
    rh, rw = max(2, h * 96 // 720), max(2, w * 160 // 1280)
    out = np.empty((n, h, w, 3), np.uint8)
    for s in range(0, n, CHUNK):
        ts = range(s, min(n, s + CHUNK))
        frames = []
        for t in ts:
            oy, ox = margin + vy * t, margin + vx * t
            f = tex[:, oy:oy + h, ox:ox + w].clone()
            ry = (h * 200 // 720 + 2 * t) % max(1, h - rh)
            rx = (w * 300 // 1280 + 5 * t) % max(1, w - rw)
            f[:, ry:ry + rh, rx:rx + rw] = color
            frames.append(f)
        f = torch.stack(frames)
        f += torch.randint(-2, 3, f.shape, generator=g, device=device)
        f = torch.round(f).clamp_(0, 255).to(torch.uint8)
        out[s:s + len(ts)] = f.permute(0, 2, 3, 1).cpu().numpy()
    return out
