"""The one traffic generator: a mix's parameters (a JSON file under
`benchmark/traffic/`) and the configuration's GOP shape -> the length of
every segment and the seeded offsets of its frames in the pool. One client
drives every mix in a closed loop: it sends its next segment when the last
has come back.

A mix file holds:
  segment            {"unit": "gop" or "gop_batch", "min_video_seconds": s}:
                     a segment is the fewest whole units that hold s seconds
                     of video at VIDEO_FPS (at least one unit)
  check_segments     segments of the window sampled, from the seed, for the
                     comparison with the reference
  check_gops_per_segment
                     GOPs of each sampled segment compared (all of them
                     where the segment has no more)
"""

from __future__ import annotations

import math

import numpy as np

# the seed's independent streams: the window's offsets, the warm-up's, the
# sampled segments, the profiled segments', the sampled GOPs of a segment
WINDOW, WARMUP, SAMPLE, PROFILE, GOPS = 1, 2, 3, 4, 5

VIDEO_FPS = 25              # frames per second of the source video
POOL_FRAMES = 192           # consecutive frames made from the seed, from
#                             which each segment is taken at a seeded offset
TRACE_MIN_SECONDS = 1.0     # the least length of a traced run's profiled
#                             sub-window, in whole segments


def check_mix(mix: dict) -> None:
    if mix["segment"]["unit"] not in ("gop", "gop_batch"):
        raise ValueError(f"unknown segment unit {mix['segment']['unit']!r}")


def segment_frames(mix: dict, gop_len: int, gop_batch: int) -> int:
    """Frames of every segment: whole GOPs, so each starts with an
    I-frame."""
    unit = gop_len * (gop_batch if mix["segment"]["unit"] == "gop_batch"
                      else 1)
    want = mix["segment"]["min_video_seconds"] * VIDEO_FPS
    return unit * max(1, math.ceil(want / unit))


def offsets(seed: int, stream: int, pool: int, seg: int):
    """Endless seeded offsets of segments in a pool of `pool` frames."""
    if seg > pool:
        raise ValueError(f"a segment of {seg} frames does not fit a pool of "
                         f"{pool}")
    rng = np.random.default_rng([seed, stream])
    while True:
        yield int(rng.integers(0, pool - seg + 1))
