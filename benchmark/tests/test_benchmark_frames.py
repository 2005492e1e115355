"""The frame generator: the same seed gives the same pool, another seed
another one, and consecutive frames hold real motion."""

import numpy as np
import pytest

from benchmark.harness import frames, traffic


@pytest.mark.parametrize("seed", [0, 2**31 + 3, 2**40 + 1])
def test_pool_repeats_for_a_seed(seed):
    a = frames.frame_pool(seed, 20, 32, 48, "cpu")
    b = frames.frame_pool(seed, 20, 32, 48, "cpu")
    assert a.shape == (20, 32, 48, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b)


def test_pool_differs_across_seeds():
    a = frames.frame_pool(1, 8, 32, 48, "cpu")
    b = frames.frame_pool(2, 8, 32, 48, "cpu")
    assert np.count_nonzero(a != b) > a.size // 2


def test_consecutive_frames_move():
    p = frames.frame_pool(5, 6, 64, 96, "cpu").astype(np.int32)
    still = np.abs(p[1:] - p[:-1]).mean()
    assert still > 2.0          # more than the +-2 noise: the texture pans


@pytest.mark.parametrize("mix, gop_len, want", [
    ({"segment": {"unit": "gop", "min_video_seconds": 0}}, 4, 4),
    ({"segment": {"unit": "gop", "min_video_seconds": 0}}, 7, 7),
    ({"segment": {"unit": "gop_batch", "min_video_seconds": 2.0}}, 4, 64),
    ({"segment": {"unit": "gop_batch", "min_video_seconds": 2.0}}, 7, 56),
])
def test_segment_lengths(mix, gop_len, want):
    assert traffic.segment_frames(mix, gop_len, 8) == want


def test_offsets_repeat_and_fit():
    a = traffic.offsets(2**31 + 9, traffic.WINDOW, 80, 56)
    b = traffic.offsets(2**31 + 9, traffic.WINDOW, 80, 56)
    xs = [next(a) for _ in range(50)]
    assert xs == [next(b) for _ in range(50)]
    assert all(0 <= x <= 80 - 56 for x in xs) and len(set(xs)) > 5
