"""The comparison's control: the reference computed in bfloat16, the
precision below the configurations' float32, put in the program's place,
fails the comparison (limit 0) on every seed tried, in both
configurations; the float32 reference against itself passes. On a card,
the same at the cells' own sizes, with the readings printed:
`python -m pytest benchmark/tests -m card -s -p no:cacheprovider -n 0`."""

import json

import pytest

from benchmark.harness import check
from conftest import REPO, needs_card

import control  # benchmark/control.py

CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("seed", [1, 2**31 + 7, 2**33 + 5])
@pytest.mark.parametrize("name", CELLS)
def test_the_bfloat16_control_fails(tiny_root, name, seed):
    r = control.readings(tiny_root, name, seed, "cpu")
    assert r["gops"] > 0
    assert (r["stream_mismatch"] > check.LIMITS["stream_mismatch"]
            and r["frames_mismatch"] > check.LIMITS["frames_mismatch"])


def test_the_float32_reference_agrees_with_itself(tiny_root):
    import numpy as np
    from benchmark.harness import frames
    config = json.loads((tiny_root / "benchmark/configs/"
                         "rgb444_720p_lowdelay.json").read_text())
    pool = frames.frame_pool(4, 8, config["height"], config["width"], "cpu")
    a, fa = check.reference_gops(pool, [0, 4], 4, config, "cpu")
    b, fb = check.reference_gops(pool, [0, 4], 4, config, "cpu")
    assert sum(check.mismatch(x, y) for x, y in zip(a, b)) == 0
    assert np.array_equal(fa, fb)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_size(name):
    needs_card()
    for seed in (11, 2**31 + 13, 2**32 + 17):
        r = control.readings(REPO, name, seed, "cuda")
        print(json.dumps(r))
        assert r["stream_mismatch"] > 0 and r["frames_mismatch"] > 0
