"""The comparison's control, put in the program's place, fails the
comparison (limit 0) on every seed tried: the reference computed in
bfloat16, the precision below the configurations' float32, in both
configurations, and open-loop intra, which an all-intra configuration
names, where bfloat16 changes nothing. The float32 reference against
itself passes. On a card, the same at the cells' own sizes, with the
readings printed:
`python -m pytest benchmark/tests -m card -s -p no:cacheprovider -n 0`."""

import json

import pytest
import torch

from benchmark.controls import open_loop_intra
from benchmark.harness import check
from benchmark.reference import plain_ops
from conftest import REPO, add_allintra_cell, needs_card

import control  # benchmark/control.py

CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("seed", [1, 2**31 + 7, 2**33 + 5])
@pytest.mark.parametrize("name", CELLS)
def test_the_bfloat16_control_fails(tiny_root, name, seed):
    r = control.readings(tiny_root, name, seed, "cpu")
    assert r["gops"] > 0 and r["control"] == "bfloat16"
    assert (r["stream_mismatch"] > check.LIMITS["stream_mismatch"]
            and r["frames_mismatch"] > check.LIMITS["frames_mismatch"])
    assert not r["correct"]


@pytest.mark.parametrize("seed", [1, 2**31 + 7, 2**33 + 5])
def test_the_open_loop_control_fails_an_all_intra_cell(tiny_root, seed):
    r = control.readings(tiny_root, add_allintra_cell(tiny_root), seed,
                         "cpu")
    assert r["gops"] == 8 and r["control"] == "open_loop_intra"
    assert (r["stream_mismatch"] > check.LIMITS["stream_mismatch"]
            and r["frames_mismatch"] > check.LIMITS["frames_mismatch"])
    assert not r["correct"]


def test_bfloat16_cannot_fail_an_all_intra_cell(tiny_root):
    """Why an all-intra configuration names its own control: without the
    name, the default bfloat16 control reads nought there."""
    name = add_allintra_cell(tiny_root)
    path = tiny_root / "benchmark/configs/c420_allintra.json"
    cfg = json.loads(path.read_text())
    del cfg["control"]
    path.write_text(json.dumps(cfg))
    r = control.readings(tiny_root, name, 5, "cpu")
    assert r["control"] == "bfloat16" and r["gops"] == 8
    assert r["stream_mismatch"] == r["frames_mismatch"] == 0


def test_open_loop_intra_is_closed_loop_where_nothing_is_lost():
    """Where the reconstruction equals the source, predicting from either
    is the same: on planes flat at the fill value 128 every block, and on
    any plane the first block, which has no neighbours, agree with the
    closed-loop reference; elsewhere on a noisy plane they differ."""
    gen = torch.Generator().manual_seed(7)
    noisy = torch.randint(0, 256, (2, 3, 16, 24), generator=gen,
                          dtype=torch.uint8)
    flat = torch.full((1, 2, 16, 24), 128, dtype=torch.uint8)
    for planes, whole in ((flat, True), (noisy, False)):
        got = open_loop_intra.intra_open_loop(planes, 24)
        want = plain_ops.intra_encode_lossy(planes.flatten(0, 1), 24)
        want = [x.reshape(*planes.shape[:2], *x.shape[1:]) for x in want]
        for a, b, cell in zip(got, want, (4, 1, 1, 4)):
            assert a.shape == b.shape and a.dtype == b.dtype
            if whole:
                assert torch.equal(a, b)
            else:
                assert torch.equal(a[..., :cell, :cell], b[..., :cell, :cell])
    assert not all(torch.equal(a, b) for a, b in zip(
        open_loop_intra.intra_open_loop(noisy, 24),
        (x.reshape(2, 3, *x.shape[1:]) for x in
         plain_ops.intra_encode_lossy(noisy.flatten(0, 1), 24))))


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
