"""The quality metrics of vcs_h264_tpu_torch (`utils/metrics.py`) against
the JAX package's on the CPU: SSIM (box means over the interior against
scipy's uniform filter with its border cropped) within 1e-9, the sparsity
statistic equal, the device PSNR within 1e-4 dB of `psnr_jnp`, and the
JSONL records of `MetricsLogger` equal but for their timestamps."""

import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from vcs_h264_tpu.utils import metrics as jmetrics  # noqa: E402

from vcs_h264_tpu_torch.utils import metrics  # noqa: E402


def _pair(rng, shape, noise):
    a = rng.integers(0, 256, shape).astype(np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-noise, noise + 1, shape),
                0, 255).astype(np.uint8)
    return a, b


@pytest.mark.parametrize("win", [8, 4, 7, 1])
@pytest.mark.parametrize("shape", [(48, 64), (48, 64, 3), (21, 33, 3)],
                         ids=["grey", "colour", "ragged colour"])
@pytest.mark.parametrize("noise", [0, 3, 60])
def test_ssim_matches_jax(rng, shape, win, noise):
    a, b = _pair(rng, shape, noise)
    want = jmetrics.ssim(a, b, win=win)
    got = metrics.ssim(a, b, win=win)
    assert isinstance(got, float)
    assert abs(got - want) <= 1e-9, (got, want)
    assert metrics.ssim(torch.from_numpy(a), torch.from_numpy(b),
                        win=win) == got


def test_ssim_of_identical_images_is_one(rng):
    a, _ = _pair(rng, (32, 40, 3), 0)
    assert metrics.ssim(a, a) == pytest.approx(1.0, abs=1e-12)


@pytest.mark.parametrize("density", [0.0, 0.1, 1.0])
@pytest.mark.parametrize("dtype", [np.int16, np.float32, bool])
def test_sparsity_matches_jax(rng, density, dtype):
    x = (rng.integers(-5, 6, (3, 16, 24)) *
         (rng.random((3, 16, 24)) < density)).astype(dtype)
    want = jmetrics.sparsity(x)
    assert metrics.sparsity(x) == want
    assert metrics.sparsity(torch.from_numpy(x)) == want


@pytest.mark.parametrize("noise", [0, 1, 5, 120])
def test_psnr_t_matches_psnr_jnp(rng, noise):
    a, b = _pair(rng, (24, 32, 3), noise)
    want = float(jmetrics.psnr_jnp(jnp.asarray(a), jnp.asarray(b)))
    got = metrics.psnr_t(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dim() == 0 and got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-4, (float(got), want)
    if noise:
        assert abs(float(got) - metrics.psnr(a, b)) < 1e-3
    assert metrics.psnr(a, b) == jmetrics.psnr(a, b)


@pytest.mark.parametrize("to_path", [False, True], ids=["file", "path"])
def test_metrics_logger_matches_jax(tmp_path, to_path):
    events = [("gop", dict(gop=0, static_block_ratio=0.25,
                           nonzero_coeff_ratio=0.125)),
              ("encode_summary", dict(frames=10, seconds=0.5, fps=20.0,
                                      gops=3)),
              ("stage_timings", {"encode_gop_batch": 1.5})]
    lines = []
    for mod, name in ((metrics, "port"), (jmetrics, "jax")):
        if to_path:
            path = tmp_path / f"{name}.jsonl"
            logger = mod.MetricsLogger(str(path))
        else:
            fh = io.StringIO()
            logger = mod.MetricsLogger(fh)
        for event, fields in events:
            logger.log(event, **fields)
        logger.close()
        text = path.read_text() if to_path else fh.getvalue()
        lines.append([json.loads(line) for line in text.splitlines()])
    port, jax_recs = lines
    assert len(port) == len(jax_recs) == len(events)
    for p, j in zip(port, jax_recs):
        assert list(p)[:2] == ["ts", "event"]
        assert list(p) == list(j)
        p.pop("ts"), j.pop("ts")
        assert p == j
