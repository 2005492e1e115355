"""4:2:0 subsampling, ingest and emit in vcs_h264_tpu_torch against the JAX
package on the CPU. Everything here is integer arithmetic, so every
comparison is exact (tolerance 0)."""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu.models import pipeline420 as jp420  # noqa: E402
from vcs_h264_tpu.ops import subsample as jsub  # noqa: E402

from vcs_h264_tpu_torch.models import pipeline420  # noqa: E402
from vcs_h264_tpu_torch.ops import subsample  # noqa: E402


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("shape", [(2, 2), (2, 8), (7, 5), (3, 16, 24),
                                   (2, 3, 9, 10)])
def test_box_filter_and_subsample_match_jax(rng, shape):
    """Even and odd sides, the smallest plane, leading axes; the extremes 0
    and 255 so that the ceil and the reflect both show."""
    x = rng.choice([0, 1, 2, 3, 254, 255], shape).astype(np.uint8)
    got = subsample.box_filter_2x2(_t(x))
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsub.box_filter_2x2(jnp.asarray(x, jnp.int32))))
    np.testing.assert_array_equal(
        subsample.subsample_420(_t(x)).numpy(),
        np.asarray(jsub.subsample_420(jnp.asarray(x, jnp.int32))))


def test_box_filter_reflects_101_at_top_and_left():
    """Row -1 is row 1 and column -1 is column 1 (not row 0): built so that
    a replicate border would give another value; the rounding is a ceil."""
    x = np.array([[0, 0, 0], [0, 8, 0], [0, 0, 1]], np.uint8)
    got = subsample.box_filter_2x2(_t(x)).numpy()
    # out(0, 0) = (x[1,1] + x[1,0] + x[0,1] + x[0,0]) / 4 under reflect-101
    assert got[0, 0] == 2
    # out(2, 2) = ceil((8 + 0 + 0 + 1) / 4)
    assert got[2, 2] == 3
    np.testing.assert_array_equal(
        got, np.asarray(jsub.box_filter_2x2(jnp.asarray(x, jnp.int32))))


@pytest.mark.parametrize("factor", [2, 3])
def test_upsample_nearest_matches_jax(rng, factor):
    x = rng.integers(0, 256, (2, 3, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        subsample.upsample_nearest(_t(x), factor).numpy(),
        np.asarray(jsub.upsample_nearest(jnp.asarray(x), factor)))


@pytest.mark.parametrize("shape", [(3, 16, 32), (2, 3, 3, 6, 10)])
def test_encode_decode_420_match_jax(rng, shape):
    ycc = rng.integers(0, 256, shape).astype(np.int32)
    got = subsample.encode_420(_t(ycc))
    want = jsub.encode_420(jnp.asarray(ycc))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        subsample.decode_420(*got).numpy(), np.asarray(jsub.decode_420(*want)))


@pytest.mark.parametrize("shape", [(3, 16, 16), (2, 3, 32, 48),
                                   (2, 3, 3, 16, 32)])
def test_ingest_and_emit_match_jax(rng, shape):
    """BGR -> (Y, Cr/Cb at half resolution) -> BGR, uint8 in the port and
    int32 in the JAX package, value for value."""
    bgr = rng.integers(0, 256, shape, dtype=np.uint8)
    y, c = pipeline420.ingest_420(_t(bgr))
    jy, jc = jp420.ingest_420(jnp.asarray(bgr, jnp.int32))
    assert y.dtype == c.dtype == torch.uint8
    assert tuple(c.shape) == (*shape[:-3], 2, shape[-2] // 2, shape[-1] // 2)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    out = pipeline420.emit_bgr(y, c)
    assert out.dtype == torch.uint8 and tuple(out.shape) == shape
    np.testing.assert_array_equal(out.numpy(), np.asarray(jp420.emit_bgr(jy, jc)))


def test_emit_of_extreme_planes_matches_jax(rng):
    """Planes that no ingest produces (a decoder may hand over any uint8):
    the colour conversion clips, identically in both packages."""
    y = rng.choice([0, 16, 128, 240, 255], (2, 8, 16)).astype(np.uint8)
    c = rng.choice([0, 16, 128, 240, 255], (2, 2, 4, 8)).astype(np.uint8)
    np.testing.assert_array_equal(
        pipeline420.emit_bgr(_t(y), _t(c)).numpy(),
        np.asarray(jp420.emit_bgr(jnp.asarray(y, jnp.int32),
                                  jnp.asarray(c, jnp.int32))))
