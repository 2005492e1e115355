"""vcs_h264_tpu_torch BGR <-> YCrCb against the JAX package on the CPU: the
port computes OpenCV's fixed point in int32 with an arithmetic shift, the
JAX package in float32 with floor; both must give identical results for
every uint8 triple."""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu.ops import color as jcolor  # noqa: E402

from vcs_h264_tpu_torch.ops import color  # noqa: E402

CHUNKS = 8          # the 2^24 triples in slices of 2^21 values per channel


def _all_triples_planar(chunk):
    """Chunk `chunk` of every (c0, c1, c2) uint8 triple, planar:
    [3, 2^21 / 4096, 4096] uint8 (c0 slowest)."""
    n = (1 << 24) // CHUNKS
    v = np.arange(chunk * n, (chunk + 1) * n, dtype=np.int64)
    planes = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255])
    return planes.astype(np.uint8).reshape(3, n // 4096, 4096)


@pytest.mark.parametrize("fwd", [True, False], ids=["bgr2ycrcb", "ycrcb2bgr"])
def test_planar_identical_for_every_triple(fwd):
    port = color.bgr_to_ycrcb_planes if fwd else color.ycrcb_to_bgr_planes
    jax_fn = jcolor.bgr_to_ycrcb_planes if fwd else jcolor.ycrcb_to_bgr_planes
    for chunk in range(CHUNKS):
        x = _all_triples_planar(chunk)
        got = port(torch.from_numpy(x))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jax_fn(jnp.asarray(x))))


@pytest.mark.parametrize("fwd", [True, False], ids=["bgr2ycrcb", "ycrcb2bgr"])
def test_channel_last_identical_for_every_triple(fwd):
    port = color.bgr_to_ycrcb if fwd else color.ycrcb_to_bgr
    jax_fn = jcolor.bgr_to_ycrcb if fwd else jcolor.ycrcb_to_bgr
    for chunk in range(CHUNKS):
        x = np.ascontiguousarray(np.moveaxis(_all_triples_planar(chunk), 0, -1))
        got = port(torch.from_numpy(x))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jax_fn(jnp.asarray(x))))


def test_batched_leading_dims_and_int_inputs(rng):
    x = rng.integers(0, 256, (2, 3, 3, 8, 12))
    for port, jax_fn in ((color.bgr_to_ycrcb_planes, jcolor.bgr_to_ycrcb_planes),
                         (color.ycrcb_to_bgr_planes, jcolor.ycrcb_to_bgr_planes)):
        for dtype in (np.uint8, np.int32, np.int64):
            got = port(torch.from_numpy(x.astype(dtype)))
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(jax_fn(jnp.asarray(x, jnp.int32))))
    hwc = np.moveaxis(x, 2, -1)
    for port, jax_fn in ((color.bgr_to_ycrcb, jcolor.bgr_to_ycrcb),
                         (color.ycrcb_to_bgr, jcolor.ycrcb_to_bgr)):
        got = port(torch.from_numpy(np.ascontiguousarray(hwc)))
        assert got.shape == hwc.shape
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jax_fn(jnp.asarray(hwc))))
        # planar and channel-last forms agree
        planar = (color.bgr_to_ycrcb_planes if port is color.bgr_to_ycrcb
                  else color.ycrcb_to_bgr_planes)(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(),
                                      np.moveaxis(planar.numpy(), 2, -1))
