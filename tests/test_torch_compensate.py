"""vcs_h264_tpu_torch block compensation (the plain PyTorch version that
stands beside the K1 kernel) against the JAX package on the CPU: against
the Pallas kernel in interpret mode for the vectors it takes (|d| <= reach,
in frame, and the search's), and against the XLA gather for any vector, at
the block sizes the configs admit. Integer outputs, so identical."""

import numpy as np
import jax.numpy as jnp
import pytest
from jax.experimental import pallas as pl

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu.ops import motion as jmotion  # noqa: E402

from vcs_h264_tpu_torch.ops import motion, motion_cuda  # noqa: E402


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    import vcs_h264_tpu.ops.motion_pallas as MP
    monkeypatch.setattr(MP.pl, "pallas_call", patched)
    return MP


def _port(mv, refs, bs):
    got = motion.motion_compensate_gops(torch.from_numpy(mv),
                                        torch.from_numpy(refs), bs=bs)
    assert got.dtype == torch.uint8 and motion_cuda.LAUNCHES["compensate"] == 0
    return got.numpy()


@pytest.mark.parametrize("h,w,reach", [(64, 64, 16), (48, 80, 16),
                                       (64, 128, 8)])
def test_matches_pallas_kernel_in_frame(rng, interpret_pallas, h, w, reach):
    bs, g, f = 8, 2, 3
    nbh, nbw = h // bs, w // bs
    refs = rng.integers(0, 256, (g, 3, h, w)).astype(np.uint8)
    mv = rng.integers(-reach, reach + 1, (g, f, nbh, nbw, 2))
    ci = np.arange(nbh)[:, None] * bs
    cj = np.arange(nbw)[None, :] * bs
    mv[..., 1] = np.clip(mv[..., 1], -ci, h - bs - ci)
    mv[..., 0] = np.clip(mv[..., 0], -cj, w - bs - cj)
    mv = mv.astype(np.int32)
    want = np.asarray(interpret_pallas.motion_compensate_pallas_gops(
        jnp.asarray(mv), jnp.asarray(refs, jnp.int32), bs, reach))
    np.testing.assert_array_equal(_port(mv, refs, bs), want)


def test_matches_pallas_kernel_on_search_output(rng, interpret_pallas):
    """Vectors from the search: static, fallback and edge-clamped windows."""
    h, w, bs = 64, 64, 8
    refs = rng.integers(0, 256, (2, 3, h, w)).astype(np.uint8)
    curs = np.stack([np.stack([np.roll(r, s, axis=(-2, -1)) for s in
                               ((5, -7), (0, 0), (-12, 3))]) for r in refs])
    mv = motion.motion_search_gops(torch.from_numpy(curs),
                                   torch.from_numpy(refs)).numpy()
    assert mv.any() and not mv.all()
    want = np.asarray(interpret_pallas.motion_compensate_pallas_gops(
        jnp.asarray(mv), jnp.asarray(refs, jnp.int32), bs, 16))
    np.testing.assert_array_equal(_port(mv, refs, bs), want)


@pytest.mark.parametrize("bs", [4, 8, 16])
@pytest.mark.parametrize("c", [1, 3])
def test_matches_xla_gather_for_any_vector(rng, bs, c):
    """Vectors up to three frame extents away, so origins fall before,
    after and far outside every edge."""
    g, f, h, w = 2, 2, 6 * bs, 5 * bs
    refs = rng.integers(0, 256, (g, c, h, w)).astype(np.uint8)
    mv = rng.integers(-3 * w, 3 * w + 1, (g, f, h // bs, w // bs, 2))
    mv[0, 0] = 0
    mv = mv.astype(np.int32)
    want = np.asarray(jmotion.motion_compensate_gops(
        jnp.asarray(mv), jnp.asarray(refs, jnp.int32), bs=bs, reach=2 * bs,
        backend="xla"))
    got = _port(mv, refs, bs)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 0], refs[0])     # zero vectors


def test_wrap_residual_and_static_count_match_jax(rng):
    cur = rng.integers(0, 256, (2, 3, 16, 24)).astype(np.uint8)
    rec = rng.integers(0, 256, (2, 3, 16, 24)).astype(np.uint8)
    res = motion.residuals_wrap(torch.from_numpy(cur), torch.from_numpy(rec))
    want = np.asarray(jmotion.residuals_wrap(jnp.asarray(cur, jnp.int32),
                                             jnp.asarray(rec, jnp.int32)))
    assert res.dtype == torch.int32
    np.testing.assert_array_equal(res.numpy(), want)
    back = motion.reconstruct_wrap(torch.from_numpy(rec), res)
    np.testing.assert_array_equal(back.numpy(), cur)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jmotion.reconstruct_wrap(jnp.asarray(rec, jnp.int32),
                                 jnp.asarray(want))))
    mv = rng.integers(-1, 2, (3, 4, 5, 2)).astype(np.int32)
    assert int(motion.num_static_blocks(torch.from_numpy(mv))) == int(
        jmotion.num_static_blocks(jnp.asarray(mv)))


def test_kernel_wrapper_refuses_cpu_tensors_and_wrong_dtypes(rng):
    refs = torch.from_numpy(rng.integers(0, 256, (1, 3, 16, 16))
                            .astype(np.uint8))
    mv = torch.zeros((1, 2, 2, 2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        motion_cuda.compensate(mv, refs, bs=8)
    with pytest.raises(ValueError, match="uint8"):
        motion_cuda.compensate(mv, refs.to(torch.int32), bs=8)
    with pytest.raises(ValueError, match="int32"):
        motion_cuda.compensate(mv.to(torch.int64), refs, bs=8)
    with pytest.raises(ValueError, match="contiguous"):
        motion_cuda.compensate(mv.transpose(2, 3), refs, bs=8)
    with pytest.raises(ValueError, match="backend"):
        motion.motion_compensate_gops(mv, refs, bs=8, backend="xla")
    with pytest.raises(ValueError, match="must be"):
        motion.motion_compensate_gops(mv[:, :, :1], refs, bs=8)
    assert motion_cuda.LAUNCHES["compensate"] == 0
