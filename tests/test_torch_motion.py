"""vcs_h264_tpu_torch motion search and compensation (the plain PyTorch path
that stands beside the K2 kernel) against the JAX package's XLA path on the
CPU. The XLA path is what the TPU kernel is held bitwise against
(tests/test_motion_pallas.py), so vectors must be identical."""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu.ops import motion as jmotion  # noqa: E402

from vcs_h264_tpu_torch.ops import motion, motion_cuda  # noqa: E402


def _smooth(rng, h, w):
    """Smooth random BGR texture [3, h, w] uint8."""
    base = rng.uniform(0, 255, (3, h // 8 + 2, w // 8 + 2))
    t = torch.nn.functional.interpolate(torch.from_numpy(base)[None],
                                        size=(h, w), mode="bilinear",
                                        align_corners=False)[0]
    return t.clamp(0, 255).round().to(torch.uint8).numpy()


def _inputs(kind, rng, g, f, h, w):
    if kind == "random":
        refs = rng.integers(0, 256, (g, 3, h, w))
        curs = rng.integers(0, 256, (g, f, 3, h, w))
    elif kind == "shifted":
        refs = np.stack([_smooth(rng, h, w) for _ in range(g)])
        shifts = [(2, -1), (-4, 5), (7, 3)]
        curs = np.stack([np.stack([np.roll(r, shifts[i % 3], axis=(-2, -1))
                                   for i in range(f)]) for r in refs])
    else:                                   # static, with small noise
        refs = np.stack([_smooth(rng, h, w) for _ in range(g)])
        noise = rng.integers(-1, 2, (g, f, 3, h, w))
        curs = np.clip(refs[:, None].astype(np.int64) + noise, 0, 255)
    return refs.astype(np.uint8), curs.astype(np.uint8)


def _jax_search(curs, refs, **kw):
    return np.asarray(jmotion.motion_search_gops(
        jnp.asarray(curs, jnp.int32), jnp.asarray(refs, jnp.int32),
        backend="xla", **kw))


@pytest.mark.parametrize("kind,g,f,h,w", [
    ("random", 2, 3, 48, 64),
    ("shifted", 1, 3, 64, 128),
    ("static", 2, 2, 48, 64),
    ("shifted", 1, 2, 96, 160),
    ("random", 1, 2, 48, 24),         # narrower than 2*reach: absolute grids
    ("random", 1, 2, 8, 64),          # one block row: no valid row candidate
])
def test_search_matches_jax(rng, kind, g, f, h, w):
    refs, curs = _inputs(kind, rng, g, f, h, w)
    got = motion.motion_search_gops(torch.from_numpy(curs),
                                    torch.from_numpy(refs))
    want = _jax_search(curs, refs)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert motion_cuda.LAUNCHES["sad_search"] == 0


def test_search_fallback_and_static_paths(rng):
    """An 8-row frame has no valid candidate row, so every block that is not
    static falls back to absolute (0, 0): MV = (-cj, 0)."""
    refs, curs = _inputs("random", rng, 1, 1, 8, 64)
    got = motion.motion_search_gops(torch.from_numpy(curs),
                                    torch.from_numpy(refs)).numpy()
    cj = np.arange(8) * 8
    np.testing.assert_array_equal(got[0, 0, 0, :, 0], -cj)
    np.testing.assert_array_equal(got[0, 0, 0, :, 1], 0)
    # identical frames are static everywhere
    same = motion.motion_search_gops(torch.from_numpy(refs[:, None]),
                                     torch.from_numpy(refs)).numpy()
    assert not same.any()


@pytest.mark.parametrize("th", [0, 500, 2000])
def test_search_threshold_and_reach_match_jax(rng, th):
    refs, curs = _inputs("shifted", rng, 1, 2, 48, 64)
    kw = dict(reach=8, step=2, static_threshold=th)
    got = motion.motion_search_gops(torch.from_numpy(curs),
                                    torch.from_numpy(refs), **kw)
    np.testing.assert_array_equal(got.numpy(), _jax_search(curs, refs, **kw))


def test_static_sad_and_plan_match_jax(rng):
    refs, curs = _inputs("random", rng, 1, 2, 48, 64)
    got = motion.static_sad(torch.from_numpy(curs[0]),
                            torch.from_numpy(refs[0])[None], 8)
    want = np.stack([np.asarray(jmotion.static_sad(
        jnp.asarray(c, jnp.int32), jnp.asarray(refs[0], jnp.int32), 8))
        for c in curs[0]])
    np.testing.assert_array_equal(got.numpy(), want)
    p, q = motion.make_plan(48, 64, 8, 16, 3), jmotion.make_plan(48, 64, 8, 16, 3)
    for a, b in zip(p, q):
        np.testing.assert_array_equal(a, b)


def test_compensate_matches_jax(rng):
    g, f, h, w = 2, 3, 48, 64
    refs = rng.integers(0, 256, (g, 3, h, w)).astype(np.uint8)
    # vectors past the bottom/right edge exercise the clamp of the source
    # origin; origins above/left of the frame have their own test below
    mv = rng.integers(-20, 21, (g, f, h // 8, w // 8, 2))
    mv[..., 1] = np.maximum(mv[..., 1], -np.arange(h // 8)[:, None] * 8)
    mv[..., 0] = np.maximum(mv[..., 0], -np.arange(w // 8) * 8)
    mv = mv.astype(np.int32)
    got = motion.motion_compensate_gops(torch.from_numpy(mv),
                                        torch.from_numpy(refs), bs=8)
    want = np.asarray(jmotion.motion_compensate_gops(
        jnp.asarray(mv), jnp.asarray(refs, jnp.int32), bs=8, reach=16,
        backend="xla"))
    np.testing.assert_array_equal(got.numpy(), want)


def _edge_vectors(g, f, nbh, nbw, bs, h, w):
    """Vectors whose source origins fall before the top and left edges: -1,
    -bs and -extent-3 on each axis, in every combination, cycled over the
    blocks."""
    cases = [(dj, di) for di in (-1, -bs, -h - 3, 0) for dj in (-1, -bs, -w - 3, 0)]
    mv = np.zeros((g, f, nbh, nbw, 2), np.int64)
    for n, (gi, fi, bi, bj) in enumerate(np.ndindex(g, f, nbh, nbw)):
        oj, oi = cases[n % len(cases)]
        mv[gi, fi, bi, bj] = (oj - bj * bs, oi - bi * bs)
    return mv.astype(np.int32)


def test_compensate_matches_jax_before_top_left_edges(rng):
    """A negative source origin is placed as lax.dynamic_slice places it
    (extent added, then clamped), so the port's gather is identical to the
    JAX gather there too; the P-frame decode built on it stays within the
    +-1 bound of the JAX decode."""
    from vcs_h264_tpu.config import CodecConfig as JaxConfig
    from vcs_h264_tpu.models import pipeline as jpipeline
    from vcs_h264_tpu_torch.ops import inter_cuda
    g, f, h, w, bs = 2, 2, 48, 64, 8
    refs = rng.integers(0, 256, (g, 3, h, w)).astype(np.uint8)
    mv = _edge_vectors(g, f, h // bs, w // bs, bs, h, w)
    got = motion.motion_compensate_gops(torch.from_numpy(mv),
                                        torch.from_numpy(refs), bs=bs)
    want = np.asarray(jmotion.motion_compensate_gops(
        jnp.asarray(mv), jnp.asarray(refs, jnp.int32), bs=bs, reach=16,
        backend="xla"))
    np.testing.assert_array_equal(got.numpy(), want)

    curs = rng.integers(0, 256, (g, f, 3, h, w)).astype(np.uint8)
    co = inter_cuda.encode_p_coeffs(torch.from_numpy(mv),
                                    torch.from_numpy(refs),
                                    torch.from_numpy(curs), 50.0)
    cfg = JaxConfig.production()
    want_d = np.asarray(jnp.clip(
        want + jpipeline.dct_decompress_residual_signed(
            jnp.asarray(co.numpy()), cfg), 0, 255))
    got_d = inter_cuda.decode_p_frames(torch.from_numpy(mv),
                                       torch.from_numpy(refs), co, 50.0)
    diff = np.abs(got_d.numpy().astype(np.int64) - want_d)
    assert diff.max() <= 1
    assert (diff != 0).mean() < 1e-4


def test_kernel_wrapper_refuses_cpu_tensors(rng):
    refs, curs = _inputs("random", rng, 1, 1, 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        motion_cuda.sad_search(torch.from_numpy(curs), torch.from_numpy(refs))
    with pytest.raises(ValueError, match="backend"):
        motion.motion_search_gops(torch.from_numpy(curs),
                                  torch.from_numpy(refs), backend="xla")
    assert motion_cuda.LAUNCHES["sad_search"] == 0
