"""The row-tiled (gop x tile) mesh of vcs_h264_tpu_torch at full resolution,
against the port's unsharded pipeline and the JAX package's sharded one, on
the CPU: every case of tests/test_parallel.py at its sizes and meshes, the
JAX side on the virtual CPU mesh of tests/conftest.py, the port's on a mesh
of the CPU device repeated.

Each case holds the port's sharded output bit for bit to the port's
unsharded output, and to the JAX package's sharded output within the
parity contract of ROADMAP.md: integer fields identical, production
coefficients identical, reference-mode DCT residuals within
test_parallel's atol, decodes within its bounds; B fields on one stream.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu.config import CodecConfig as JaxConfig  # noqa: E402
from vcs_h264_tpu.models import intra_codec as jintra  # noqa: E402
from vcs_h264_tpu.models import pipeline as jpipeline  # noqa: E402
from vcs_h264_tpu.parallel import mesh as jmesh  # noqa: E402
from vcs_h264_tpu.parallel import spatial as jspatial  # noqa: E402

from vcs_h264_tpu_torch import CodecConfig  # noqa: E402
from vcs_h264_tpu_torch.models import intra_codec, pipeline  # noqa: E402
from vcs_h264_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from vcs_h264_tpu_torch.parallel import spatial  # noqa: E402

CPU = torch.device("cpu")
FIELDS = ("i_frame", "mv", "residuals", "b_mv", "b_mode", "b_residuals",
          "i_qcoef", "i_modes", "i_escape")


def gop_batch(rng, b=2, p=3, h=128, w=64):
    """test_parallel's `_gop_batch`: random I-frames, P-frames rolled by
    (t + 1, -2t) with 2% noise -> numpy planar uint8 [B, 3, H, W] and
    [B, P, 3, H, W]."""
    i_frames = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    p_frames = np.stack([
        np.stack([np.roll(i_frames[g], (t + 1, -2 * t), axis=(0, 1))
                  for t in range(p)])
        for g in range(b)])
    noise = rng.integers(0, 256, p_frames.shape, dtype=np.uint8)
    mask = rng.random(p_frames.shape[:-1])[..., None] < 0.02
    p_frames = np.where(mask, noise, p_frames)
    return (np.ascontiguousarray(i_frames.transpose(0, 3, 1, 2)),
            np.ascontiguousarray(p_frames.transpose(0, 1, 4, 2, 3)))


def jax_cfg(cfg):
    return JaxConfig(**dataclasses.asdict(cfg))


def assert_same_fields(got, want, names):
    for k in names:
        a, b = getattr(got, k), getattr(want, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.dtype == b.dtype and a.device == b.device, k
            assert torch.equal(a, b), k


def port_unsharded(i_b, p_b, cfg):
    """The Encoder's batch: lossy intra, then encode_gop_batch on its
    reconstruction."""
    if not cfg.intra_qstep:
        return pipeline.encode_gop_batch(i_b, p_b, cfg)
    pay, rec = intra_codec.encode_intra_frames_lossy_batch(i_b,
                                                           cfg.intra_qstep)
    return dataclasses.replace(pipeline.encode_gop_batch(rec, p_b, cfg),
                               i_qcoef=pay.qcoef, i_modes=pay.modes,
                               i_escape=pay.escape)


def run_port(cfg, gop, tile, i_np, p_np):
    """-> (the port's sharded stream, its sharded decode), after holding
    both bit for bit to the port's unsharded encode and decode."""
    mesh = pmesh.make_mesh(gop, tile, [CPU] * (gop * tile))
    i_b, p_b = torch.from_numpy(i_np), torch.from_numpy(p_np)
    got = spatial.sharded_encode_gop_batch(i_b, p_b, cfg, mesh)
    want = port_unsharded(i_b, p_b, cfg)
    assert_same_fields(got, want, FIELDS)
    dec = spatial.sharded_decode_gop_batch(got, cfg, mesh)
    want_dec = pipeline.decode_gop_batch(want, cfg)
    assert dec.dtype == torch.uint8 and torch.equal(dec, want_dec)
    return got, dec


def run_both(cfg, gop, tile, i_np, p_np):
    """-> (the port's sharded stream and decode, as `run_port` checks
    them, the JAX package's sharded stream and decode on its mesh)."""
    got, dec = run_port(cfg, gop, tile, i_np, p_np)
    jm = jmesh.make_mesh(gop=gop, tile=tile)
    jcfg = jax_cfg(cfg)
    jgot = jspatial.sharded_encode_gop_batch(
        jnp.asarray(i_np, jnp.int32), jnp.asarray(p_np, jnp.int32), jcfg, jm)
    jdec = jspatial.sharded_decode_gop_batch(jgot, jcfg, jm)
    return got, dec, jgot, np.asarray(jdec)


def wrap_diff(a, b):
    d = np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
    return np.minimum(d, 256 - d)


def assert_ints(port, jax_arr):
    np.testing.assert_array_equal(port.numpy(), np.asarray(jax_arr))


@pytest.mark.parametrize("tile", [2, 4])
@pytest.mark.parametrize("with_dct", [False, True])
def test_sharded_encode_matches_unsharded(rng, tile, with_dct):
    cfg = CodecConfig(with_dct=with_dct)
    got, _, jgot, _ = run_both(cfg, 2, tile, *gop_batch(rng))
    assert_ints(got.mv, jgot.mv)
    if with_dct:
        np.testing.assert_allclose(got.residuals.numpy(),
                                   np.asarray(jgot.residuals), atol=2e-2)
    else:
        assert_ints(got.residuals, jgot.residuals)


@pytest.mark.parametrize("with_dct", [False, True])
def test_sharded_decode_matches_unsharded(rng, with_dct):
    cfg = CodecConfig(with_dct=with_dct)
    _, dec, _, jdec = run_both(cfg, 2, 4, *gop_batch(rng))
    if with_dct:
        d = wrap_diff(dec, jdec)
        assert d.max() <= 1 and (d > 0).mean() < 0.02
    else:
        np.testing.assert_array_equal(dec.numpy(), jdec)


def test_sharded_roundtrip_no_dct_bit_exact(rng):
    """Wrap-residual coding is lossless: the sharded decode of the sharded
    stream gives the input back."""
    cfg = CodecConfig(with_dct=False)
    i_np, p_np = gop_batch(rng)
    _, dec, _, jdec = run_both(cfg, 2, 4, i_np, p_np)
    np.testing.assert_array_equal(dec[:, 1:].numpy(), p_np)
    np.testing.assert_array_equal(dec[:, 0].numpy(), i_np)
    np.testing.assert_array_equal(dec.numpy(), jdec)


@pytest.mark.parametrize("with_dct", [False, True])
def test_sharded_bframes_matches_unsharded(rng, with_dct):
    cfg = CodecConfig.bframes(with_dct=with_dct)
    i_np, p_np = gop_batch(rng, p=cfg.gop_len - 1)
    got, dec, jgot, jdec = run_both(cfg, 2, 2, i_np, p_np)
    assert_ints(got.mv, jgot.mv)
    if not with_dct:
        for k in ("b_mv", "b_mode", "b_residuals"):
            assert_ints(getattr(got, k), getattr(jgot, k))
        np.testing.assert_array_equal(dec.numpy(), jdec)
        return
    # the B fields on one stream: JAX's unsharded decoder on the port's
    # sharded stream gives the port's sharded decode, but for the float
    # DCT's truncation flips (test_parallel's bound)
    jstream = jpipeline.EncodedGOP(**{
        k: None if getattr(got, k) is None else jnp.asarray(
            getattr(got, k).numpy()) for k in FIELDS})
    same = np.asarray(jpipeline.jit_decode_gop_batch(jax_cfg(cfg))(jstream))
    d = wrap_diff(dec, same)
    assert d.max() <= 2 and (d > 0).mean() < 0.05
    d = wrap_diff(dec, jdec)
    assert d.max() <= 2 and (d > 0).mean() < 0.05


def test_sharded_bframes_no_residual_matches_unsharded(rng):
    cfg = CodecConfig.bframes(with_residual=False, with_dct=False)
    i_np, p_np = gop_batch(rng, p=cfg.gop_len - 1)
    got, dec, jgot, jdec = run_both(cfg, 2, 2, i_np, p_np)
    assert got.residuals is None and got.b_residuals is None
    for k in ("mv", "b_mv", "b_mode"):
        assert_ints(getattr(got, k), getattr(jgot, k))
    np.testing.assert_array_equal(dec.numpy(), jdec)


def test_sharded_production_intra_matches_unsharded(rng):
    """production(intra_qstep=24): the intra payload once per gop row, the
    P-frames on its reconstruction; every field identical to the JAX
    package's (production coefficients are integers of one rounding)."""
    cfg = CodecConfig.production(intra_qstep=24)
    i_np, p_np = gop_batch(rng)
    got, dec, jgot, jdec = run_both(cfg, 2, 2, i_np, p_np)
    payload, i_rec = jintra.encode_intra_frames_lossy_batch(
        jnp.asarray(i_np, jnp.int32), 24)
    assert_ints(got.i_frame, i_rec)
    assert_ints(got.i_qcoef, payload.qcoef)
    for k in ("i_frame", "i_qcoef", "i_modes", "i_escape", "mv",
              "residuals"):
        assert_ints(getattr(got, k), getattr(jgot, k))
    d = np.abs(dec.numpy().astype(np.int64) - jdec)
    assert d.max() <= 1 and (d > 0).mean() < 1e-4


@pytest.mark.parametrize("luma_only", [False, True])
def test_sharded_production_tiles_of_three(rng, luma_only):
    """A 1 x 3 mesh (th = 32, an interior tile with halos on both sides)
    with the production B pattern, and the luma-only search, which takes
    the G channel and a third of the static threshold."""
    pattern = ("I", "P", "P", "P") if luma_only else (
        "I", "B", "P", "B", "P", "B", "P")
    cfg = CodecConfig.production(intra_qstep=24, gop_pattern=pattern,
                                 search_luma_only=luma_only)
    i_np, p_np = gop_batch(rng, p=cfg.gop_len - 1, h=96)
    got, _ = run_port(cfg, 1, 3, i_np, p_np)
    assert (got.mv != 0).any()


def test_gop_data_parallel_sharding(rng):
    """The gop-only mesh (8 x 1): each GOP on its own mesh row; the
    vectors equal the JAX package's unsharded and gop-sharded encodes."""
    cfg = CodecConfig(with_dct=False)
    i_np, p_np = gop_batch(rng, b=8, h=64, w=64)
    got, dec, _, _ = run_both(cfg, 8, 1, i_np, p_np)
    want = jpipeline.jit_encode_gop_batch(jax_cfg(cfg))(
        jnp.asarray(i_np, jnp.int32), jnp.asarray(p_np, jnp.int32))
    assert_ints(got.mv, want.mv)
    assert_ints(got.residuals, want.residuals)
    mesh = pmesh.make_mesh(8, 1, [CPU] * 8)
    layout = pmesh.gop_sharding(mesh)
    shards = pmesh.shard(torch.from_numpy(i_np), mesh, layout)
    assert [len(row) for row in shards] == [1] * 8
    assert all(row[0].shape == (1, 3, 64, 64) for row in shards)
    assert torch.equal(pmesh.gather(shards, mesh, layout),
                       torch.from_numpy(i_np))
