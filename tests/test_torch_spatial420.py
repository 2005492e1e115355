"""The row-tiled (gop x tile) mesh of vcs_h264_tpu_torch in 4:2:0, against
the port's unsharded `pipeline420` and the JAX package's sharded 4:2:0
pipeline, on the CPU: the 4:2:0 cases of tests/test_parallel.py at its
sizes and meshes.

The port's sharded output is held bit for bit to its unsharded output, and
to the JAX package's within the bare-plane contract of ROADMAP.md: planes,
vectors and intra payloads identical, coefficients +-1 on fewer than 1e-3
of them; the JAX package's sharded decoder on the port's stream +-2 on
fewer than 1e-3 of the BGR values of the port's decode, and the two
packages' decodes of their own streams within 0.01 dB of PSNR; B fields on
one stream.
The port exchanges 16 chroma rows where the JAX package exchanges 12, the
JAX halo rounded up to the 8x8 transform block, so K7's cells on a strip
are the frame's.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu.models import pipeline420 as jp420  # noqa: E402
from vcs_h264_tpu.parallel import mesh as jmesh  # noqa: E402
from vcs_h264_tpu.parallel import spatial as jspatial  # noqa: E402

from vcs_h264_tpu_torch import CodecConfig  # noqa: E402
from vcs_h264_tpu_torch.models import pipeline420  # noqa: E402
from vcs_h264_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from vcs_h264_tpu_torch.parallel import spatial  # noqa: E402

from test_torch_spatial import (CPU, assert_same_fields,  # noqa: E402
                                gop_batch, jax_cfg)

FIELDS = [f.name for f in dataclasses.fields(pipeline420.EncodedGOP420)]


def run_420(cfg, gop, tile, i_np, p_np, with_jax=True):
    """-> (the port's sharded stream, its sharded decode and, with_jax,
    the JAX package's sharded stream and decode), after holding the
    port's sharded encode and decode bit for bit to its unsharded ones."""
    mesh = pmesh.make_mesh(gop, tile, [CPU] * (gop * tile))
    i_b, p_b = torch.from_numpy(i_np), torch.from_numpy(p_np)
    got = spatial.sharded_encode_gop_batch_420(i_b, p_b, cfg, mesh)
    want = pipeline420.encode_gop_batch_420(i_b, p_b, cfg)
    assert_same_fields(got, want, FIELDS)
    dec = spatial.sharded_decode_gop_batch_420(got, cfg, mesh)
    assert dec.dtype == torch.uint8
    assert torch.equal(dec, pipeline420.decode_gop_batch_420(want, cfg))
    if not with_jax:
        return got, dec
    jm = jmesh.make_mesh(gop=gop, tile=tile)
    jcfg = jax_cfg(cfg)
    jgot = jspatial.sharded_encode_gop_batch_420(
        jnp.asarray(i_np, jnp.int32), jnp.asarray(p_np, jnp.int32), jcfg, jm)
    jdec = jspatial.sharded_decode_gop_batch_420(jgot, jcfg, jm)
    return got, dec, jgot, np.asarray(jdec)


def assert_planes(got, jgot, names=("i_y", "i_c", "mv")):
    for k in names:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(jgot, k)), k)


def assert_bare(got, jgot, names=("res_y", "res_c")):
    """+-1 on fewer than 1e-3 of the coefficients (ROADMAP.md)."""
    for k in names:
        d = np.abs(getattr(got, k).numpy().astype(np.int32)
                   - np.asarray(getattr(jgot, k), np.int32))
        assert d.max() <= 1 and (d > 0).mean() < 1e-3, k


def decode_diff(a, b):
    return np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))


def as_jax(got, cfg, gop, tile):
    """The port's stream decoded by the JAX package's sharded decoder."""
    jstream = jp420.EncodedGOP420(**{
        k: None if getattr(got, k) is None else jnp.asarray(
            getattr(got, k).numpy()) for k in FIELDS})
    return np.asarray(jspatial.sharded_decode_gop_batch_420(
        jstream, jax_cfg(cfg), jmesh.make_mesh(gop=gop, tile=tile)))


def psnr(dec, i_np, p_np):
    src = np.concatenate([i_np[:, None], p_np], axis=1).astype(np.float64)
    mse = ((np.asarray(dec, np.float64) - src) ** 2).mean()
    return 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("qstep", [0, 24])
def test_sharded_420_matches_unsharded(rng, qstep):
    cfg = CodecConfig(quant_mode="rounded", chroma_420=True,
                      intra_i=bool(qstep), intra_qstep=qstep)
    i_np, p_np = gop_batch(rng)
    got, dec, jgot, jdec = run_420(cfg, 2, 2, i_np, p_np)
    assert_planes(got, jgot)
    assert_bare(got, jgot)
    if qstep:
        assert_planes(got, jgot, ("iq_y", "im_y", "ie_y", "iq_c", "im_c",
                                  "ie_c"))
    d = decode_diff(dec, as_jax(got, cfg, 2, 2))
    assert d.max() <= 2 and (d > 0).mean() < 1e-3
    assert abs(psnr(dec, i_np, p_np) - psnr(jdec, i_np, p_np)) < 0.01


def test_sharded_420_bframes_matches_unsharded(rng):
    """4:2:0 with a B pattern: the decoded anchors exchanged at both
    resolutions, chroma riding the halved B vectors. B fields may differ
    from the JAX stream's where a +-1 anchor coefficient moves a SAD tie,
    so the strong check is on one stream: the JAX package's sharded
    decoder on the port's sharded stream. The two streams' decodes are
    held to the contract's PSNR bound (at seed 1234 four luma anchor
    coefficients round apart and move 8 of 2048 B vector components)."""
    cfg = CodecConfig(quant_mode="rounded", chroma_420=True,
                      gop_pattern=("I", "B", "P", "B", "P"),
                      intra_i=True, intra_qstep=24)
    i_np, p_np = gop_batch(rng, p=4)
    got, dec, jgot, jdec = run_420(cfg, 2, 2, i_np, p_np)
    assert_planes(got, jgot)
    assert_bare(got, jgot)
    assert got.b_mv.shape == jgot.b_mv.shape
    assert got.b_mode.shape == jgot.b_mode.shape
    d = decode_diff(dec, as_jax(got, cfg, 2, 2))
    assert d.max() <= 2 and (d > 0).mean() < 1e-3
    assert abs(psnr(dec, i_np, p_np) - psnr(jdec, i_np, p_np)) < 0.01


def test_sharded_420_production_tiles_of_three(rng):
    """production(chroma_420=True) on a 1 x 3 mesh (th = 32, chroma tiles
    of 16 rows: the 16-row chroma halo takes a whole neighbouring tile)."""
    cfg = CodecConfig.production(chroma_420=True, intra_qstep=24)
    got, _ = run_420(cfg, 1, 3, *gop_batch(rng, b=2, h=96), with_jax=False)
    assert (got.mv != 0).any()
