"""The pieces of vcs_h264_tpu_torch's row-tiled mesh on the CPU: the mesh
and its layouts, the halo exchange, the search and the compensation of
one tile on its strip against the unsharded search and compensation of
the whole frame, the checks the sharded factories make, and the scaling
tool at a small shape (its JSON keys are the JAX tool's)."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu_torch import CodecConfig  # noqa: E402
from vcs_h264_tpu_torch.models import pipeline  # noqa: E402
from vcs_h264_tpu_torch.ops import motion  # noqa: E402
from vcs_h264_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from vcs_h264_tpu_torch.parallel import spatial  # noqa: E402

CPU = torch.device("cpu")


def cpu_mesh(gop, tile):
    return pmesh.make_mesh(gop, tile, [CPU] * (gop * tile))


def moving(rng, g=2, f=3, c=3, h=96, w=64):
    """Random references and frames shifted from them by up to +-12 rows
    and +-9 columns, with 2% noise: uint8 [G, C, H, W], [G, F, C, H, W]."""
    refs = torch.from_numpy(rng.integers(0, 256, (g, c, h, w), np.uint8))
    curs = torch.stack([torch.stack([
        torch.roll(refs[i], (int(rng.integers(-12, 13)),
                             int(rng.integers(-9, 10))), (-2, -1))
        for _ in range(f)]) for i in range(g)])
    noise = torch.from_numpy(rng.integers(0, 256, curs.shape, np.uint8))
    mask = torch.from_numpy(rng.random(curs.shape) < 0.02)
    return refs, torch.where(mask, noise, curs)


def test_make_mesh_shape_and_devices():
    mesh = cpu_mesh(2, 3)
    assert mesh.shape == {"gop": 2, "tile": 3}
    assert mesh.first == CPU
    assert hash(mesh) == hash(cpu_mesh(2, 3)) and mesh == cpu_mesh(2, 3)
    assert pmesh.make_mesh(1, 2, ["cpu", "cpu", "cpu"]).shape["tile"] == 2
    with pytest.raises(ValueError, match=r"mesh 2x2 needs 4 devices, have 3"):
        pmesh.make_mesh(2, 2, [CPU] * 3)


def test_default_mesh_takes_cuda_devices_only():
    """Without a device list the mesh is made of CUDA devices; where there
    is none it raises, and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ValueError, match="needs 1 devices, have 0"):
        pmesh.make_mesh()


@pytest.mark.parametrize("rows", [None, -2, -3])
def test_shard_gather_round_trip(rng, rows):
    """Batch over the gop rows and `rows` over the tiles; every shard
    contiguous on its device; gather gives the array back."""
    mesh = cpu_mesh(2, 4)
    x = torch.from_numpy(rng.integers(0, 256, (4, 3, 16, 8, 2), np.int32))
    layout = pmesh.Layout(rows=rows)
    shards = pmesh.shard(x, mesh, layout)
    assert [len(r) for r in shards] == [4, 4]
    for g, row in enumerate(shards):
        for t, s in enumerate(row):
            assert s.is_contiguous() and s.device == CPU
            want = x[2 * g:2 * g + 2]
            if rows is not None:
                n = x.shape[rows] // 4
                want = want.narrow(rows, t * n, n)
            assert torch.equal(s, want)
    assert torch.equal(pmesh.gather(shards, mesh, layout), x)
    assert pmesh.frame_batch_sharding(mesh) == pmesh.Layout(rows=-2)
    assert pmesh.gop_sharding(mesh) == pmesh.Layout()


def test_shard_refuses_uneven_splits():
    mesh = cpu_mesh(2, 3)
    with pytest.raises(ValueError, match="batch 3 is not a multiple"):
        pmesh.shard(torch.zeros(3, 6, 4), mesh, pmesh.Layout(rows=-2))
    with pytest.raises(ValueError, match="do not split into 3 tiles"):
        pmesh.shard(torch.zeros(2, 8, 4), mesh, pmesh.Layout(rows=-2))


@pytest.mark.parametrize("n", [2, 3, 4])
def test_halo_exchange_strips_are_frame_rows(rng, n):
    """Tile t's strip is the frame's rows [t*th - top, (t+1)*th + bottom):
    `halo` rows from each neighbour, none at a frame edge."""
    h, halo = 96, 24
    th = h // n
    frame = torch.from_numpy(rng.integers(0, 256, (2, 3, 3, h, 16),
                                          np.uint8))
    row = [CPU] * n
    strips = spatial._halo_exchange(pmesh.split_rows(frame, row), halo, row)
    assert len(strips) == n
    for t, s in enumerate(strips):
        top, bottom = spatial._edges(t, n, halo)
        assert (top, bottom) == ((0 if t == 0 else halo),
                                 (0 if t == n - 1 else halo))
        assert torch.equal(s, frame[..., t * th - top:(t + 1) * th + bottom,
                                    :])


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("luma_only", [False, True])
def test_tile_search_equals_unsharded_rows(rng, n, luma_only):
    """Each tile's search on its strip gives that tile's block rows of the
    unsharded search, on every tile: the first, interior ones and the
    last, whose bottom clamp min(c + reach, H) bites on its last block
    rows. With search_luma_only the G channel alone, as unsharded."""
    cfg = CodecConfig.production(search_luma_only=luma_only)
    bs = cfg.block_size
    halo = cfg.search_reach + bs
    refs, curs = moving(rng, h=96)
    want = pipeline._search(curs, refs, cfg, "auto")
    assert (want != 0).any()
    row = [CPU] * n
    strips = spatial._halo_exchange(pmesh.split_rows(refs, row), halo, row)
    th = 96 // n
    for t, cur_t in enumerate(pmesh.split_rows(curs, row)):
        got = spatial.tile_motion_search(
            cur_t, strips[t], spatial._edges(t, n, halo)[0], bs,
            lambda c, r: pipeline._search(c, r, cfg, "auto"))
        assert torch.equal(got, want[:, :, t * th // bs:(t + 1) * th // bs])


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("bs", [8, 4])
def test_tile_compensate_at_reach_equals_unsharded(rng, n, bs):
    """Vectors of +-reach rows and columns on every block of every tile,
    the block rows next to each tile edge among them, kept inside the
    frame as every vector of the search is: each tile's compensation on
    its strip equals those rows of the unsharded compensation, so the
    strip holds every source row and neither the gather's wrap nor its
    clamp acts on a tile block. bs 4 with the chroma geometry of 4:2:0
    (halo 16 rows, reach 8)."""
    reach, halo = (16, 24) if bs == 8 else (8, 16)
    h, w = 96, 64
    refs = torch.from_numpy(rng.integers(0, 256, (2, 2, h, w), np.uint8))
    nbh, nbw = h // bs, w // bs
    ci = torch.arange(nbh)[:, None] * bs
    cj = torch.arange(nbw)[None, :] * bs
    dy = torch.from_numpy(rng.choice([-reach, reach], (2, 3, nbh, nbw)))
    dx = torch.from_numpy(rng.choice([-reach, 0, reach], (2, 3, nbh, nbw)))
    dy = torch.maximum(torch.minimum(dy, h - bs - ci), -ci)
    dx = torch.maximum(torch.minimum(dx, w - bs - cj), -cj)
    assert (dy.abs() == reach).float().mean() > 0.8
    mv = torch.stack([dx, dy], dim=-1).to(torch.int32)
    want = motion.motion_compensate_gops(mv, refs, bs=bs)
    row = [CPU] * n
    strips = spatial._halo_exchange(pmesh.split_rows(refs, row), halo, row)
    th = h // n
    for t, (mv_t, strip) in enumerate(zip(
            pmesh.split_rows(mv, row, axis=-3), strips)):
        top = spatial._edges(t, n, halo)[0]
        rows = ci[t * th // bs:(t + 1) * th // bs] - t * th + top
        src = rows + mv_t[..., 1]
        assert (src >= 0).all() and (src <= strip.shape[-2] - bs).all()
        got = spatial.tile_motion_compensate(mv_t, strip, top, bs)
        assert torch.equal(got, want[..., t * th:(t + 1) * th, :])


def test_factories_refuse_tiles_as_jax_does():
    """The JAX package's checks and messages: th a multiple of bs (of 2 bs
    in 4:2:0) and >= halo = reach + bs with more than one tile; and the
    window check of row tiles: a block of an interior tile with no search
    candidate."""
    mesh = cpu_mesh(1, 2)
    cfg = CodecConfig.production()
    with pytest.raises(ValueError, match=r"tile height 36 must be a "
                       r"multiple of 8 and >= halo 24 \(reach \+ block\)"):
        spatial.make_sharded_encoder(mesh, cfg, 72, 64)
    with pytest.raises(ValueError, match="tile height 16 must be a multiple "
                       "of 8 and >= halo 24"):
        spatial.make_sharded_decoder(mesh, cfg, 32, 64)
    cfg420 = CodecConfig.production(chroma_420=True)
    with pytest.raises(ValueError, match="tile height 24 must be a multiple "
                       "of 16 and >= halo 24"):
        spatial.make_sharded_encoder_420(cpu_mesh(1, 3), cfg420, 72, 64)
    with pytest.raises(ValueError, match="tile height 16 must be a multiple "
                       "of 16 and >= halo 24"):
        spatial.make_sharded_decoder_420(mesh, cfg420, 32, 64)
    with pytest.raises(ValueError, match="do not split into 3 tiles"):
        spatial.make_sharded_encoder(cpu_mesh(1, 3), cfg, 64, 64)
    wide = CodecConfig(with_dct=False, block_size=16, search_reach=16,
                       search_step=5)
    with pytest.raises(ValueError, match="search candidate in every block"):
        spatial.make_sharded_encoder(mesh, wide, 128, 64)
    spatial.make_sharded_encoder(cpu_mesh(1, 1), wide, 128, 64)   # one tile
    # th == halo is the smallest tile allowed
    spatial.make_sharded_encoder(cpu_mesh(1, 2), cfg, 48, 64)


def test_batch_must_split_over_gop_rows(rng):
    cfg = CodecConfig.production()
    i_b = torch.zeros((3, 3, 48, 16), dtype=torch.uint8)
    p_b = torch.zeros((3, 2, 3, 48, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="batch 3 is not a multiple of the "
                       "mesh's 2 gop rows"):
        spatial.sharded_encode_gop_batch(i_b, p_b, cfg, cpu_mesh(2, 2))
    with pytest.raises(ValueError, match="batch 3 is not a multiple"):
        spatial.sharded_encode_gop_batch_420(
            i_b, p_b, CodecConfig.production(chroma_420=True),
            cpu_mesh(2, 1))


def test_tail_gop_of_a_b_pattern_is_coded_all_p(rng):
    """A B pattern with fewer frames than the pattern codes all-P, as the
    unsharded pipeline does."""
    cfg = CodecConfig.production(gop_pattern=("I", "B", "P", "B", "P"))
    refs, curs = moving(rng, g=2, f=2, h=48, w=32)
    got = spatial.sharded_encode_gop_batch(refs, curs, cfg, cpu_mesh(1, 2))
    want = pipeline.encode_gop_batch(refs, curs, cfg)
    assert got.b_mv is None and torch.equal(got.mv, want.mv)
    assert torch.equal(got.residuals, want.residuals)


def test_bench_scaling_prints_the_jax_tools_json(capsys):
    from vcs_h264_tpu_torch.tools import bench_scaling
    out = bench_scaling.main(shape=(8, 1, 96, 32), device="cpu")
    printed = json.loads(capsys.readouterr().out)
    assert printed == out
    assert {"note", "shape", "results"} <= set(out)
    assert out["shape"] == "8 GOPs x 2 frames 32x96"
    assert list(out["results"]) == [
        "gop1x tile1", "gop2x tile1", "gop4x tile1", "gop8x tile1",
        "gop1x tile2", "gop1x tile4", "gop2x tile4", "gop4x tile2"]
    for r in out["results"].values():
        assert set(r) == {"devices", "ms", "fps", "speedup", "efficiency"}
        assert r["fps"] > 0
