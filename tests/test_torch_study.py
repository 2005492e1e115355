"""The study functions and single-frame wrappers of vcs_h264_tpu_torch
against the JAX package's on the CPU: pad / crop to a block multiple, the
blockwise DCT of a plane, the chroma study's float colour conversion and
4:2:0 round trip, the open-loop intra studies (`luma4x4`, `luma16x16`,
`chroma8x8`), the single-plane intra codec and the one-frame motion search
and compensation.

Integers are identical; the float functions keep the parity contract of
ROADMAP.md (the colour conversion within 1e-4, the 4:2:0 round trip ±1 on
fewer than 1e-4 of samples, the DCT within 1e-3 on uint8 values less 128),
and each test prints its differing share."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu.ops import blocks as jblocks  # noqa: E402
from vcs_h264_tpu.ops import color as jcolor  # noqa: E402
from vcs_h264_tpu.ops import dct as jdct  # noqa: E402
from vcs_h264_tpu.ops import intra as jintra  # noqa: E402
from vcs_h264_tpu.ops import motion as jmotion  # noqa: E402
from vcs_h264_tpu.ops import subsample as jsub  # noqa: E402

from vcs_h264_tpu_torch.ops import blocks, color, dct, intra  # noqa: E402
from vcs_h264_tpu_torch.ops import motion, subsample  # noqa: E402

H, W = 48, 64


def _plane(seed, h=H, w=W, smooth=False):
    """uint8-valued int32 plane: random, or a smooth ramp with noise (where
    the directional modes win)."""
    rng = np.random.default_rng(seed)
    if not smooth:
        return rng.integers(0, 256, (h, w)).astype(np.int32)
    i, j = np.mgrid[:h, :w]
    base = 60 + 2 * i + 3 * j + rng.integers(-3, 4, (h, w))
    return np.clip(base, 0, 255).astype(np.int32)


def _checker(bs, h=H, w=W):
    """Blocks of 0 and 255 in a checkerboard: every block's neighbours are
    its opposite, so no mode beats the initial best (escapes)."""
    i, j = np.mgrid[:h, :w]
    return (255 * (((i // bs) + (j // bs)) % 2)).astype(np.int32)


def _escapes_4x4(h=H, w=W):
    """A plane on which the 4x4 search escapes, open or closed loop: the 128
    border reconstructs exactly, the 0 interior then too (the DC of 128 +
    128 wraps to 0), and every prediction of a 255 block among exact zeros
    is 0."""
    bi = np.arange(h // 4)[:, None]
    bj = np.arange(w // 4)[None, :]
    blk = np.where((bi == 0) | (bj == 0), 128, 0)
    blk = np.where((bi >= 3) & (bj >= 3) & (bi % 2 == 1) & (bj % 2 == 1),
                   255, blk)
    return np.kron(blk, np.ones((4, 4), int)).astype(np.int32)


PLANES = {"random": lambda bs: _plane(1),
          "smooth": lambda bs: _plane(2, smooth=True),
          "escapes": lambda bs: _escapes_4x4() if bs == 4 else _checker(bs)}


def _same(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


@pytest.mark.parametrize("shape,bs,value", [
    ((H, W), 16, 0), ((3, 37, 53), 8, 0), ((2, 3, 35, 51), 16, 7),
    ((4, 4), 4, 9)])
def test_pad_and_crop_match_jax(shape, bs, value):
    x = np.random.default_rng(3).integers(0, 256, shape).astype(np.int32)
    padded = blocks.pad_to_multiple(torch.from_numpy(x), bs, value)
    want = jblocks.pad_to_multiple(jnp.asarray(x), bs, value)
    assert tuple(padded.shape) == want.shape
    assert padded.shape[-2] % bs == padded.shape[-1] % bs == 0
    _same(padded, want)
    cropped = blocks.crop_to_multiple(torch.from_numpy(x), bs)
    _same(cropped, jblocks.crop_to_multiple(jnp.asarray(x), bs))


@pytest.mark.parametrize("shape", [(H, W), (3, H, W)])
def test_dct_plane_matches_jax(shape):
    x = (np.random.default_rng(4).integers(0, 256, shape)
         .astype(np.float32) - 128)
    got = dct.dct2_plane(torch.from_numpy(x), 8)
    want = np.asarray(jdct.dct2_plane(jnp.asarray(x), 8))
    err = float(np.abs(got.numpy() - want).max())
    back = dct.idct2_plane(got, 8)
    want_back = np.asarray(jdct.idct2_plane(jnp.asarray(want), 8))
    err_back = float(np.abs(back.numpy() - want_back).max())
    print(f"dct2_plane max |diff| {err:.2e}, idct2_plane {err_back:.2e}")
    assert got.dtype == back.dtype == torch.float32
    assert err <= 1e-3 and err_back <= 1e-3
    np.testing.assert_allclose(back.numpy(), x, atol=1e-3)


def test_ycrcb_to_rgb_float_matches_jax():
    rng = np.random.default_rng(5)
    y, cr, cb = (rng.integers(0, 256, (H, W)).astype(np.int32)
                 for _ in range(3))
    got = color.ycrcb_to_rgb_float(*(torch.from_numpy(p) for p in (y, cr, cb)))
    want = jcolor.ycrcb_to_rgb_float(*(jnp.asarray(p) for p in (y, cr, cb)))
    for name, a, b in zip("rgb", got, want):
        d = np.abs(a.numpy() - np.asarray(b))
        print(f"ycrcb_to_rgb_float {name}: max |diff| {d.max():.2e}, share "
              f"that differs {np.mean(d != 0):.2e}")
        assert a.dtype == torch.float32
        assert d.max() <= 1e-4
        assert 0 <= a.min() and a.max() <= 255


@pytest.mark.parametrize("shape", [(3, H, W), (2, 3, 35, 51)])
def test_chroma_420_roundtrip_matches_jax(shape):
    x = np.random.default_rng(6).integers(0, 256, shape).astype(np.int32)
    got = subsample.chroma_420_roundtrip(torch.from_numpy(x))
    want = np.asarray(jsub.chroma_420_roundtrip(jnp.asarray(x)))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    d = np.abs(got.numpy() - want)
    share = float(np.mean(d != 0))
    print(f"chroma_420_roundtrip: max |diff| {d.max()}, share that differs "
          f"{share:.2e}")
    assert d.max() <= 1 and share < 1e-4


@pytest.mark.parametrize("kind", list(PLANES))
def test_luma4x4_matches_jax(kind):
    y = PLANES[kind](4)
    got = intra.luma4x4(torch.from_numpy(y))
    want = jintra.luma4x4(jnp.asarray(y))
    for name, a, b in zip(("residual", "prediction", "modes"), got, want):
        assert a.dtype == torch.int32
        _same(a, b, name)
    if kind == "escapes":       # escapes keep the zero prediction
        assert (got[1] == 0).any()
        assert intra.luma4x4_codec(torch.from_numpy(y))[2].any()


@pytest.mark.parametrize("kind", list(PLANES))
def test_luma16x16_matches_jax(kind):
    y = PLANES[kind](16)
    got = intra.luma16x16(torch.from_numpy(y))
    want = jintra.luma16x16(jnp.asarray(y))
    for name, a, b in zip(("residual", "prediction", "modes"), got, want):
        assert a.dtype == torch.int32
        _same(a, b, name)
    assert len(set(got[2].flatten().tolist())) > 1 or kind == "escapes"


@pytest.mark.parametrize("kind", list(PLANES))
def test_chroma8x8_matches_jax(kind):
    cr = PLANES[kind](8)
    cb = _plane(7) if kind == "random" else PLANES[kind](8)
    got = intra.chroma8x8(torch.from_numpy(cr), torch.from_numpy(cb))
    want = jintra.chroma8x8(jnp.asarray(cr), jnp.asarray(cb))
    names = ("Cr residual", "Cr prediction", "Cb residual", "Cb prediction",
             "modes")
    for name, a, b in zip(names, got, want):
        assert a.dtype == torch.int32
        _same(a, b, name)


@pytest.mark.parametrize("kind,qstep", [("random", 24), ("smooth", 1),
                                        ("escapes", 24)])
def test_single_plane_lossy_intra_matches_jax(kind, qstep):
    y = PLANES[kind](4)
    got = intra.intra_encode4x4_lossy(torch.from_numpy(y), qstep)
    want = jintra.intra_encode4x4_lossy(jnp.asarray(y), qstep)
    for name, a, b in zip(("qcoef", "modes", "escape", "recon"), got, want):
        _same(a.to(torch.int32), np.asarray(b).astype(np.int32), name)
    if kind == "escapes":
        assert got[2].any()
    dec = intra.intra_decode4x4_lossy(*got[:3], qstep)
    _same(dec, got[3], "decode vs recon")
    jdec = jintra.intra_decode4x4_lossy(*(jnp.asarray(np.asarray(t))
                                          for t in want[:3]), qstep)
    _same(dec.to(torch.int32), jdec, "decode vs JAX")
    plain = intra.intra_encode4x4_lossy(torch.from_numpy(y), qstep,
                                        backend="plain")
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    assert torch.equal(dec, intra.intra_decode4x4_lossy(*got[:3], qstep,
                                                        backend="plain"))


@pytest.mark.parametrize("kind", list(PLANES))
def test_single_plane_lossless_decode_matches_jax(kind):
    y = PLANES[kind](4)
    res, modes, esc = intra.luma4x4_codec(torch.from_numpy(y))
    jres, jmodes, jesc = jintra.luma4x4_codec(jnp.asarray(y))
    for name, a, b in (("residual", res, jres), ("modes", modes, jmodes),
                       ("escape", esc, jesc)):
        _same(a, b, name)
    got = intra.intra_decode4x4(res, modes, esc)
    assert got.dtype == torch.int32
    _same(got, jintra.intra_decode4x4(jres, jmodes, jesc))
    _same(got, y, "lossless")
    assert torch.equal(got, intra.intra_decode4x4(res, modes, esc,
                                                  backend="plain"))


def _moving_pair(seed, c=3, f=1):
    """A reference and f frames shifted from it by a few pixels, with
    noise, [C, H, W] and [F, C, H, W] int32 (uint8 values)."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (c, H + 16, W + 16))
    ref = big[:, 8:8 + H, 8:8 + W]
    curs = []
    for t in range(f):
        dy, dx = rng.integers(-5, 6, 2)
        cur = big[:, 8 + dy:8 + dy + H, 8 + dx:8 + dx + W].copy()
        cur[:, :16, :16] = ref[:, :16, :16]          # a static corner
        cur = cur + rng.integers(-2, 3, cur.shape)
        curs.append(np.clip(cur, 0, 255))
    return ref.astype(np.int32), np.stack(curs).astype(np.int32)


@pytest.mark.parametrize("kw", [dict(), dict(bs=4, reach=8, step=1),
                                dict(bs=16, static_threshold=0)])
def test_motion_search_matches_jax(kw):
    ref, curs = _moving_pair(8, f=3)
    got = motion.motion_search(torch.from_numpy(curs[0]),
                               torch.from_numpy(ref), **kw)
    want = jmotion.motion_search(jnp.asarray(curs[0]), jnp.asarray(ref), **kw)
    assert got.dtype == torch.int32
    _same(got, want, "motion_search")
    batch = motion.motion_search_batch(torch.from_numpy(curs),
                                       torch.from_numpy(ref), **kw)
    jbatch = jmotion.motion_search_batch(jnp.asarray(curs), jnp.asarray(ref),
                                         **kw)
    _same(batch, jbatch, "motion_search_batch")
    _same(batch[0], got, "batch[0] vs one frame")
    assert torch.equal(batch, motion.motion_search_batch(
        torch.from_numpy(curs), torch.from_numpy(ref), backend="plain",
        **kw))
    assert (got != 0).any() and (got == 0).all(dim=-1).any()


@pytest.mark.parametrize("bs,dtype", [(8, np.int32), (4, np.int32),
                                      (16, np.uint8)])
def test_motion_compensate_matches_jax(bs, dtype):
    ref, curs = _moving_pair(9)
    mv = jmotion.motion_search(jnp.asarray(curs[0]), jnp.asarray(ref), bs=bs,
                               reach=8, step=1)
    want = jmotion.motion_compensate(mv, jnp.asarray(ref), bs)
    ref_in = torch.from_numpy(ref.astype(dtype))
    got = motion.motion_compensate(torch.from_numpy(np.array(mv)), ref_in,
                                   bs)
    assert got.dtype == ref_in.dtype and tuple(got.shape) == ref.shape
    _same(got.to(torch.int32), want)
    assert torch.equal(got, motion.motion_compensate(
        torch.from_numpy(np.array(mv)), ref_in, bs, backend="plain"))
