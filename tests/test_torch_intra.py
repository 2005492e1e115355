"""vcs_h264_tpu_torch intra (the plain PyTorch versions that stand beside the
K5 / K6 kernels) against the JAX package on the CPU. Every intra output is
an integer by construction, so all comparisons are exact: the nine
predictors, the core transform, the lossless codec, the closed-loop lossy
wavefront (against the JAX scan and against the Pallas kernel in interpret
mode) and both decodes."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu.models import intra_codec as jintra_codec  # noqa: E402
from vcs_h264_tpu.ops import intra as jintra  # noqa: E402
from vcs_h264_tpu.ops import intra_pallas as jintra_pallas  # noqa: E402

from vcs_h264_tpu_torch.models import intra_codec  # noqa: E402
from vcs_h264_tpu_torch.ops import intra, intra_cuda  # noqa: E402


def _planes(rng, n, h, w):
    return rng.integers(0, 256, (n, h, w)).astype(np.uint8)


def escape_plane(h, w):
    """A plane on which closed-loop lossy intra (any qstep) and the lossless
    codec both escape: a 128 border reconstructs exactly (the 128 fills
    predict it), so the 0 interior reconstructs exactly (DC of 128 + 128
    wraps to 0), and a 255 block whose neighbours are all exact zeros has
    every prediction 0, a SAD of 16 * 255, and no mode beats the sentinel."""
    bi = np.arange(h // 4)[:, None]
    bj = np.arange(w // 4)[None, :]
    blk = np.where((bi == 0) | (bj == 0), 128, 0)
    blk = np.where((bi >= 3) & (bj >= 3) & (bi % 2 == 1) & (bj % 2 == 1),
                   255, blk)
    return np.kron(blk, np.ones((4, 4), int)).astype(np.uint8)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got).astype(np.int64),
                                  np.asarray(want).astype(np.int64))


def _neighbor_inputs(rng, shape):
    """Random neighbour vectors with the plane-origin masks of every
    availability pattern, filled as both packages fill them."""
    n = int(np.prod(shape))
    u, l, ur = (rng.integers(0, 256, (n, 4)) for _ in range(3))
    ul = rng.integers(0, 256, n)
    pats = np.array(np.meshgrid(*[[False, True]] * 3)).reshape(3, -1).T
    a_u, a_l, a_urr = pats[np.arange(n) % len(pats)].T
    a_ur = a_u & a_urr
    a_ul = a_u & a_l
    return [x.astype(np.int32) for x in (u, l, ul, ur)], (a_u, a_l, a_ul, a_ur)


def test_nine_predictors_match_jax(rng):
    """Every predictor on inputs with every availability pattern, including
    values whose sums wrap mod 256 where the operands came from the plane."""
    (u, l, ul, ur), (a_u, a_l, a_ul, a_ur) = _neighbor_inputs(rng, (8, 8))
    fill = 128
    u_f = np.where(a_u[:, None], u, fill)
    l_f = np.where(a_l[:, None], l, fill)
    ul_f = np.where(a_ul, ul, fill)
    ur_f = np.where(a_ur[:, None], ur,
                    np.where(a_u, u[:, 3], fill)[:, None]).astype(np.int32)
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in
         (u_f, l_f, ul_f, ur_f, a_u, a_l, a_ur)]
    got = intra._preds9(*t)
    want = jintra._preds9(*[jnp.asarray(x) for x in
                            (u_f, l_f, ul_f, ur_f, a_u, a_l, a_ur)])
    assert got.shape == (9, len(u), 4, 4)
    _eq(got, want)
    # and the fills themselves, from the reconstruction helper
    f = intra._fill(*[torch.from_numpy(x) for x in (u, l, ul, ur)],
                    *[torch.from_numpy(m) for m in (a_u, a_l, a_ul, a_ur)])
    for g, w_ in zip(f, (u_f, l_f, ul_f, ur_f)):
        _eq(g, w_)


@pytest.mark.parametrize("h,w", [(16, 24), (4, 36), (36, 4), (4, 4)])
def test_plane_neighbors_match_jax(rng, h, w):
    y = rng.integers(0, 256, (h, w)).astype(np.int32)
    got = intra._neighbors(torch.from_numpy(y))
    want = jintra._neighbors(jnp.asarray(y), 4)
    for g, w_ in zip(got[:4], want[:4]):
        _eq(g, w_)
    for g, w_ in zip(got[4], want[4]):
        _eq(g, w_)


@pytest.mark.parametrize("qstep", [8, 24, 64])
def test_core_transform_matches_jax(rng, qstep):
    x = rng.integers(-255, 256, (50, 4, 4)).astype(np.int32)
    coef = intra.core4_fwd(torch.from_numpy(x))
    _eq(coef, jintra.core4_fwd(jnp.asarray(x)))
    q = intra.core4_quant(coef, qstep)
    _eq(q, jintra.core4_quant(jnp.asarray(coef.numpy()), qstep))
    _eq(intra.core4_dequant_inv(q, qstep),
        jintra.core4_dequant_inv(jnp.asarray(q.numpy()), qstep))
    # the rounding is half away from zero, on both signs
    a = torch.tensor([-7, -6, -5, -2, 0, 2, 5, 6, 7], dtype=torch.int32)
    _eq(intra._iround_div(a, 4), [-2, -2, -1, -1, 0, 1, 1, 2, 2])


@pytest.mark.parametrize("kind", ["random", "smooth", "escape"])
def test_lossless_codec_matches_jax_and_roundtrips(rng, kind):
    if kind == "escape":
        planes = np.stack([escape_plane(16, 24)] * 2)
    elif kind == "random":
        planes = _planes(rng, 2, 16, 24)
    else:
        planes = np.cumsum(rng.integers(0, 3, (2, 16, 24)), axis=-1) \
            .clip(0, 255).astype(np.uint8)
    res, modes, esc = intra.luma4x4_codec(torch.from_numpy(planes))
    want = jax.vmap(jintra.luma4x4_codec)(jnp.asarray(planes, jnp.int32))
    for g, w_ in zip((res, modes, esc), want):
        _eq(g, w_)
    assert bool(esc.any()) == (kind == "escape")
    dec = intra.intra_decode4x4_batch(res.to(torch.int16),
                                      modes.to(torch.int8), esc)
    assert dec.dtype == torch.int32
    _eq(dec, planes)
    if kind == "random":
        _eq(dec, jintra.intra_decode4x4_batch(
            jnp.asarray(res.numpy()), jnp.asarray(modes.numpy()),
            jnp.asarray(esc.numpy()), backend="xla"))


def _check_lossy(planes, qstep):
    """The port's lossy encode against the JAX scan; its decode gives back
    its recon. -> the port's (qcoef, modes, escape, recon)."""
    got = intra.intra_encode4x4_lossy_batch(torch.from_numpy(planes), qstep)
    want = jintra.intra_encode4x4_lossy_batch(
        jnp.asarray(planes, jnp.int32), qstep, backend="xla")
    assert [g.dtype for g in got] == [torch.int16, torch.int8, torch.bool,
                                      torch.uint8]
    for g, w_ in zip(got, want):
        _eq(g, w_)
    assert torch.equal(intra.intra_decode4x4_lossy_batch(*got[:3], qstep),
                       got[3])
    assert intra_cuda.LAUNCHES == {"intra_encode": 0, "intra_decode": 0}
    return got


def test_lossy_encode_and_decode_match_jax(rng):
    """(2, 24, 40) at qstep 8, one random plane and one that escapes; the
    decode also against the JAX decode."""
    planes = np.stack([_planes(rng, 1, 24, 40)[0], escape_plane(24, 40)])
    got = _check_lossy(planes, 8)
    assert got[2][1].any() and not got[2][0].any()
    _eq(intra.intra_decode4x4_lossy_batch(*got[:3], 8),
        jintra.intra_decode4x4_lossy_batch(
            *[jnp.asarray(x.numpy()) for x in got[:3]], 8, backend="xla"))


def test_lossy_encode_matches_jax_single_plane(rng):
    _check_lossy(_planes(rng, 1, 16, 16), 24)


def test_lossy_encode_matches_pallas_kernel_interpret(rng):
    """The TPU kernel itself, in interpret mode, as tests/test_intra_pallas.py
    runs it."""
    planes = _planes(rng, 2, 24, 40)
    want = jintra_pallas.encode_lossy_planes(jnp.asarray(planes, jnp.int32),
                                             16, interpret=True)
    got = intra.intra_encode4x4_lossy_batch(torch.from_numpy(planes), 16)
    for g, w_ in zip(got, want):
        _eq(g, w_)


def test_decode_predicts_zero_for_escape_and_foreign_modes(rng):
    """A mode outside 0..8 predicts zero, as the JAX one-hot selection
    does; so does an escape, whatever its mode."""
    res = rng.integers(-40, 40, (2, 16, 24)).astype(np.int16)
    modes = rng.integers(-3, 12, (2, 4, 6)).astype(np.int8)
    esc = rng.random((2, 4, 6)) < 0.3
    got = intra.intra_decode4x4_batch(*map(torch.from_numpy,
                                           (res, modes, esc)))
    want = jintra.intra_decode4x4_batch(jnp.asarray(res, jnp.int32),
                                        jnp.asarray(modes, jnp.int32),
                                        jnp.asarray(esc), backend="xla")
    _eq(got, want)


def test_intra_codec_matches_jax(rng):
    """models/intra_codec: the batched lossy functions flatten (B, C) as the
    JAX ones do (held against the JAX planes' encode of the same flattened
    batch, a shape compiled above), the single-frame ones, and the lossless
    pair, all with the JAX dtypes."""
    frames = _planes(rng, 2, 24, 40).reshape(2, 1, 24, 40)
    pay, rec = intra_codec.encode_intra_frames_lossy_batch(
        torch.from_numpy(frames), 8)
    jq, jm, je, jrec = jintra.intra_encode4x4_lossy_batch(
        jnp.asarray(frames.reshape(2, 24, 40), jnp.int32), 8, backend="xla")
    for g, w_ in zip((*pay, rec), (jq, jm, je, jrec)):
        assert g.shape == (2, 1, *w_.shape[1:])
        _eq(g.reshape(w_.shape), w_)
    assert tuple(jintra_codec.IntraFrameLossy._fields) == pay._fields
    assert (pay.qcoef.dtype, pay.modes.dtype, pay.escape.dtype) == \
        (torch.int16, torch.int8, torch.bool)
    assert torch.equal(intra_codec.decode_intra_frames_lossy_batch(pay, 8),
                       rec)
    one, rec1 = intra_codec.encode_intra_frame_lossy(
        torch.from_numpy(frames[1]), 8)
    assert torch.equal(rec1, rec[1])
    assert torch.equal(intra_codec.decode_intra_frame_lossy(one, 8), rec1)

    lossless = intra_codec.encode_intra_frame(torch.from_numpy(frames[0]))
    jl = jintra_codec.encode_intra_frame(jnp.asarray(frames[0], jnp.int32))
    for g, w_ in zip(lossless, jl):
        _eq(g, w_)
    _eq(intra_codec.decode_intra_frame(lossless), frames[0])


def test_kernel_wrappers_refuse_cpu_tensors(rng):
    planes = torch.from_numpy(_planes(rng, 1, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        intra_cuda.intra_encode(planes, 24)
    q, m, e, _ = intra.intra_encode4x4_lossy_batch(planes, 24)
    with pytest.raises(ValueError, match="CUDA"):
        intra_cuda.intra_decode(q, m, e, 24, True)
    with pytest.raises(ValueError, match="backend"):
        intra.intra_encode4x4_lossy_batch(planes, 24, backend="cuda")
    with pytest.raises(ValueError, match="qstep"):
        intra.intra_encode4x4_lossy_batch(planes, 0)
    with pytest.raises(ValueError, match="multiples of 4"):
        intra.intra_encode4x4_lossy_batch(planes[:, :6], 24)
    assert intra_cuda.LAUNCHES == {"intra_encode": 0, "intra_decode": 0}
