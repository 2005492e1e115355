"""The plain PyTorch versions that stand beside the bare-plane kernels of
vcs_h264_tpu_torch (K7, the fused 4:2:0 chroma encode / decode, and the
C == 1 case of K3 / K4 on the luma plane) against the JAX package on the CPU:
its XLA composition and its Pallas kernels in interpret mode.

Tolerances. A bare plane's residual is an integer, so the DC term sum/8/Q
lands on exact .5 ties, and two float32 DCTs that sum in another order round
some of them apart. The JAX package holds its own backends to +-1 on fewer
than 1e-3 of coefficients and 1e-4 of decoded samples
(tests/test_inter_pallas.py:161-169, 209-219); the same bounds hold here,
with the measured share printed. On residuals of small amplitude (|r| <= 6
at QF 50) no tie is hit and the coefficients are identical.

The numpy emulation of the CUDA strip kernels themselves
(`test_torch_kernel_identities.strip_kernel`) is held here against both
references: identical to the plain versions, within the same bounds of the
XLA composition."""

import numpy as np
import jax.numpy as jnp
import pytest
from jax.experimental import pallas as pl

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu.models import pipeline420 as jp420  # noqa: E402
from vcs_h264_tpu.ops import motion as jmotion  # noqa: E402
from vcs_h264_tpu.ops.quant import quant_tables as jquant_tables  # noqa: E402

from vcs_h264_tpu_torch.models import pipeline420  # noqa: E402
from vcs_h264_tpu_torch.ops import inter_cuda  # noqa: E402

from test_torch_kernel_identities import strip_kernel  # noqa: E402

COEF_SHARE = 1e-3       # +-1 on fewer coefficients than this
PIXEL_SHARE = 1e-4      # +-1 on fewer decoded samples than this


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    import vcs_h264_tpu.ops.inter_pallas as IP
    monkeypatch.setattr(IP.pl, "pallas_call", patched)
    return IP


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _planes(rng, g, f, c, h, w, cell, reach, small=False):
    """Reference and current planes uint8 [g, c, h, w] / [g, f, c, h, w] and
    in-frame vectors within `reach` on `cell`-pixel cells, as the search (or
    its halved vectors) gives them; two all-static cell rows. `small`: the
    current planes sit within +-6 of the reference, so every residual is
    small whatever the vector."""
    if small:
        refs = rng.integers(100, 107, (g, c, h, w)).astype(np.uint8)
        curs = rng.integers(100, 107, (g, f, c, h, w)).astype(np.uint8)
    else:
        refs = rng.integers(0, 256, (g, c, h, w)).astype(np.uint8)
        curs = rng.integers(0, 256, (g, f, c, h, w)).astype(np.uint8)
    nh, nw = h // cell, w // cell
    mv = rng.integers(-reach, reach + 1, (g, f, nh, nw, 2))
    ci = np.arange(nh)[:, None] * cell
    cj = np.arange(nw)[None, :] * cell
    mv[..., 1] = np.clip(mv[..., 1], -ci, h - cell - ci)
    mv[..., 0] = np.clip(mv[..., 0], -cj, w - cell - cj)
    mv[:, :, :2] = 0
    return mv.astype(np.int32), refs, curs


def _i32(x):
    return jnp.asarray(x, jnp.int32)


def _xla_c420(mv_c, c_refs, c_curs, qf):
    """The JAX package's XLA composition for chroma: the gather on 4-pixel
    cells, then _code_planes / _decode_planes with the chroma table."""
    qc = jquant_tables(qf, jnp.float32)[1]
    pred = jmotion.motion_compensate_gops(_i32(mv_c), _i32(c_refs), bs=4,
                                          reach=8, backend="jnp")
    co = jp420._code_planes(_i32(c_curs) - pred, qc, 8)
    dec = jnp.clip(pred + jp420._decode_planes(co, qc, 8), 0, 255)
    return np.asarray(co), np.asarray(dec)


def _xla_luma(mv, y_ref, y_cur, qf):
    qy = jquant_tables(qf, jnp.float32)[0]
    pred = jmotion.motion_compensate_gops(_i32(mv), _i32(y_ref), bs=8,
                                          reach=16, backend="xla")
    co = jp420._code_planes(_i32(y_cur) - pred, qy, 8)
    dec = jnp.clip(pred + jp420._decode_planes(co, qy, 8), 0, 255)
    return np.asarray(co), np.asarray(dec)


def _close(got, want, share, what):
    d = np.abs(np.asarray(got).astype(np.int64) - np.asarray(want))
    frac = float((d != 0).mean())
    print(f"{what}: max |diff| {d.max()}, differing share {frac:.3e} "
          f"(limit 1, {share:g})")
    assert d.max() <= 1 and frac < share, (what, d.max(), frac)


@pytest.mark.parametrize("hc,wc,qf", [(32, 64, 50.0), (48, 64, 75.0),
                                      (8, 8, 50.0), (24, 40, 20.0)])
def test_c420_plain_matches_xla(rng, hc, wc, qf):
    """Plain K7 against the XLA composition at chroma 32x64 and 48x64, on
    one transform block, and at a width no TPU kernel takes."""
    mv_c, c_refs, c_curs = _planes(rng, 2, 3, 2, hc, wc, 4, 8)
    want_co, want_dec = _xla_c420(mv_c, c_refs, c_curs, qf)
    got = inter_cuda.encode_c420_coeffs(*_t(mv_c, c_refs, c_curs), qf)
    assert got.dtype == torch.int16 and tuple(got.shape) == c_curs.shape
    _close(got.numpy(), want_co, COEF_SHARE, "K7 encode vs XLA")
    got_d = inter_cuda.decode_c420_frames(*_t(mv_c, c_refs, want_co), qf)
    assert got_d.dtype == torch.uint8
    _close(got_d.numpy(), want_dec, PIXEL_SHARE, "K7 decode vs XLA")
    assert not any(inter_cuda.LAUNCHES.values())


@pytest.mark.parametrize("hc,wc,qf", [(32, 64, 50.0), (48, 64, 75.0)])
def test_c420_plain_matches_pallas_kernel_interpret(rng, interpret_pallas,
                                                    hc, wc, qf):
    """Plain K7 against the TPU kernel itself (interpret mode), under the
    bound tests/test_inter_pallas.py:209-219 holds that kernel to."""
    IP = interpret_pallas
    mv_c, c_refs, c_curs = _planes(rng, 2, 3, 2, hc, wc, 4, 8)
    want = np.asarray(IP.encode_c420_coeffs_fused(
        _i32(mv_c), _i32(c_refs), _i32(c_curs), 8, 8, qf))
    got = inter_cuda.encode_c420_coeffs(*_t(mv_c, c_refs, c_curs), qf)
    _close(got.numpy(), want, COEF_SHARE, "K7 encode vs Pallas")
    want_d = np.asarray(IP.decode_c420_frames_fused(
        _i32(mv_c), _i32(c_refs), jnp.asarray(want), 8, 8, qf))
    got_d = inter_cuda.decode_c420_frames(*_t(mv_c, c_refs, want), qf)
    _close(got_d.numpy(), want_d, COEF_SHARE, "K7 decode vs Pallas")


@pytest.mark.parametrize("h,w,qf", [(64, 128, 50.0), (48, 64, 90.0)])
def test_luma_plane_plain_matches_xla_and_pallas(rng, interpret_pallas, h, w,
                                                 qf):
    """The C == 1 case of K3 / K4 through the same entry points as C == 3:
    against the XLA composition and the TPU kernel in interpret mode."""
    IP = interpret_pallas
    mv, y_ref, y_cur = _planes(rng, 2, 3, 1, h, w, 8, 16)
    want_co, want_dec = _xla_luma(mv, y_ref, y_cur, qf)
    got = inter_cuda.encode_p_coeffs(*_t(mv, y_ref, y_cur), qf)
    assert got.dtype == torch.int16 and tuple(got.shape) == y_cur.shape
    _close(got.numpy(), want_co, COEF_SHARE, "luma encode vs XLA")
    got_d = inter_cuda.decode_p_frames(*_t(mv, y_ref, want_co), qf)
    assert got_d.dtype == torch.uint8
    _close(got_d.numpy(), want_dec, PIXEL_SHARE, "luma decode vs XLA")
    pal = np.asarray(IP.encode_p_coeffs_fused(
        _i32(mv), _i32(y_ref), _i32(y_cur), 8, 16, qf))
    _close(got.numpy(), pal, COEF_SHARE, "luma encode vs Pallas")
    pal_d = np.asarray(IP.decode_p_frames_fused(
        _i32(mv), _i32(y_ref), jnp.asarray(want_co), 8, 16, qf))
    _close(got_d.numpy(), pal_d, PIXEL_SHARE, "luma decode vs Pallas")


def test_small_residuals_code_identically(rng):
    """|residual| <= 6 at QF 50: no coefficient of this seeded input sits
    on a tie, so both plane kinds give the JAX package's coefficients
    exactly, and they are not all 0."""
    mv_c, c_refs, c_curs = _planes(rng, 2, 2, 2, 32, 64, 4, 8, small=True)
    want, _ = _xla_c420(mv_c, c_refs, c_curs, 50.0)
    got = inter_cuda.encode_c420_coeffs(*_t(mv_c, c_refs, c_curs), 50.0)
    np.testing.assert_array_equal(got.numpy(), want)
    mv, y_ref, y_cur = _planes(rng, 2, 2, 1, 32, 64, 8, 16, small=True)
    want_y, _ = _xla_luma(mv, y_ref, y_cur, 50.0)
    got_y = inter_cuda.encode_p_coeffs(*_t(mv, y_ref, y_cur), 50.0)
    np.testing.assert_array_equal(got_y.numpy(), want_y)
    assert want.any() and want_y.any()


def test_chroma_mv_is_a_floor_division():
    mv = np.array([-33, -4, -3, -2, -1, 0, 1, 2, 3, 33], np.int32)
    got = pipeline420._chroma_mv(torch.from_numpy(mv))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jp420._chroma_mv(jnp.asarray(mv))))
    np.testing.assert_array_equal(
        got.numpy(), [-17, -2, -2, -1, -1, 0, 0, 1, 1, 16])


def test_out_of_frame_chroma_vectors_follow_the_xla_gather(rng):
    """Odd, negative and far out-of-frame vectors (up to three extents past
    every edge), each plane placed on its own [Hc, Wc] with extent 4: the
    prediction inside K7's plain version is the XLA gather's, so the
    coefficients keep the bound and the zero-coefficient decode is the
    gather itself."""
    g, f, hc, wc = 2, 2, 16, 24
    c_refs = rng.integers(0, 256, (g, 2, hc, wc)).astype(np.uint8)
    c_curs = rng.integers(0, 256, (g, f, 2, hc, wc)).astype(np.uint8)
    mv_c = rng.integers(-3 * wc, 3 * wc + 1,
                        (g, f, hc // 4, wc // 4, 2)).astype(np.int32)
    mv_c[0, 0, 0, :, 0] = [-1, -3, -5, -wc - 3, wc, 3 * wc]
    mv_c[0, 0, :, 0, 1] = [-1, -3, -hc - 3, 3 * hc]
    pred = np.asarray(jmotion.motion_compensate_gops(
        _i32(mv_c), _i32(c_refs), bs=4, reach=8, backend="jnp"))
    zero = np.zeros(c_curs.shape, np.int16)
    dec = inter_cuda.decode_c420_frames(*_t(mv_c, c_refs, zero), 50.0)
    np.testing.assert_array_equal(dec.numpy(), pred)
    want, _ = _xla_c420(mv_c, c_refs, c_curs, 50.0)
    got = inter_cuda.encode_c420_coeffs(*_t(mv_c, c_refs, c_curs), 50.0)
    _close(got.numpy(), want, COEF_SHARE, "K7 encode, out-of-frame vectors")


def test_zero_residual_roundtrips_exactly(rng):
    """F = 1 (a tail GOP's shape): a frame equal to its prediction codes to
    zero coefficients and decodes back exactly, on both plane kinds."""
    mv_c, c_refs, _ = _planes(rng, 1, 1, 2, 16, 16, 4, 8)
    zero = torch.zeros((1, 1, 2, 16, 16), dtype=torch.int16)
    pred = inter_cuda.decode_c420_frames(*_t(mv_c, c_refs), zero, 50.0)
    co = inter_cuda.encode_c420_coeffs(*_t(mv_c, c_refs), pred, 50.0)
    assert not co.any()
    mv, y_ref, _ = _planes(rng, 1, 1, 1, 16, 16, 8, 16)
    pred_y = inter_cuda.decode_p_frames(*_t(mv, y_ref), zero[:, :, :1], 50.0)
    assert not inter_cuda.encode_p_coeffs(*_t(mv, y_ref), pred_y, 50.0).any()


def test_bare_plane_wrappers_refuse_cpu_tensors(rng):
    """On a CPU tensor a kernel wrapper raises; only the dispatchers choose
    the plain version, and only for a CPU tensor or backend="plain"."""
    mv_c, c_refs, c_curs = _planes(rng, 1, 1, 2, 16, 16, 4, 8)
    mv, y_ref, y_cur = _planes(rng, 1, 1, 1, 16, 16, 8, 16)
    co_c = torch.zeros(c_curs.shape, dtype=torch.int16)
    co_y = torch.zeros(y_cur.shape, dtype=torch.int16)
    for fn, args in ((inter_cuda.c420_encode, _t(mv_c, c_refs, c_curs)),
                     (inter_cuda.c420_decode, _t(mv_c, c_refs) + [co_c]),
                     (inter_cuda.plane_encode, _t(mv, y_ref, y_cur)),
                     (inter_cuda.plane_decode, _t(mv, y_ref) + [co_y])):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args, 50.0)
    with pytest.raises(ValueError, match="backend"):
        inter_cuda.encode_c420_coeffs(*_t(mv_c, c_refs, c_curs), 50.0,
                                      backend="cuda")
    same = inter_cuda.encode_c420_coeffs(*_t(mv_c, c_refs, c_curs), 50.0,
                                         backend="plain")
    assert torch.equal(same, inter_cuda.encode_c420_coeffs(
        *_t(mv_c, c_refs, c_curs), 50.0))
    assert not any(inter_cuda.LAUNCHES.values())


@pytest.mark.parametrize("c,cell,h,w,qf", [(1, 8, 16, 168, 50.0),
                                           (2, 4, 16, 136, 50.0),
                                           (1, 8, 8, 136, 90.0),
                                           (2, 4, 24, 264, 20.0)])
def test_strip_kernel_emulation_matches_plain_and_xla(rng, c, cell, h, w, qf):
    """The bridge from the kernel's own arithmetic to the reference: the
    numpy emulation of csrc/inter_plane.cu's strip kernels
    (`strip_kernel`: CTA by CTA, the exchange buffer, the register passes,
    the thread-by-thread reference rows), on planes whose last strip of 16
    blocks is partly filled, is identical to the plain versions and within
    the contract (+-1 on fewer than 1e-3 of coefficients, 1e-4 of samples)
    of the JAX package's XLA composition."""
    mv, refs, curs = _planes(rng, 2, 2, c, h, w, cell, 2 * cell)
    co = strip_kernel(mv, refs, curs, qf, cell, decode=False)
    plain_enc, plain_dec, xla = (
        (inter_cuda.encode_p_coeffs_plain, inter_cuda.decode_p_frames_plain,
         _xla_luma) if c == 1 else
        (inter_cuda.encode_c420_coeffs_plain,
         inter_cuda.decode_c420_frames_plain, _xla_c420))
    np.testing.assert_array_equal(co, plain_enc(*_t(mv, refs, curs), qf)
                                  .numpy())
    dec = strip_kernel(mv, refs, co, qf, cell, decode=True)
    np.testing.assert_array_equal(dec, plain_dec(*_t(mv, refs, co), qf)
                                  .numpy())
    want_co, want_dec = xla(mv, refs, curs, qf)
    _close(co, want_co, COEF_SHARE, f"strip emulation C {c} encode vs XLA")
    got_dec = strip_kernel(mv, refs, want_co.astype(np.int16), qf, cell,
                           decode=True)
    _close(got_dec, want_dec, PIXEL_SHARE,
           f"strip emulation C {c} decode vs XLA")
