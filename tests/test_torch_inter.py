"""vcs_h264_tpu_torch fused P-frame encode / decode (the plain PyTorch
versions that stand beside the K3 / K4 kernels) against the JAX package on
the CPU.

Encode must give identical int16 coefficients to the JAX production
composition dct_compress_residual_signed(curs - compensate). Decode may
differ by 1 at exact round-at-.5 ties of the inverse transform, on fewer
than 1e-4 of pixels: the bound tests/test_inter_pallas.py holds the TPU
kernel to, since two float32 DCTs that sum in another order differ in the
last bit."""

import numpy as np
import jax.numpy as jnp
import pytest
from jax.experimental import pallas as pl

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu.config import CodecConfig as JaxConfig  # noqa: E402
from vcs_h264_tpu.models import pipeline as jpipeline  # noqa: E402
from vcs_h264_tpu.ops import motion as jmotion  # noqa: E402

from vcs_h264_tpu_torch.ops import inter_cuda  # noqa: E402


def _mk(rng, g, f, h, w, reach=16):
    """Random frames and in-frame vectors within reach, as the search gives."""
    bs = 8
    nbh, nbw = h // bs, w // bs
    refs = rng.integers(0, 256, (g, 3, h, w)).astype(np.uint8)
    curs = rng.integers(0, 256, (g, f, 3, h, w)).astype(np.uint8)
    mv = rng.integers(-reach, reach + 1, (g, f, nbh, nbw, 2))
    ci = np.arange(nbh)[:, None] * bs
    cj = np.arange(nbw)[None, :] * bs
    mv[..., 1] = np.clip(mv[..., 1], -ci, h - bs - ci)
    mv[..., 0] = np.clip(mv[..., 0], -cj, w - bs - cj)
    return mv.astype(np.int32), refs, curs


def _jax_encode(mv, refs, curs, qf):
    cfg = JaxConfig.production(quality_factor=qf)
    recon = jmotion.motion_compensate_gops(
        jnp.asarray(mv), jnp.asarray(refs, jnp.int32), bs=8, reach=16,
        backend="xla")
    return recon, np.asarray(jpipeline.dct_compress_residual_signed(
        jnp.asarray(curs, jnp.int32) - recon, cfg))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("h,w,qf", [(64, 128, 50.0), (48, 64, 90.0),
                                    (96, 160, 10.0)])
def test_encode_decode_match_jax(rng, h, w, qf):
    mv, refs, curs = _mk(rng, 2, 3, h, w)
    recon, want = _jax_encode(mv, refs, curs, qf)
    got = inter_cuda.encode_p_coeffs(*_t(mv, refs, curs), qf)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)

    cfg = JaxConfig.production(quality_factor=qf)
    want_d = np.asarray(jnp.clip(
        recon + jpipeline.dct_decompress_residual_signed(jnp.asarray(want),
                                                         cfg), 0, 255))
    got_d = inter_cuda.decode_p_frames(*_t(mv, refs, want), qf)
    assert got_d.dtype == torch.uint8
    diff = np.abs(got_d.numpy().astype(np.int64) - want_d)
    assert diff.max() <= 1
    assert (diff != 0).mean() < 1e-4
    assert not any(inter_cuda.LAUNCHES.values())


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    import vcs_h264_tpu.ops.inter_pallas as IP
    monkeypatch.setattr(IP.pl, "pallas_call", patched)
    return IP


def test_encode_matches_pallas_kernel_interpret(rng, interpret_pallas):
    """The TPU kernel itself (interpret mode) gives the same coefficients,
    with a mix of static and moving block rows (its fast path)."""
    mv, refs, curs = _mk(rng, 2, 3, 64, 128)
    mv[:, :, ::2] = 0
    want = np.asarray(interpret_pallas.encode_p_coeffs_fused(
        jnp.asarray(mv), jnp.asarray(refs, jnp.int32),
        jnp.asarray(curs, jnp.int32), 8, 16, 50.0))
    got = inter_cuda.encode_p_coeffs(*_t(mv, refs, curs), 50.0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_single_frame_gops_and_roundtrip_quality(rng):
    """F = 1 (a tail GOP's shape); zero residual codes to zero coefficients
    and decodes back to the prediction exactly."""
    mv, refs, _ = _mk(rng, 1, 1, 48, 64)
    pred = inter_cuda.motion_compensate_gops(*_t(mv, refs), bs=8)
    co = inter_cuda.encode_p_coeffs(*_t(mv, refs), pred, 50.0)
    assert not co.any()
    dec = inter_cuda.decode_p_frames(*_t(mv, refs), co, 50.0)
    assert torch.equal(dec, pred)


def test_kernel_wrappers_refuse_cpu_tensors(rng):
    mv, refs, curs = _mk(rng, 1, 1, 16, 16)
    co = torch.zeros(curs.shape, dtype=torch.int16)
    with pytest.raises(ValueError, match="CUDA"):
        inter_cuda.fused_p_encode(*_t(mv, refs, curs), 50.0)
    with pytest.raises(ValueError, match="CUDA"):
        inter_cuda.fused_p_decode(*_t(mv, refs), co, 50.0)
    with pytest.raises(ValueError, match="backend"):
        inter_cuda.decode_p_frames(*_t(mv, refs), co, 50.0, backend="cuda")
    assert not any(inter_cuda.LAUNCHES.values())
