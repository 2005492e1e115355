"""vcs_h264_tpu_torch ops against the JAX package on the CPU: the config,
blocks, DCT and quantization tables."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu.config import CodecConfig as JaxConfig  # noqa: E402
from vcs_h264_tpu.ops import blocks as jblocks  # noqa: E402
from vcs_h264_tpu.ops import dct as jdct  # noqa: E402
from vcs_h264_tpu.ops import quant as jquant  # noqa: E402

from vcs_h264_tpu_torch.config import CodecConfig  # noqa: E402
from vcs_h264_tpu_torch.ops import blocks, dct, quant  # noqa: E402


def test_config_fields_and_defaults_match_jax():
    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert spec(CodecConfig) == spec(JaxConfig)
    for preset in ("reference", "production", "bframes"):
        assert (dataclasses.asdict(getattr(CodecConfig, preset)())
                == dataclasses.asdict(getattr(JaxConfig, preset)()))
    cfg = CodecConfig.bframes()
    jcfg = JaxConfig.bframes()
    for prop in ("gop_len", "frames_per_gop_p", "has_b", "num_b"):
        assert getattr(cfg, prop) == getattr(jcfg, prop)


@pytest.mark.parametrize("kwargs", [
    dict(block_size=1), dict(block_size=4), dict(gop_pattern=("P", "I")),
    dict(gop_pattern=("I", "X")), dict(gop_pattern=("I", "P", "I")),
    dict(gop_pattern=("I", "B")), dict(quality_factor=0),
    dict(quant_mode="other"), dict(intra_qstep=300), dict(intra_qstep=4),
    dict(chroma_420=True),
])
def test_config_validation_matches_jax(kwargs):
    with pytest.raises(ValueError):
        JaxConfig(**kwargs)
    with pytest.raises(ValueError):
        CodecConfig(**kwargs)


@pytest.mark.parametrize("kwargs", [
    dict(), dict(quant_mode="rounded", with_dct=False, block_size=8),
    dict(quant_mode="rounded", gop_pattern=("I", "B", "P")),
    dict(quant_mode="rounded", with_residual=False),
    dict(quant_mode="rounded", chroma_420=True),
    dict(quant_mode="rounded", search_luma_only=True),
    dict(quant_mode="rounded", signed_residual=False),
])
def test_ported_modes_are_supported(kwargs, rng, tmp_path):
    """Reference mode, no DCT, B patterns, no residual, 4:2:0, the
    luma-only search and the legacy unsigned residual: supported, and a tiny
    encode -> .npz -> decode gives every frame back (a full GOP and an
    I-frame-only tail)."""
    from vcs_h264_tpu_torch.models import Decoder, EncodedVideo, Encoder
    cfg = CodecConfig(**kwargs)
    frames = [rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
              for _ in range(cfg.gop_len + 1)]
    Encoder(cfg, device="cpu").encode_frames(frames).save_npz(
        str(tmp_path / "v.npz"))
    out = Decoder(device="cpu").decode(EncodedVideo.load_npz(
        str(tmp_path / "v.npz")))
    assert len(out) == len(frames)
    assert all(f.shape == (16, 16, 3) and f.dtype == np.uint8 for f in out)


def test_production_slice_is_supported():
    from vcs_h264_tpu_torch.models import Decoder, Encoder
    for cfg in (CodecConfig.production(),
                CodecConfig.production(quality_factor=90.0,
                                       gop_pattern=("I", "P")),
                CodecConfig.production(intra_qstep=24)):
        assert Encoder(cfg, device="cpu").cfg == cfg
    assert Decoder(device="cpu").device.type == "cpu"


def test_blocks_match_jax(rng):
    x = rng.integers(-300, 300, (2, 3, 16, 24)).astype(np.int32)
    got = blocks.plane_to_blocks(torch.from_numpy(x), 8)
    want = np.asarray(jblocks.plane_to_blocks(jnp.asarray(x), 8))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(blocks.blocks_to_plane(got).numpy(), x)
    with pytest.raises(ValueError):
        blocks.plane_to_blocks(torch.zeros(3, 12, 16), 8)


def test_dct_matches_jax(rng):
    np.testing.assert_array_equal(dct.dct_matrix_np(8), jdct.dct_matrix_np(8))
    x = rng.normal(0, 60, (3, 6, 8, 8, 8)).astype(np.float32)
    got = dct.dct2_blocks(torch.from_numpy(x)).numpy()
    want = np.asarray(jdct.dct2_blocks(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    got_i = dct.idct2_blocks(torch.from_numpy(got)).numpy()
    want_i = np.asarray(jdct.idct2_blocks(jnp.asarray(want)))
    np.testing.assert_allclose(got_i, want_i, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_i, x, atol=1e-3, rtol=0)


@pytest.mark.parametrize("qf", [10.0, 50.0, 90.0])
def test_quant_tables_match_jax(qf):
    assert quant.qf_scale(qf) == jquant.qf_scale(qf)
    for got, want in zip(quant.quant_tables_np(qf), jquant.quant_tables_np(qf)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(quant.quant_tables(qf).numpy(),
                                  np.asarray(jquant.quant_tables(qf)))
