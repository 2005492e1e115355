"""Reference-parity mode of vcs_h264_tpu_torch against the JAX package on the
CPU: `CodecConfig()` (wrap residual, cv2 YCrCb, unrounded DCT
coefficients), `with_dct=False` at the swept block sizes, and
`with_residual=False`, through Encoder.encode_frames -> .npz ->
Decoder.decode, each package's stream decoded by the other.

Vectors, wrap residuals and decoded frames are integers and must be
identical. The reference-mode coefficients are float32 DCT outputs summed
in another order than XLA sums them, so they agree within 1e-3 (they are
~1e-5 apart); decode rounds values that sit within ~1e-4 of integers, so
the frames are identical all the same."""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu.config import CodecConfig as JaxConfig  # noqa: E402
from vcs_h264_tpu.models import pipeline as jpipeline  # noqa: E402
from vcs_h264_tpu.models.decoder import Decoder as JaxDecoder  # noqa: E402
from vcs_h264_tpu.models.encoder import Encoder as JaxEncoder  # noqa: E402
from vcs_h264_tpu.models.gop import EncodedGOP as JaxGOP  # noqa: E402
from vcs_h264_tpu.models.gop import EncodedVideo as JaxVideo  # noqa: E402

from vcs_h264_tpu_torch import CodecConfig  # noqa: E402
from vcs_h264_tpu_torch.interop import from_jax_video, to_numpy_video  # noqa: E402
from vcs_h264_tpu_torch.models import Decoder, EncodedVideo, Encoder  # noqa: E402
from vcs_h264_tpu_torch.models import pipeline  # noqa: E402
from vcs_h264_tpu_torch.ops import color, dct, inter_cuda, motion_cuda  # noqa: E402

from test_torch_pipeline import _clip  # noqa: E402

COEF_ATOL = 1e-3      # float32 DCT sums in another order: ~1e-5 apart


def assert_same_stream(port, jax_video, res_dtype):
    """Integer fields identical; float coefficients within COEF_ATOL."""
    assert len(port.gops) == len(jax_video.gops)
    for a, b in zip(port.gops, jax_video.gops):
        np.testing.assert_array_equal(a.i_frame.numpy(), np.asarray(b.i_frame))
        np.testing.assert_array_equal(a.mv.numpy(), np.asarray(b.mv))
        for k in ("residuals", "b_mv", "b_mode", "b_residuals"):
            x, y = getattr(a, k), getattr(b, k)
            assert (x is None) == (y is None), k
            if x is None:
                continue
            y = np.asarray(y)
            if k.endswith("residuals"):
                assert x.dtype == res_dtype, k
                if res_dtype == torch.float32:
                    np.testing.assert_allclose(x.numpy(), y, atol=COEF_ATOL,
                                               rtol=0)
                    continue
            np.testing.assert_array_equal(x.numpy(), y)


def assert_same_frames(got, want):
    assert len(got) == len(want)
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


def cross_decode(port, jvid, tmp_path):
    """Each package loads and decodes the other's .npz; both give the frames
    the writer's own decoder gives. Returns the port's decoded frames."""
    dec = Decoder(device="cpu").decode(port)
    port.save_npz(tmp_path / "port.npz")
    jvid.save_npz(str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
    assert_same_frames(JaxDecoder().decode(
        JaxVideo.load_npz(str(tmp_path / "port.npz"))), dec)
    from_jax_file = EncodedVideo.load_npz(str(tmp_path / "jax.npz"))
    assert_same_frames(Decoder(device="cpu").decode(from_jax_file),
                       JaxDecoder().decode(jvid))
    return dec


@pytest.mark.parametrize("n_frames", [10, 9])
def test_reference_mode_matches_jax(rng, tmp_path, n_frames):
    """CodecConfig(): two full IPPP GOPs plus a tail GOP (I + 1 P, or the
    I-frame alone). Vectors identical, coefficients float32 within
    COEF_ATOL, decoded frames identical to the JAX decode, across the .npz
    both ways and in memory."""
    frames = _clip(rng, n_frames, 48, 64)
    port = Encoder(CodecConfig(), device="cpu", gop_batch=2).encode_frames(frames)
    jvid = JaxEncoder(JaxConfig(), gop_batch=2).encode_frames(frames)
    assert_same_stream(port, jvid, torch.float32)
    assert any(g.mv.any() for g in port.gops), "search found no motion"
    dec = cross_decode(port, jvid, tmp_path)
    assert_same_frames(dec, JaxDecoder().decode(jvid))
    p_psnr = np.mean([10 * np.log10(255**2 / max(1e-9, np.mean(
        (dec[i].astype(float) - frames[i]) ** 2)))
        for i in range(n_frames) if i % 4])
    assert p_psnr > 30.0

    assert_same_stream(from_jax_video(jvid), jvid, torch.float32)
    back = to_numpy_video(port)
    rebuilt = JaxVideo(JaxConfig(**back["config"]), back["height"],
                       back["width"], back["fps"], back["num_frames"],
                       [JaxGOP(**g) for g in back["gops"]])
    assert_same_frames(JaxDecoder().decode(rebuilt), dec)
    assert motion_cuda.LAUNCHES == {"sad_search": 0, "compensate": 0}
    assert not any(inter_cuda.LAUNCHES.values())


@pytest.mark.parametrize("bs", [4, 8, 16])
def test_no_dct_matches_jax_and_is_lossless(rng, tmp_path, bs):
    """with_dct=False at the reference's swept block sizes (reach 2 bs,
    step round(bs / 3)): uint8 wrap residuals identical to the JAX
    package's, and the wrap makes the decode lossless."""
    frames = _clip(rng, 6, 6 * bs, 8 * bs)
    kw = dict(block_size=bs, with_dct=False, search_reach=2 * bs,
              search_step=max(1, round(bs / 3)))
    port = Encoder(CodecConfig(**kw), device="cpu").encode_frames(frames)
    jvid = JaxEncoder(JaxConfig(**kw)).encode_frames(frames)
    assert_same_stream(port, jvid, torch.uint8)
    dec = cross_decode(port, jvid, tmp_path)
    assert_same_frames(dec, frames)


@pytest.mark.parametrize("with_dct", [True, False])
def test_no_residual_matches_jax(rng, tmp_path, with_dct):
    """with_residual=False: the P-frames are the compensation alone."""
    frames = _clip(rng, 6, 48, 64)
    cfg = dict(with_residual=False, with_dct=with_dct)
    port = Encoder(CodecConfig(**cfg), device="cpu").encode_frames(frames)
    jvid = JaxEncoder(JaxConfig(**cfg)).encode_frames(frames)
    assert all(g.residuals is None for g in port.gops)
    assert_same_stream(port, jvid, None)
    dec = cross_decode(port, jvid, tmp_path)
    assert_same_frames(dec, JaxDecoder().decode(jvid))
    np.testing.assert_array_equal(dec[0], frames[0])


@pytest.mark.parametrize("quant_mode", ["reference", "rounded"])
def test_dct_residual_functions_match_jax(rng, quant_mode):
    """dct_compress_residual / dct_decompress_residual on wrap residuals,
    both quant modes: coefficients within COEF_ATOL (rounded: identical),
    and the decompress of the same coefficients identical."""
    cfg = CodecConfig(quant_mode=quant_mode)
    jcfg = JaxConfig(quant_mode=quant_mode)
    resid = rng.integers(0, 256, (2, 3, 16, 24))
    got = pipeline.dct_compress_residual(torch.from_numpy(resid), cfg)
    want = np.asarray(jpipeline.dct_compress_residual(
        jnp.asarray(resid, jnp.int32), jcfg))
    if quant_mode == "rounded":
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=COEF_ATOL, rtol=0)
    dec = pipeline.dct_decompress_residual(torch.from_numpy(want.copy()), cfg)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(
        jpipeline.dct_decompress_residual(jnp.asarray(want), jcfg)))
    if quant_mode == "reference":
        # unrounded quant gives back the YCrCb planes exactly, so the
        # residual comes back through the cv2 round trip alone
        np.testing.assert_array_equal(dec.numpy(), color.ycrcb_to_bgr_planes(
            color.bgr_to_ycrcb_planes(torch.from_numpy(resid))).numpy())


def test_dct_takes_no_matmul(rng, monkeypatch):
    """The DCT is written as ordered multiplies and adds, so no TF32 or
    float32-matmul-precision setting can reach it; it still equals the
    matrix products."""
    x = torch.from_numpy(rng.normal(0, 60, (4, 8, 8)).astype(np.float32))
    d = dct.dct_matrix(8)
    want = (d @ x @ d.T, d.T @ x @ d)

    def no_matmul(*args, **kwargs):
        raise AssertionError("the DCT must not call a matmul")

    monkeypatch.setattr(torch, "matmul", no_matmul)
    monkeypatch.setattr(torch.Tensor, "__matmul__", no_matmul)
    for got, w in zip((dct.dct2_blocks(x), dct.idct2_blocks(x)), want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), atol=1e-4, rtol=0)
