"""B-frames in vcs_h264_tpu_torch against the JAX package on the CPU: the GOP
layout, the per-block mode decision with its tie rule, reference-mode and
production B streams through Encoder.encode_frames -> .npz ->
Decoder.decode, a tail GOP coded all-P, and the B keys of the `.npz`
container loaded by each package from the other's file."""

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
from vcs_h264_tpu_torch.ops import inter_cuda, motion_cuda  # noqa: E402

from test_torch_pipeline import _assert_close_frames, _clip  # noqa: E402
from test_torch_reference import (assert_same_frames,  # noqa: E402
                                  assert_same_stream, cross_decode)

IBPBPBP = ("I", "B", "P", "B", "P", "B", "P")


@pytest.mark.parametrize("pattern", [
    IBPBPBP, ("I", "B", "P"), ("I", "P", "P", "P"), ("I", "B", "B", "P"),
    ("I", "P", "B", "P", "B", "B", "P"), ("I",),
])
def test_gop_layout_matches_jax(pattern):
    assert pipeline.gop_layout(pattern) == jpipeline.gop_layout(pattern)


def test_mode_select_ties_pick_the_lower_mode():
    """Built ties: all three modes equal (0 wins) and backward == average <
    forward (1 wins), in both packages, beside blocks without a tie."""
    bs, h, w = 4, 8, 8
    b = np.full((1, 3, h, w), 100, np.int32)
    f = b.copy()
    bk = b.copy()
    # block (0, 1): forward 4 off, backward exact, average 2 off -> 1
    f[..., 0:4, 4:8] = 96
    # block (1, 0): forward exact, backward 4 off -> forward 0 (no tie)
    bk[..., 4:8, 0:4] = 104
    # block (1, 1): forward 2 below, backward 2 above: the average is exact
    # and beats both -> 2
    f[..., 4:8, 4:8] = 98
    bk[..., 4:8, 4:8] = 102
    # block (0, 0): all three exact -> 0
    jm, jp = jpipeline._b_mode_select(jnp.asarray(b), jnp.asarray(f),
                                      jnp.asarray(bk), bs)
    mode, pred = pipeline._b_mode_select(
        *(torch.from_numpy(x.astype(np.uint8)) for x in (b, f, bk)), bs)
    assert mode.dtype == torch.int8 and pred.dtype == torch.uint8
    np.testing.assert_array_equal(mode.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(mode.numpy()[0], [[0, 1], [0, 2]])
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jp))
    # forward 3 off, backward and average 1 off each: a tie of 1 and 2 -> 1
    b2 = np.full_like(b, 99)
    f2 = np.full_like(b, 96)
    bk2 = np.full_like(b, 100)
    mode2, _ = pipeline._b_mode_select(
        *(torch.from_numpy(x.astype(np.uint8)) for x in (b2, f2, bk2)), bs)
    jm2, _ = jpipeline._b_mode_select(jnp.asarray(b2), jnp.asarray(f2),
                                      jnp.asarray(bk2), bs)
    np.testing.assert_array_equal(mode2.numpy(), np.asarray(jm2))
    assert (mode2 == 1).all()


def test_bframes_reference_mode_matches_jax(rng, tmp_path):
    """CodecConfig.bframes(): two full IBPBPBP GOPs and a 3-frame tail coded
    all-P. b_mv and b_mode identical, coefficients float32 within 1e-3,
    decoded frames identical, across the .npz both ways and in memory."""
    frames = _clip(rng, 17, 32, 48)
    port = Encoder(CodecConfig.bframes(), device="cpu",
                   gop_batch=2).encode_frames(frames)
    jvid = JaxEncoder(JaxConfig.bframes(), gop_batch=2).encode_frames(frames)
    assert [(g.num_p, g.num_b) for g in port.gops] == [(3, 3), (3, 3), (2, 0)]
    assert [g.num_coded for g in port.gops] == [7, 7, 3]
    g0 = port.gops[0]
    assert g0.b_mv.shape == (3, 2, 4, 6, 2) and g0.b_mv.dtype == torch.int32
    assert g0.b_mode.shape == (3, 4, 6) and g0.b_mode.dtype == torch.int8
    assert g0.b_residuals.shape == (3, 3, 32, 48)
    assert port.gops[-1].b_mv is None and port.gops[-1].b_residuals is None
    assert_same_stream(port, jvid, torch.float32)
    assert any(g.b_mode.unique().numel() > 1 for g in port.gops[:2])
    dec = cross_decode(port, jvid, tmp_path)
    assert_same_frames(dec, JaxDecoder().decode(jvid))
    with np.load(tmp_path / "port.npz") as a:
        assert {"gop0_bmv", "gop0_bmode", "gop0_bres"} <= set(a.files)
        assert "gop2_bmv" not in a.files
        assert (a["gop0_bmv"].dtype, a["gop0_bmode"].dtype,
                a["gop0_bres"].dtype) == (np.int16, np.int8, np.float32)

    assert_same_stream(from_jax_video(jvid), jvid, torch.float32)
    back = to_numpy_video(port)
    rebuilt = JaxVideo(JaxConfig(**back["config"]), back["height"],
                       back["width"], back["fps"], back["num_frames"],
                       [JaxGOP(**g) for g in back["gops"]])
    assert_same_frames(JaxDecoder().decode(rebuilt), dec)
    assert motion_cuda.LAUNCHES == {"sad_search": 0, "compensate": 0}


@pytest.mark.parametrize("with_residual", [True, False])
def test_bframes_without_dct_match_jax(rng, tmp_path, with_residual):
    """Wrap residuals (lossless, so the decode gives the input back) and no
    residual at all: streams and frames identical."""
    frames = _clip(rng, 10, 32, 48)
    kw = dict(with_dct=False, with_residual=with_residual)
    port = Encoder(CodecConfig.bframes(**kw), device="cpu").encode_frames(frames)
    jvid = JaxEncoder(JaxConfig.bframes(**kw)).encode_frames(frames)
    assert_same_stream(port, jvid, torch.uint8)
    dec = cross_decode(port, jvid, tmp_path)
    assert_same_frames(dec, JaxDecoder().decode(jvid))
    if with_residual:
        assert_same_frames(dec, frames)


def test_production_bframes_match_jax(rng, tmp_path):
    """CodecConfig.production(intra_qstep=24, gop_pattern=IBPBPBP): every
    integer field identical, decoded frames within the +-1 contract, each
    package decodes the other's .npz."""
    frames = _clip(rng, 9, 32, 48)
    kw = dict(intra_qstep=24, gop_pattern=IBPBPBP)
    port = Encoder(CodecConfig.production(**kw), device="cpu").encode_frames(frames)
    jvid = JaxEncoder(JaxConfig.production(**kw)).encode_frames(frames)
    assert [g.num_coded for g in port.gops] == [7, 2]
    assert_same_stream(port, jvid, torch.int16)
    for a, b in zip(port.gops, jvid.gops):
        for k in ("i_qcoef", "i_modes", "i_escape"):
            np.testing.assert_array_equal(getattr(a, k).numpy(),
                                          np.asarray(getattr(b, k)))
    dec = Decoder(device="cpu").decode(port)
    jdec = JaxDecoder().decode(jvid)
    _assert_close_frames(dec, jdec)
    port.save_npz(tmp_path / "port.npz")
    jvid.save_npz(str(tmp_path / "jax.npz"))
    _assert_close_frames(JaxDecoder().decode(
        JaxVideo.load_npz(str(tmp_path / "port.npz"))), dec)
    from_jax_file = EncodedVideo.load_npz(str(tmp_path / "jax.npz"))
    assert_same_stream(from_jax_file, jvid, torch.int16)
    _assert_close_frames(Decoder(device="cpu").decode(from_jax_file), jdec)
    assert not any(inter_cuda.LAUNCHES.values())


def test_single_gop_entry_points_with_b(rng):
    """encode_gop / decode_gop with a full B GOP and a short one (all-P)."""
    frames = _clip(rng, 5, 32, 48)
    planar = torch.from_numpy(np.stack(frames)).permute(0, 3, 1, 2).contiguous()
    cfg = CodecConfig(gop_pattern=("I", "B", "P", "B", "P"), with_dct=False)
    gop = pipeline.encode_gop(planar[0], planar[1:], cfg)
    assert (gop.num_p, gop.num_b, gop.num_coded) == (2, 2, 5)
    out = pipeline.decode_gop(gop, cfg)
    assert out.dtype == torch.uint8
    assert torch.equal(out, planar)
    short = pipeline.encode_gop(planar[0], planar[1:3], cfg)
    assert (short.num_p, short.num_b) == (2, 0)
    assert torch.equal(pipeline.decode_gop(short, cfg), planar[:3])
