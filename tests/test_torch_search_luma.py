"""`search_luma_only` in vcs_h264_tpu_torch against the JAX package on the
CPU: the search compares the G channel alone with a third of the static
threshold, in the P search and in both B searches; the vectors still drive
the compensation of all three channels. Vectors, modes and (on the
full-resolution path, whose RCT keeps coefficients off .5 ties) coefficients
are identical; decoded frames keep the +-1 contract of the production
decode."""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu.config import CodecConfig as JaxConfig  # noqa: E402
from vcs_h264_tpu.models import pipeline as jpipeline  # noqa: E402
from vcs_h264_tpu.models.decoder import Decoder as JaxDecoder  # noqa: E402
from vcs_h264_tpu.models.encoder import Encoder as JaxEncoder  # noqa: E402

from vcs_h264_tpu_torch import CodecConfig  # noqa: E402
from vcs_h264_tpu_torch.models import Decoder, EncodedVideo, Encoder  # noqa: E402
from vcs_h264_tpu_torch.models import pipeline  # noqa: E402
from vcs_h264_tpu_torch.ops import motion  # noqa: E402

from test_torch_pipeline import _assert_close_frames, _clip  # noqa: E402
from test_torch_reference import assert_same_stream  # noqa: E402

IBPBPBP = ("I", "B", "P", "B", "P", "B", "P")


def _gops(rng, b=2, p=3, h=64, w=128):
    """I-frames of noise and P-frames that are rolled copies with 2% of the
    pixels replaced: planar uint8 [b, 3, h, w] and [b, p, 3, h, w]."""
    i_frames = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    p_frames = np.stack([
        np.stack([np.roll(i_frames[g], (t + 1, -2 * t), axis=(0, 1))
                  for t in range(p)]) for g in range(b)])
    noise = rng.integers(0, 256, p_frames.shape, dtype=np.uint8)
    mask = rng.random(p_frames.shape[:-1])[..., None] < 0.02
    p_frames = np.where(mask, noise, p_frames)
    return (np.ascontiguousarray(i_frames.transpose(0, 3, 1, 2)),
            np.ascontiguousarray(p_frames.transpose(0, 1, 4, 2, 3)))


def test_search_inputs_take_the_g_channel_and_a_third_of_the_threshold(rng):
    i_b, p_b = (torch.from_numpy(x) for x in _gops(rng, h=16, w=16))
    cfg = CodecConfig.production(search_luma_only=True, static_threshold=2000)
    curs, refs, th = pipeline._search_inputs(p_b, i_b, cfg)
    assert th == 666 and curs.is_contiguous() and refs.is_contiguous()
    assert torch.equal(curs, p_b[:, :, 1:2]) and torch.equal(refs, i_b[:, 1:2])
    for full, third in ((1999, 666), (2, 0), (3, 1)):
        assert pipeline._search_inputs(p_b, i_b, CodecConfig.production(
            search_luma_only=True, static_threshold=full))[2] == third
    curs, refs, th = pipeline._search_inputs(p_b, i_b,
                                             CodecConfig.production())
    assert curs is p_b and refs is i_b and th == 2000


def test_luma_only_mvs_match_jax_and_the_g_channel_search(rng):
    i_b, p_b = _gops(rng)
    cfg = CodecConfig.production(search_luma_only=True)
    got = pipeline.encode_gop_batch(torch.from_numpy(i_b),
                                    torch.from_numpy(p_b), cfg)
    want = jpipeline.encode_gop_batch(
        jnp.asarray(i_b, jnp.int32), jnp.asarray(p_b, jnp.int32),
        JaxConfig.production(search_luma_only=True))
    np.testing.assert_array_equal(got.mv.numpy(), np.asarray(want.mv))
    np.testing.assert_array_equal(got.residuals.numpy(),
                                  np.asarray(want.residuals))
    g_only = motion.motion_search_gops(
        torch.from_numpy(p_b[:, :, 1:2].copy()),
        torch.from_numpy(i_b[:, 1:2].copy()), bs=8, reach=16, step=3,
        static_threshold=2000 // 3)
    assert torch.equal(got.mv, g_only)
    plain = pipeline.encode_gop_batch(torch.from_numpy(i_b),
                                      torch.from_numpy(p_b),
                                      CodecConfig.production())
    assert not torch.equal(plain.mv, got.mv), "the flag changed nothing"


def test_threshold_scaling_decides_a_block_between_the_two_thresholds():
    """A ramp of slope 6 shifted by 2 px: every block's saturating G-channel
    SAD is 64 * 12 = 768, above 2000 // 3 and below 2000. With the flag the
    block is searched and the shift found, in both packages; with the
    unscaled threshold on the same channel it would be static."""
    h, w = 32, 64
    ramp = (np.arange(w + 2) * 6 % 256).astype(np.uint8)
    i_f = np.broadcast_to(ramp[2:], (1, 3, h, w)).copy()
    p_f = np.broadcast_to(ramp[:-2], (1, 1, 3, h, w)).copy()
    cfg = CodecConfig.production(search_luma_only=True)
    got = pipeline.encode_gop_batch(torch.from_numpy(i_f),
                                    torch.from_numpy(p_f), cfg).mv
    want = jpipeline.encode_gop_batch(
        jnp.asarray(i_f, jnp.int32), jnp.asarray(p_f, jnp.int32),
        JaxConfig.production(search_luma_only=True)).mv
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    interior = got[0, 0, :, 3:5]
    assert (interior[..., 0] != 0).all(), interior
    unscaled = motion.motion_search_gops(
        torch.from_numpy(p_f[:, :, 1:2].copy()),
        torch.from_numpy(i_f[:, 1:2].copy()), bs=8, reach=16, step=3,
        static_threshold=2000)
    assert not unscaled[0, 0, :, 3:5].any()


def test_luma_only_stream_matches_jax_through_the_entry_points(rng, tmp_path):
    """CodecConfig.production(intra_qstep=24, search_luma_only=True): two
    full GOPs and a tail, stream identical, frames within +-1; the .npz does
    not record the flag (it is encoder-side), and decodes all the same."""
    frames = _clip(rng, 10, 64, 128)
    kw = dict(intra_qstep=24, search_luma_only=True)
    port = Encoder(CodecConfig.production(**kw), device="cpu",
                   gop_batch=2).encode_frames(frames)
    jvid = JaxEncoder(JaxConfig.production(**kw),
                      gop_batch=2).encode_frames(frames)
    assert_same_stream(port, jvid, torch.int16)
    assert any(g.mv.any() for g in port.gops), "search found no motion"
    port.save_npz(tmp_path / "port.npz")
    loaded = EncodedVideo.load_npz(str(tmp_path / "port.npz"))
    assert not loaded.config.search_luma_only
    dec = Decoder(device="cpu").decode(loaded)
    _assert_close_frames(dec, JaxDecoder().decode(jvid))


def test_luma_only_b_searches_match_jax(rng):
    """The flag under a B pattern: the P search and both B searches take
    the G channel; b_mv, b_mode and every coefficient identical."""
    frames = _clip(rng, 9, 32, 48)
    kw = dict(intra_qstep=24, gop_pattern=IBPBPBP, search_luma_only=True)
    port = Encoder(CodecConfig.production(**kw), device="cpu").encode_frames(frames)
    jvid = JaxEncoder(JaxConfig.production(**kw)).encode_frames(frames)
    assert [g.num_coded for g in port.gops] == [7, 2]
    assert_same_stream(port, jvid, torch.int16)
    assert port.gops[0].b_mv.any()
    unflagged = Encoder(CodecConfig.production(
        intra_qstep=24, gop_pattern=IBPBPBP), device="cpu").encode_frames(frames)
    assert not torch.equal(unflagged.gops[0].b_mv, port.gops[0].b_mv)
    _assert_close_frames(Decoder(device="cpu").decode(port),
                         JaxDecoder().decode(jvid))
