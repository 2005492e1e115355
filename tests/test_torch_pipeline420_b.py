"""B-frames in the 4:2:0 mode of vcs_h264_tpu_torch against the JAX package
on the CPU: the B stage on shared anchors, the mode decision on luma alone,
the IBPBPBP slice through Encoder.encode_frames -> .npz -> Decoder.decode,
and `interop` both ways. The contract and its tolerances are stated in
tests/test_torch_pipeline420.py.

B-frames are coded against DECODED anchors, so a +-1 in an anchor
coefficient (within the contract) can move a B search: the B stage is
compared on anchors both packages are given, and a whole stream only where
its anchors are verified to have rounded alike."""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu.config import CodecConfig as JaxConfig  # noqa: E402
from vcs_h264_tpu.models import pipeline420 as jp420  # noqa: E402
from vcs_h264_tpu.models.decoder import Decoder as JaxDecoder  # noqa: E402
from vcs_h264_tpu.models.encoder import Encoder as JaxEncoder  # noqa: E402
from vcs_h264_tpu.models.gop import EncodedVideo as JaxVideo  # noqa: E402
from vcs_h264_tpu.ops.motion import _tile_sums as j_tile_sums  # noqa: E402

from vcs_h264_tpu_torch.interop import from_jax_video, to_numpy_video  # noqa: E402
from vcs_h264_tpu_torch.models import Decoder, EncodedVideo, Encoder  # noqa: E402
from vcs_h264_tpu_torch.models import pipeline420  # noqa: E402
from vcs_h264_tpu_torch.models.gop import NPZ_420, EncodedGOP420  # noqa: E402

from test_torch_pipeline import _clip  # noqa: E402
from test_torch_pipeline420 import (COEF_SHARE, IBPBPBP,  # noqa: E402
                                    _assert_frames_close,
                                    _assert_stream_in_contract, _cfgs, _field,
                                    _psnr)


def _b_stage_inputs(rng, n, h, w):
    """B planes and their two anchors, each a panned texture with noise, so
    that forward, backward and average all win somewhere."""
    frames = _clip(rng, 3 * n, h, w)
    planar = torch.from_numpy(np.stack(frames)).permute(0, 3, 1, 2)
    y, c = pipeline420.ingest_420(planar.reshape(n, 3, 3, h, w))
    return ((y[:, 1], c[:, 1]), (y[:, 0], y[:, 2], c[:, 0], c[:, 2]))


def test_b_stage_on_shared_anchors_matches_jax(rng):
    """Both packages get the same anchors and B planes (so no +-1 of an
    earlier stage can move a search): b_mv, b_mode and both predictions
    identical, residuals within the coefficient bound."""
    (yb, cb), refs = _b_stage_inputs(rng, 4, 32, 48)
    cfg, jcfg = _cfgs(gop_pattern=IBPBPBP)
    b_mv, mode, pred_y, pred_c, bres_y, bres_c = pipeline420._encode_b(
        yb, cb, *refs, cfg, "auto")
    assert mode.dtype == torch.int8 and pred_y.dtype == torch.uint8

    def j(x):
        return jnp.asarray(x.numpy(), jnp.int32)

    jyb, jcb = j(yb), j(cb)
    prev_y, next_y, prev_c, next_c = (j(x) for x in refs)
    mv_f = jp420._search(jyb[:, None], prev_y, jcfg)
    mv_b = jp420._search(jyb[:, None], next_y, jcfg)
    pf_y, pf_c = (x[:, 0] for x in jp420._predict(mv_f, prev_y, prev_c, jcfg))
    pb_y, pb_c = (x[:, 0] for x in jp420._predict(mv_b, next_y, next_c, jcfg))
    bi_y, bi_c = (pf_y + pb_y + 1) >> 1, (pf_c + pb_c + 1) >> 1
    sads = jnp.stack([j_tile_sums(jnp.abs(p - jyb)[:, None], 8)
                      for p in (pf_y, pb_y, bi_y)])
    jmode = np.asarray(jnp.argmin(sads, axis=0))
    mpy = np.kron(jmode, np.ones((8, 8), int))
    mpc = np.kron(jmode, np.ones((4, 4), int))[:, None]
    want_y = np.where(mpy == 0, pf_y, np.where(mpy == 1, pb_y, bi_y))
    want_c = np.where(mpc == 0, pf_c, np.where(mpc == 1, pb_c, bi_c))
    qy, qc = jp420._tables(jcfg)

    np.testing.assert_array_equal(b_mv[:, 0].numpy(), np.asarray(mv_f[:, 0]))
    np.testing.assert_array_equal(b_mv[:, 1].numpy(), np.asarray(mv_b[:, 0]))
    np.testing.assert_array_equal(mode.numpy(), jmode)
    assert set(np.unique(jmode)) == {0, 1, 2}
    np.testing.assert_array_equal(pred_y.numpy(), want_y)
    np.testing.assert_array_equal(pred_c.numpy(), want_c)
    for got, cur, pred, q in ((bres_y, jyb, want_y, qy),
                              (bres_c, jcb, want_c, qc)):
        want = np.asarray(jp420._code_planes(cur - jnp.asarray(pred), q, 8))
        d = np.abs(got.numpy().astype(np.int64) - want)
        print(f"B residuals differing by 1: share {(d != 0).mean():.3e}")
        assert d.max() <= 1 and (d != 0).mean() < COEF_SHARE


def test_b_mode_is_decided_on_luma_alone():
    """Chroma that favours the backward anchor does not move the mode: luma
    is exact forward, so every block is mode 0 and chroma follows it."""
    n, h, w = 1, 16, 16
    yb = torch.full((n, h, w), 100, dtype=torch.uint8)
    cb = torch.full((n, 2, h // 2, w // 2), 50, dtype=torch.uint8)
    prev_y, next_y = yb.clone(), yb + 9
    prev_c, next_c = cb + 40, cb.clone()
    cfg, _ = _cfgs(gop_pattern=("I", "B", "P"))
    _, mode, pred_y, pred_c, _, _ = pipeline420._encode_b(
        yb, cb, prev_y, next_y, prev_c, next_c, cfg, "auto")
    assert not mode.any()
    assert torch.equal(pred_y, prev_y) and torch.equal(pred_c, prev_c)


def test_b_average_does_not_wrap_uint8():
    pf = torch.full((1, 8, 8), 255, dtype=torch.uint8)
    pb = torch.full((1, 8, 8), 254, dtype=torch.uint8)
    mode = torch.full((1, 1, 1), 2, dtype=torch.int8)
    assert (pipeline420._b_choice(mode, pf, pb, 8) == 255).all()


@pytest.mark.parametrize("seed,ties", [(3, False), (7, True)])
def test_420_bframes_slice_matches_jax(tmp_path, seed, ties):
    """CodecConfig.production(chroma_420=True, intra_qstep=24, IBPBPBP): two
    full GOPs and a 3-frame tail coded all-P. The anchors' coefficients are
    checked first. Seed 3 makes no tie there: the closed loop sees the same
    decoded anchors in both packages, so b_mv and b_mode must be identical
    and the B residuals within the bound. Seed 7 rounds one anchor
    coefficient apart, which moves a decoded anchor and with it two B
    vectors, for no fault of either package: that stream is held by quality
    alone. Each package's own decode agrees within 0.01 dB either way, and
    each decodes the other's .npz."""
    frames = _clip(np.random.default_rng(seed), 17, 32, 48)
    cfg, jcfg = _cfgs(intra_qstep=24, gop_pattern=IBPBPBP)
    port = Encoder(cfg, device="cpu", gop_batch=2).encode_frames(frames)
    jvid = JaxEncoder(jcfg, gop_batch=2).encode_frames(frames)
    assert [(g.num_p, g.num_b) for g in port.gops] == [(3, 3), (3, 3), (2, 0)]
    g0 = port.gops[0]
    assert tuple(g0.b_mv.shape) == (3, 2, 4, 6, 2)
    assert tuple(g0.b_mode.shape) == (3, 4, 6) and g0.b_mode.dtype == torch.int8
    assert tuple(g0.bres_c.shape) == (3, 2, 16, 24)
    assert port.gops[-1].b_mv is None and port.gops[-1].bres_y is None
    anchors_same = all(
        np.array_equal(_field(a, k), _field(b, k))
        for a, b in zip(port.gops, jvid.gops) for k in ("res_y", "res_c"))
    assert anchors_same == (not ties)
    if anchors_same:
        _assert_stream_in_contract(port, jvid)
    else:
        _assert_stream_in_contract(
            port, jvid, exact=("i_y", "i_c", "mv", *EncodedGOP420.PAYLOAD))
    assert any(g.b_mode.unique().numel() > 1 for g in port.gops[:2])

    dec = Decoder(device="cpu").decode(port)
    jdec = JaxDecoder().decode(jvid)
    assert len(dec) == 17
    assert abs(_psnr(dec, frames) - _psnr(jdec, frames)) < 0.01
    _assert_frames_close(Decoder(device="cpu").decode(from_jax_video(jvid)),
                         jdec)
    port.save_npz(tmp_path / "port.npz")
    jvid.save_npz(str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert {"gop0_bmv", "gop0_bmode", "gop0_bresy",
                "gop0_bresc"} <= set(a.files) and "gop2_bmv" not in a.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
    _assert_frames_close(JaxDecoder().decode(
        JaxVideo.load_npz(str(tmp_path / "port.npz"))), dec)
    _assert_frames_close(Decoder(device="cpu").decode(
        EncodedVideo.load_npz(str(tmp_path / "jax.npz"))), jdec)


def test_interop_420_both_ways():
    """A JAX 4:2:0 stream into the port and the port's stream back into JAX
    records, in memory, B-frames and payloads included."""
    frames = _clip(np.random.default_rng(3), 17, 32, 48)
    cfg, jcfg = _cfgs(intra_qstep=24, gop_pattern=IBPBPBP)
    jvid = JaxEncoder(jcfg, gop_batch=2).encode_frames(frames)
    port = from_jax_video(jvid)
    assert isinstance(port.gops[0], EncodedGOP420) and port.config == cfg
    for a, b in zip(port.gops, jvid.gops):
        for k, (_, _, mem) in NPZ_420.items():
            x, y = _field(a, k), _field(b, k)
            assert (x is None) == (y is None), k
            if x is not None:
                assert x.dtype == np.dtype(mem), k
                np.testing.assert_array_equal(x, y, err_msg=k)
    jdec = JaxDecoder().decode(jvid)
    _assert_frames_close(Decoder(device="cpu").decode(port), jdec)

    mine = Encoder(cfg, device="cpu", gop_batch=2).encode_frames(frames)
    back = to_numpy_video(mine)
    assert set(back["gops"][0]) == set(NPZ_420)
    rebuilt = JaxVideo(JaxConfig(**back["config"]), back["height"],
                       back["width"], back["fps"], back["num_frames"],
                       [jp420.EncodedGOP420(**g) for g in back["gops"]])
    _assert_frames_close(JaxDecoder().decode(rebuilt),
                         Decoder(device="cpu").decode(mine))
