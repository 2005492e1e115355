"""The 4:2:0 slice of vcs_h264_tpu_torch against the JAX package on the CPU:
Encoder.encode_frames -> .npz -> Decoder.decode with
CodecConfig.production(chroma_420=True), raw and lossy intra I planes, IPPP
tail and I-only GOPs, each package decoding the other's .npz (B-frames and
`interop`: tests/test_torch_pipeline420_b.py).

The contract on bare planes (ROADMAP.md, *Parity contract*): planes,
vectors, B modes and intra payloads identical; res_y, res_c, bres_y, bres_c
within +-1 of the JAX package's on fewer than 1e-3 of coefficients (integer
residuals put DC terms on exact .5 ties, which two float32 DCTs summed in
another order round apart), the measured share printed; the decode of the
SAME stream within +-1 on fewer than 1e-4 of plane samples. After the
colour conversion one chroma step is up to 1.773 in B, so BGR frames are
held to +-2 on fewer than 1e-3 of values."""

import dataclasses

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

from vcs_h264_tpu_torch import CodecConfig  # noqa: E402
from vcs_h264_tpu_torch.interop import from_jax_video  # noqa: E402
from vcs_h264_tpu_torch.models import Decoder, EncodedVideo, Encoder  # noqa: E402
from vcs_h264_tpu_torch.models import pipeline420  # noqa: E402
from vcs_h264_tpu_torch.models.gop import NPZ_420, EncodedGOP420  # noqa: E402
from vcs_h264_tpu_torch.ops import inter_cuda, intra_cuda, motion_cuda  # noqa: E402

from test_torch_pipeline import _clip  # noqa: E402

IBPBPBP = ("I", "B", "P", "B", "P", "B", "P")
EXACT = ("i_y", "i_c", "mv", "b_mv", "b_mode", *EncodedGOP420.PAYLOAD)
COEFFS = ("res_y", "res_c", "bres_y", "bres_c")
COEF_SHARE = 1e-3
PLANE_SHARE = 1e-4
BGR_SHARE = 1e-3


def _cfgs(**kw):
    kw = dict(chroma_420=True, **kw)
    return CodecConfig.production(**kw), JaxConfig.production(**kw)


def _field(gop, k):
    v = getattr(gop, k)
    if v is None:
        return None
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_stream_in_contract(port, other, exact=EXACT, what=""):
    """`exact` fields identical, coefficient fields within +-1 on fewer
    than COEF_SHARE; returns the differing share of the coefficients."""
    assert len(port.gops) == len(other.gops)
    n_diff = n_all = 0
    for a, b in zip(port.gops, other.gops):
        for k in exact + COEFFS:
            x, y = _field(a, k), _field(b, k)
            assert (x is None) == (y is None), k
            if x is None:
                continue
            assert x.shape == y.shape, (k, x.shape, y.shape)
            if k in exact:
                np.testing.assert_array_equal(x, y, err_msg=k)
                continue
            assert x.dtype == np.int16, k
            d = np.abs(x.astype(np.int64) - y)
            assert d.max() <= 1, (k, d.max())
            n_diff += int((d != 0).sum())
            n_all += d.size
    share = n_diff / max(n_all, 1)
    print(f"{what}coefficients differing by 1: {n_diff} of {n_all} "
          f"(share {share:.3e}, limit {COEF_SHARE:g})")
    assert share < COEF_SHARE
    return share


def _assert_frames_close(got, want, share=BGR_SHARE, tol=2):
    assert len(got) == len(want)
    d = np.abs(np.stack(got).astype(np.int64) - np.stack(want))
    assert d.max() <= tol and (d != 0).mean() < share, (d.max(),
                                                        (d != 0).mean())


def _psnr(a, b):
    mse = np.mean((np.stack(a).astype(float) - np.stack(b)) ** 2)
    return 10 * np.log10(255 ** 2 / max(mse, 1e-12))


def _port_planes(video):
    """The port's decode of a stream to planes: y [N, H, W], c [N, 2, h, w]
    over all frames of the full GOPs."""
    full = [g.without_intra_payload() for g in video.gops
            if g.num_coded == video.config.gop_len]
    y, c = pipeline420.decode_gop_batch_420(
        EncodedGOP420.stack(full, "cpu"), video.config, as_bgr=False)
    return y.flatten(0, 1).numpy(), c.flatten(0, 1).numpy()


def _jax_planes(jvideo):
    full = [g for g in jvideo.gops if g.num_coded == jvideo.config.gop_len]
    ys, cs = [], []
    for g in full:
        one = dataclasses.replace(g, iq_y=None, im_y=None, ie_y=None,
                                  iq_c=None, im_c=None, ie_c=None)
        one = jp420.EncodedGOP420(*(None if v is None else jnp.asarray(v)[None]
                                    for v in one.tree_flatten()[0]))
        y, c = jp420.decode_gop_batch_420(one, jvideo.config, as_bgr=False)
        ys.append(np.asarray(y[0]))
        cs.append(np.asarray(c[0]))
    return np.concatenate(ys), np.concatenate(cs)


@pytest.mark.parametrize("qstep,n_frames", [(24, 9), (0, 10), (0, 9)])
def test_420_slice_matches_jax(rng, tmp_path, qstep, n_frames):
    """Two full IPPP GOPs plus a tail GOP (I + 1 P for 10 frames, the
    I planes alone for 9), lossy and raw intra: the stream field by field
    under the contract, each package decoding its own and the other's .npz,
    the same stream decoded by both within the plane bound. (A lossy tail
    GOP with P-frames: tests/test_torch_pipeline420_b.py, which spares this
    file one more compilation of the JAX encoder.)"""
    frames = _clip(rng, n_frames, 32, 64)
    cfg, jcfg = _cfgs(intra_qstep=qstep)
    port = Encoder(cfg, device="cpu", gop_batch=2).encode_frames(frames)
    jvid = JaxEncoder(jcfg, gop_batch=2).encode_frames(frames)
    _assert_stream_in_contract(port, jvid)
    assert [g.num_p for g in port.gops] == [3, 3, n_frames - 9]
    assert any(g.mv.any() for g in port.gops), "search found no motion"
    g0 = port.gops[0]
    assert g0.i_y.dtype == g0.i_c.dtype == torch.uint8
    assert tuple(g0.i_c.shape) == (2, 16, 32) and g0.mv.dtype == torch.int32
    assert tuple(g0.res_c.shape) == (3, 2, 16, 32)
    assert (g0.iq_y is not None) == bool(qstep)
    if qstep:
        assert tuple(g0.iq_y.shape) == (1, 32, 64)
        assert tuple(g0.im_c.shape) == (2, 4, 8)
        for g in port.gops:
            back = pipeline420.decode_intra_420(g, qstep)
            assert torch.equal(back.i_y, g.i_y) and torch.equal(back.i_c, g.i_c)

    dec = Decoder(device="cpu").decode(port)
    jdec = JaxDecoder().decode(jvid)
    assert all(f.shape == (32, 64, 3) and f.dtype == np.uint8 for f in dec)
    assert abs(_psnr(dec, frames) - _psnr(jdec, frames)) < 0.01

    # the same stream through both decoders: planes, then BGR frames
    for a, b in zip(_port_planes(from_jax_video(jvid)), _jax_planes(jvid)):
        d = np.abs(a.astype(np.int64) - b)
        assert d.max() <= 1 and (d != 0).mean() < PLANE_SHARE
    _assert_frames_close(Decoder(device="cpu").decode(from_jax_video(jvid)),
                         jdec)

    port.save_npz(tmp_path / "port.npz")
    jvid.save_npz(str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        last = len(port.gops) - 1
        assert (f"gop{last}_resy" in a.files) == (n_frames == 10)
        assert (f"gop{last}_iqc" in a.files) == bool(qstep)
    _assert_frames_close(JaxDecoder().decode(
        JaxVideo.load_npz(str(tmp_path / "port.npz"))), dec)
    from_jax_file = EncodedVideo.load_npz(str(tmp_path / "jax.npz"))
    assert from_jax_file.config == dataclasses.replace(cfg)
    _assert_stream_in_contract(from_jax_file, jvid, what="loaded: ")
    _assert_frames_close(Decoder(device="cpu").decode(from_jax_file), jdec)
    loaded = EncodedVideo.load_npz(str(tmp_path / "port.npz"))
    for a, b in zip(port.gops, loaded.gops):
        for k in NPZ_420:
            x, y = getattr(a, k), getattr(b, k)
            assert (x is None) == (y is None), k
            assert x is None or (x.dtype == y.dtype and torch.equal(x, y)), k
    for launches in (motion_cuda.LAUNCHES, inter_cuda.LAUNCHES,
                     intra_cuda.LAUNCHES):
        assert not any(launches.values())


def test_420_small_residuals_give_identical_coefficients(rng):
    """A clip whose frames differ from their prediction by little: no
    coefficient reaches a tie, and res_y / res_c are identical."""
    base = _clip(rng, 1, 32, 64)[0].astype(np.int64)
    frames = [np.clip(base + rng.integers(-3, 4, base.shape), 0, 255)
              .astype(np.uint8) for _ in range(8)]
    cfg, jcfg = _cfgs()
    port = Encoder(cfg, device="cpu").encode_frames(frames)
    jvid = JaxEncoder(jcfg).encode_frames(frames)
    assert _assert_stream_in_contract(port, jvid) == 0.0
    assert any(g.res_y.any() for g in port.gops)


def test_420_frame_sides_must_be_multiples_of_twice_the_block(rng):
    """24 is a multiple of the block size and not of 16: the full-resolution
    path takes it, 4:2:0 refuses it, at the Encoder and in the pipeline."""
    frames = [rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)] * 2
    cfg, _ = _cfgs()
    with pytest.raises(ValueError, match="16"):
        Encoder(cfg, device="cpu").encode_frames(frames)
    planar = torch.from_numpy(np.stack(frames)).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="16"):
        pipeline420.encode_gop_batch_420(planar[:1], planar[None, 1:], cfg)
    assert len(Encoder(CodecConfig.production(), device="cpu").encode_frames(
        frames).gops) == 1


def test_decoder_strips_the_420_payload(rng, monkeypatch):
    """The six payload fields never reach the P-frame decode."""
    frames = _clip(rng, 6, 16, 32)
    cfg, _ = _cfgs(intra_qstep=24)
    video = Encoder(cfg, device="cpu", gop_batch=1).encode_frames(frames)
    assert all(g.iq_y is not None and g.ie_c is not None for g in video.gops)
    seen = []
    orig = pipeline420.decode_gop_batch_420

    def spy(gop, cfg, as_bgr=True, backend="auto"):
        seen.append([getattr(gop, k) for k in EncodedGOP420.PAYLOAD])
        return orig(gop, cfg, as_bgr, backend)

    monkeypatch.setattr(pipeline420, "decode_gop_batch_420", spy)
    assert len(Decoder(device="cpu").decode(video)) == 6
    assert len(seen) == 2 and all(v is None for s in seen for v in s)
