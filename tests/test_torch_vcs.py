"""The `.vcs` container of vcs_h264_tpu_torch against the JAX package's on
the CPU: for one stream, encoded by the JAX package and carried into the
port by `interop.from_jax_video`, both writers give identical bytes in
every mode; each package loads the other's file to the same fields; the
port's own Encoder -> save_vcs -> load_vcs -> Decoder gives the frames of
the in-memory stream; the loader decodes the I-frames of all GOPs in one
batch per plane shape."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu.config import CodecConfig as JaxConfig  # noqa: E402
from vcs_h264_tpu.io import bitstream as jbits  # noqa: E402
from vcs_h264_tpu.models.encoder import Encoder as JaxEncoder  # noqa: E402

from vcs_h264_tpu_torch import CodecConfig  # noqa: E402
from vcs_h264_tpu_torch.interop import _dtypes, from_jax_video  # noqa: E402
from vcs_h264_tpu_torch.io import bitstream as bits  # noqa: E402
from vcs_h264_tpu_torch.models import Decoder, Encoder  # noqa: E402
from vcs_h264_tpu_torch.ops import intra, intra_cuda  # noqa: E402

IBPBPBP = ("I", "B", "P", "B", "P", "B", "P")


def _clip(rng, n, h, w):
    """Smooth texture panned 2 px/frame with a moving square and +-2
    noise: BGR uint8 [h, w, 3] frames, so the search finds vectors."""
    m = 2 * n + 8
    coarse = rng.uniform(0, 255, (1, 3, (h + 2 * m) // 8 + 2,
                                  (w + 2 * m) // 8 + 2))
    tex = torch.nn.functional.interpolate(
        torch.from_numpy(coarse), size=(h + 2 * m, w + 2 * m),
        mode="bilinear", align_corners=False)[0].permute(1, 2, 0).numpy()
    frames = []
    for t in range(n):
        f = tex[m + t:m + t + h, m - 2 * t:m - 2 * t + w].copy()
        f[8 + t:24 + t, 16 + 3 * t:32 + 3 * t] = 200.0
        f += rng.integers(-2, 3, f.shape)
        frames.append(np.clip(np.rint(f), 0, 255).astype(np.uint8))
    return frames


def _no_dct(bs):
    return dict(block_size=bs, with_dct=False, search_reach=2 * bs,
                search_step=max(1, round(bs / 3)))


# mode -> (preset, config fields, frames, H, W, gop_batch, the I-frame
# section type the writer gives its GOPs). 10 frames of a 4-frame pattern
# end in a tail GOP of I + 1 P, 9 frames in an I-only GOP.
MODES = {
    "lossless_intra": ("production", {}, 10, 64, 128, 2, 1),
    "lossy_intra": ("production", dict(intra_qstep=24), 9, 64, 128, 2, 2),
    "raw_i": ("production", dict(intra_i=False), 10, 48, 64, 8, 0),
    "no_dct_bs4": ("reference", _no_dct(4), 6, 24, 32, 8, 0),
    "no_dct_bs8": ("reference", _no_dct(8), 6, 48, 64, 8, 0),
    "no_dct_bs16": ("reference", _no_dct(16), 6, 96, 128, 8, 0),
    "no_residual": ("reference", dict(with_residual=False, with_dct=False),
                    6, 48, 64, 8, 0),
    "production_b": ("production", dict(intra_qstep=24, gop_pattern=IBPBPBP),
                     9, 32, 48, 8, 2),
    "c420_lossy_intra": ("production", dict(chroma_420=True, intra_qstep=24),
                         9, 32, 64, 2, 2),
    "c420_lossless_intra": ("production", dict(chroma_420=True), 10, 32, 64,
                            2, 1),
    "c420_raw_i": ("production", dict(chroma_420=True, intra_i=False), 10,
                   32, 64, 2, 0),
    "c420_b": ("production", dict(chroma_420=True, intra_qstep=24,
                                  gop_pattern=IBPBPBP), 17, 32, 48, 2, 2),
}


def _assert_fields(port_video, other, dtypes):
    """The port's loaded stream against another of the same GOPs (the
    port's or the JAX package's records): every field equal in value, and
    the port's in the dtype `EncodedVideo.load_npz` gives it."""
    assert len(port_video.gops) == len(other.gops)
    for a, b in zip(port_video.gops, other.gops):
        for k, dt in dtypes.items():
            x, y = getattr(a, k), getattr(b, k)
            assert (x is None) == (y is None), k
            if x is None:
                continue
            assert x.device.type == "cpu" and x.numpy().dtype == dt, k
            y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
            np.testing.assert_array_equal(x.numpy(), y, err_msg=k)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_writer_bytes_match_jax_and_files_cross_load(mode, rng, tmp_path):
    preset, kw, n, h, w, gop_batch, itype = MODES[mode]
    frames = _clip(rng, n, h, w)
    jvid = JaxEncoder(getattr(JaxConfig, preset)(**kw),
                      gop_batch=gop_batch).encode_frames(frames)
    video = from_jax_video(jvid)
    jpath, path = str(tmp_path / "jax.vcs"), str(tmp_path / "port.vcs")
    jbits.save_vcs(jvid, jpath)
    bits.save_vcs(video, path, device="cpu")
    data = open(path, "rb").read()
    assert data == open(jpath, "rb").read()
    # the section type of the first GOP, after the header and the pattern
    pat = len(",".join(video.config.gop_pattern))
    first = 8 + 44 + 4 + pat + 4 + (8 if video.config.chroma_420 else 12)
    assert data[first] == itype

    loaded = bits.load_vcs(jpath, device="cpu")
    jloaded = jbits.load_vcs(path)
    # the container keeps what the decoder reads, not the search's reach
    assert dataclasses.asdict(loaded.config) == dataclasses.asdict(
        jloaded.config)
    assert loaded.config == dataclasses.replace(
        video.config, search_reach=16, search_step=3)
    assert (loaded.height, loaded.width, loaded.fps, loaded.num_frames) == (
        jloaded.height, jloaded.width, jloaded.fps, jloaded.num_frames)
    dtypes = _dtypes(video.config)
    _assert_fields(loaded, video, dtypes)
    _assert_fields(loaded, jloaded, dtypes)
    got = Decoder(device="cpu").decode(loaded)
    want = Decoder(device="cpu").decode(video)
    assert len(got) == n
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert intra_cuda.LAUNCHES == {"intra_encode": 0, "intra_decode": 0}


@pytest.mark.parametrize("kw", [
    dict(intra_qstep=24), dict(chroma_420=True, intra_qstep=24),
    dict(intra_qstep=24, gop_pattern=IBPBPBP),
    dict(chroma_420=True, gop_pattern=IBPBPBP),
], ids=["lossy_intra", "c420", "production_b", "c420_b_lossless"])
def test_port_roundtrip(kw, rng, tmp_path):
    """The port alone: Encoder -> save_vcs -> load_vcs -> Decoder gives the
    frames the in-memory stream decodes to, and the loaded stream is the
    encoded one field for field (a lossy I-frame is the encoder's
    reconstruction, decoded again from the payload)."""
    frames = _clip(rng, 10, 32, 48)
    video = Encoder(CodecConfig.production(**kw), device="cpu",
                    gop_batch=2).encode_frames(frames)
    path = str(tmp_path / "v.vcs")
    bits.save_vcs(video, path, device="cpu")
    loaded = bits.load_vcs(path, device="cpu")
    _assert_fields(loaded, video, _dtypes(video.config))
    got = Decoder(device="cpu").decode(loaded)
    want = Decoder(device="cpu").decode(video)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_lossy_intra_file_is_smaller(rng, tmp_path):
    """intra_qstep=8 writes a smaller file than lossless intra (0), and
    each decodes as its in-memory stream does."""
    frames = _clip(rng, 8, 48, 64)
    sizes = {}
    for qstep in (0, 8):
        video = Encoder(CodecConfig.production(intra_qstep=qstep),
                        device="cpu", gop_batch=2).encode_frames(frames)
        path = str(tmp_path / f"q{qstep}.vcs")
        bits.save_vcs(video, path, device="cpu")
        loaded = bits.load_vcs(path, device="cpu")
        assert loaded.config.intra_qstep == qstep
        for a, b in zip(Decoder(device="cpu").decode(loaded),
                        Decoder(device="cpu").decode(video)):
            np.testing.assert_array_equal(a, b)
        sizes[qstep] = os.path.getsize(path)
    assert sizes[8] < sizes[0], sizes


@pytest.mark.parametrize("kw,calls", [
    (dict(intra_qstep=24), 1), (dict(), 1),
    (dict(chroma_420=True, intra_qstep=24), 2), (dict(chroma_420=True), 2),
    (dict(intra_i=False), 0),
], ids=["lossy", "lossless", "c420_lossy", "c420_lossless", "raw"])
def test_loader_decodes_one_batch_per_plane_shape(kw, calls, rng, tmp_path,
                                                  monkeypatch):
    """Three GOPs (two full, one I-only): the loader's intra decode is one
    call of the plain K6 per plane shape, holding every GOP's planes."""
    frames = _clip(rng, 9, 32, 48)
    cfg = CodecConfig.production(**kw)
    video = Encoder(cfg, device="cpu", gop_batch=1).encode_frames(frames)
    path = str(tmp_path / "v.vcs")
    bits.save_vcs(video, path, device="cpu")
    seen = []
    plain = intra.decode_planes_plain

    def counted(res, *args):
        seen.append(res.shape[0])
        return plain(res, *args)

    monkeypatch.setattr(intra, "decode_planes_plain", counted)
    loaded = bits.load_vcs(path, device="cpu")
    planes_per_gop = [1, 2] if cfg.chroma_420 else [3]
    assert sorted(seen) == ([3 * p for p in planes_per_gop]
                            if cfg.intra_i else [])
    assert len(seen) == calls
    _assert_fields(loaded, video, _dtypes(cfg))


@pytest.mark.parametrize("kw", [
    dict(intra_qstep=24), dict(), dict(chroma_420=True, intra_qstep=24),
    dict(chroma_420=True),
], ids=["lossy", "lossless", "c420_lossy", "c420_lossless"])
def test_gop_chunks_leave_bytes_and_fields(kw, rng, tmp_path, monkeypatch):
    """Five GOPs in chunks of two: the writer's lossless re-encode and the
    loader's intra decode go to the device in batches of GOP_CHUNK GOPs,
    and the file and the loaded stream are those of a single batch."""
    frames = _clip(rng, 17, 32, 48)
    cfg = CodecConfig.production(**kw)
    video = Encoder(cfg, device="cpu", gop_batch=2).encode_frames(frames)
    one, chunked = str(tmp_path / "one.vcs"), str(tmp_path / "chunked.vcs")
    bits.save_vcs(video, one, device="cpu")
    whole = bits.load_vcs(one, device="cpu")

    encoded, decoded = [], []
    enc, dec = bits.intra_codec.encode_intra_frame, intra.decode_planes_plain

    def counted_enc(planes, *args):
        encoded.append(planes.shape[0])
        return enc(planes, *args)

    def counted_dec(res, *args):
        decoded.append(res.shape[0])
        return dec(res, *args)

    monkeypatch.setattr(bits, "GOP_CHUNK", 2)
    monkeypatch.setattr(bits.intra_codec, "encode_intra_frame", counted_enc)
    monkeypatch.setattr(intra, "decode_planes_plain", counted_dec)
    bits.save_vcs(video, chunked, device="cpu")
    loaded = bits.load_vcs(chunked, device="cpu")
    assert open(chunked, "rb").read() == open(one, "rb").read()
    planes_per_gop = [1, 2] if cfg.chroma_420 else [3]
    batches = sorted(p * n for p in planes_per_gop for n in (2, 2, 1))
    assert sorted(encoded) == ([] if cfg.intra_qstep else batches)
    assert sorted(decoded) == batches
    _assert_fields(loaded, whole, _dtypes(cfg))
    _assert_fields(loaded, video, _dtypes(cfg))
