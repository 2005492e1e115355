"""The streaming path of vcs_h264_tpu_torch against the JAX package's on
the CPU: `Encoder.encode_stream` (chunks of gop_batch GOPs, checkpoints
named by their index in the whole stream) equals `encode_frames` and the
JAX package's `encode_stream`; the video I/O of `io/video.py` (cv2
imported inside its functions) reads, crops and writes as the JAX
package's does, and `Encoder.encode_video` and `Decoder.decode_to_file`
give the JAX package's stream and file; the decoder's host path
(`models/host_path.py`, plain buffers on the CPU) yields every frame as a
copy of its own, a batch's frames once the next batch is decoded, the
same frames at any gop_batch."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
cv2 = pytest.importorskip("cv2")

from vcs_h264_tpu.config import CodecConfig as JaxConfig  # noqa: E402
from vcs_h264_tpu.io import video as jvideo  # noqa: E402
from vcs_h264_tpu.models.decoder import Decoder as JaxDecoder  # noqa: E402
from vcs_h264_tpu.models.encoder import Encoder as JaxEncoder  # noqa: E402

from vcs_h264_tpu_torch import CodecConfig  # noqa: E402
from vcs_h264_tpu_torch.io import video  # noqa: E402
from vcs_h264_tpu_torch.models import Decoder, Encoder, pipeline  # noqa: E402
from vcs_h264_tpu_torch.models import encoder as encoder_mod  # noqa: E402
from vcs_h264_tpu_torch.models.host_path import HostPath  # noqa: E402

PROD = dict(quant_mode="rounded", intra_i=True, intra_qstep=24)


class Reader(list):
    """Frames in memory with the `fps` a reader has."""
    fps = 12.5


def _frames(seed, n, h=16, w=32):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 2 * n, w + 2 * n, 3))
    return [np.ascontiguousarray(base[t:t + h, t:t + w]).astype(np.uint8)
            for t in range(n)]


def _same(a, b):
    """Two streams (either package's) equal field for field."""
    assert (a.height, a.width, a.num_frames, a.fps) == \
        (b.height, b.width, b.num_frames, b.fps)
    assert len(a.gops) == len(b.gops)
    for ga, gb in zip(a.gops, b.gops):
        for f in dataclasses.fields(ga):
            x, y = getattr(ga, f.name), getattr(gb, f.name)
            assert (x is None) == (y is None), f.name
            if x is not None:
                y = np.asarray(y)
                np.testing.assert_array_equal(np.asarray(x).astype(y.dtype),
                                              y, err_msg=f.name)


@pytest.mark.parametrize("kw,n,gop_batch", [
    (PROD, 13, 1), (PROD, 8, 2), (dict(PROD, gop_pattern=("I", "B", "P")),
                                   11, 2),
    (dict(PROD, chroma_420=True), 10, 2)],
    ids=["production 13 frames", "production one chunk", "B", "4:2:0"])
def test_encode_stream_matches_encode_frames_and_jax(kw, n, gop_batch):
    frames = _frames(1, n)
    cfg = CodecConfig(**kw)
    got = Encoder(cfg, gop_batch, device="cpu").encode_stream(Reader(frames))
    want = Encoder(cfg, 8, device="cpu").encode_frames(frames, fps=12.5)
    _same(got, want)
    if not cfg.chroma_420:     # bare planes: +-1 ties (test_torch_pipeline420)
        _same(got, JaxEncoder(JaxConfig(**kw), gop_batch).encode_stream(
            Reader(frames)))


def test_encode_stream_of_nothing_raises():
    with pytest.raises(ValueError):
        Encoder(CodecConfig(**PROD), device="cpu").encode_stream(Reader())


def test_encode_stream_checkpoints_by_stream_index(tmp_path, monkeypatch):
    """Chunks of 2 GOPs write gop_000000 ... in stream order, the files
    encode_frames writes for the whole clip; a second pass encodes
    nothing."""
    frames = _frames(2, 18)
    cfg = CodecConfig(**PROD)
    d_stream, d_frames = str(tmp_path / "s"), str(tmp_path / "f")
    got = Encoder(cfg, 2, device="cpu").encode_stream(
        Reader(frames), checkpoint_dir=d_stream)
    Encoder(cfg, 2, device="cpu").encode_frames(frames,
                                                checkpoint_dir=d_frames)
    names = sorted(os.listdir(d_stream))
    assert names == sorted(os.listdir(d_frames)) == \
        [f"gop_{g:06d}.npz" for g in range(5)]
    for name in names:
        with np.load(os.path.join(d_stream, name)) as a, \
                np.load(os.path.join(d_frames, name)) as b:
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
    calls = []
    monkeypatch.setattr(pipeline, "encode_gop_batch",
                        lambda *a, **k: calls.append(1))
    monkeypatch.setattr(pipeline, "encode_gop",
                        lambda *a, **k: calls.append(1))
    again = Encoder(cfg, 2, device="cpu").encode_stream(
        Reader(frames), checkpoint_dir=d_stream)
    assert calls == []
    _same(again, got)


def test_group_into_gops_lives_in_io_video():
    assert encoder_mod.group_into_gops is video.group_into_gops
    frames = _frames(3, 9)
    for gop_len in (1, 4, 7):
        got = video.group_into_gops(frames, gop_len)
        want = jvideo.group_into_gops(frames, gop_len)
        assert len(got) == len(want)
        for (gi, gp), (wi, wp) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            assert gp.shape == wp.shape and gp.dtype == wp.dtype
            np.testing.assert_array_equal(gp, wp)


def _write_clip(path, frames, fps=12.0, fourcc="MJPG"):
    h, w = frames[0].shape[:2]
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps,
                          (w, h))
    assert out.isOpened()
    for f in frames:
        out.write(f)
    out.release()


@pytest.fixture
def clip(tmp_path):
    """A 9-frame 36x70 MJPG clip at 12 fps (not a block multiple)."""
    path = tmp_path / "clip.avi"
    _write_clip(path, _frames(4, 9, 36, 70))
    return str(path)


@pytest.mark.parametrize("block_multiple,max_frames", [
    (8, None), (16, 5), (4, 0), (8, 100)])
def test_video_reader_matches_jax(clip, block_multiple, max_frames):
    got = video.VideoReader(clip, block_multiple=block_multiple,
                            prefetch=2, max_frames=max_frames)
    want = jvideo.VideoReader(clip, block_multiple=block_multiple,
                              prefetch=2, max_frames=max_frames)
    assert (got.width, got.height, got.fps, got.out_h, got.out_w) == \
        (want.width, want.height, want.fps, want.out_h, want.out_w)
    assert (got.width, got.height, got.fps) == (70, 36, 12.0)
    assert got.out_h % block_multiple == got.out_w % block_multiple == 0
    frames, ref = got.read_all(), want.read_all()
    assert len(frames) == len(ref) == min(9, 9 if max_frames is None
                                          else max_frames)
    for a, b in zip(frames, ref):
        assert a.shape == (got.out_h, got.out_w, 3)
        np.testing.assert_array_equal(a, b)


def test_video_reader_refuses_a_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        video.VideoReader(str(tmp_path / "none.avi"))


@pytest.mark.parametrize("name,fourcc", [("out.mp4", "auto"),
                                         ("out.avi", "MJPG")])
def test_video_writer_matches_jax(tmp_path, name, fourcc):
    frames = _frames(5, 6, 32, 48)
    paths = []
    for mod, who in ((video, "port"), (jvideo, "jax")):
        path = str(tmp_path / f"{who}_{name}")
        w = mod.VideoWriter(path, 48, 32, 10.0, fourcc=fourcc)
        for f in frames:
            w.write(f)
        w.close()
        paths.append((path, w.fourcc))
    (p_path, p_fc), (j_path, j_fc) = paths
    assert p_fc == j_fc
    back = [jvideo.VideoReader(p, block_multiple=1).read_all()
            for p, _ in paths]
    assert len(back[0]) == len(back[1]) == len(frames)
    for a, b in zip(*back):
        np.testing.assert_array_equal(a, b)


def test_video_writer_refuses_an_unknown_fourcc(tmp_path):
    with pytest.raises(RuntimeError):
        video.VideoWriter(str(tmp_path / "x.mp4"), 16, 16, fourcc="ZZZZ")


@pytest.mark.parametrize("with_ckpt", [False, True])
def test_encode_video_matches_jax(clip, tmp_path, with_ckpt):
    kw = dict(checkpoint_dir=str(tmp_path / "ck")) if with_ckpt else {}
    got = Encoder(CodecConfig(**PROD), 2, device="cpu").encode_video(
        clip, max_frames=7, **kw)
    jkw = dict(checkpoint_dir=str(tmp_path / "jck")) if with_ckpt else {}
    want = JaxEncoder(JaxConfig(**PROD), 2).encode_video(clip, max_frames=7,
                                                         **jkw)
    assert (got.height, got.width, got.num_frames) == (32, 64, 7)
    _same(got, want)
    if with_ckpt:
        assert sorted(os.listdir(kw["checkpoint_dir"])) == \
            sorted(os.listdir(jkw["checkpoint_dir"]))


def test_encode_video_420_crops_to_twice_the_block(clip):
    got = Encoder(CodecConfig(**PROD, chroma_420=True), 2,
                  device="cpu").encode_video(clip, max_frames=5)
    assert (got.height, got.width) == (32, 64)


def test_decode_to_file_matches_jax(tmp_path):
    frames = _frames(6, 10, 32, 48)
    port = Encoder(CodecConfig(**PROD), 2, device="cpu").encode_frames(
        frames, fps=10.0)
    jvid = JaxEncoder(JaxConfig(**PROD), 2).encode_frames(frames, fps=10.0)
    p_path, j_path = str(tmp_path / "port.mp4"), str(tmp_path / "jax.mp4")
    Decoder(2, device="cpu").decode_to_file(port, p_path)
    JaxDecoder(2).decode_to_file(jvid, j_path)
    got = jvideo.VideoReader(p_path, block_multiple=1).read_all()
    want = jvideo.VideoReader(j_path, block_multiple=1).read_all()
    assert len(got) == len(want) == len(frames)
    # the same frames, up to the decoders' +-1 at rare .5 ties, through
    # the same lossy video codec
    diff = np.abs(np.stack(got).astype(np.int32) - np.stack(want))
    assert diff.mean() < 0.05
    # and the file holds what decode() returns, through that codec
    ref = str(tmp_path / "ref.mp4")
    w = video.VideoWriter(ref, 48, 32, 10.0)
    for f in Decoder(device="cpu").decode(port):
        w.write(f)
    w.close()
    with open(ref, "rb") as a, open(p_path, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("kw", [PROD, dict(PROD, chroma_420=True),
                                dict(gop_pattern=("I", "B", "P"))],
                         ids=["production", "4:2:0", "reference B"])
def test_iter_frames_copies_and_any_gop_batch(kw):
    frames = _frames(7, 11)
    v = Encoder(CodecConfig(**kw), 2, device="cpu").encode_frames(frames)
    ref = Decoder(8, device="cpu").decode(v)
    assert len(ref) == 11
    for gb in (1, 2, 3):
        got = list(Decoder(gb, device="cpu").iter_frames(v))
        assert all(np.array_equal(a, b) for a, b in zip(got, ref))
        assert all(f.flags.owndata and f.flags.c_contiguous for f in got)
        assert not any(np.shares_memory(a, b)
                       for a, b in zip(got, got[1:]))


def test_iter_frames_yields_a_batch_once_the_next_is_decoded(monkeypatch):
    """The host path's order on the CPU: frames of batch k come out after
    batch k+1's decode is queued; the last batch's once the stream ends."""
    frames = _frames(8, 12)
    v = Encoder(CodecConfig(**PROD), 1, device="cpu").encode_frames(frames)
    decoded = []
    real = pipeline.decode_gop_batch

    def counting(*a, **k):
        decoded.append(1)
        return real(*a, **k)
    monkeypatch.setattr(pipeline, "decode_gop_batch", counting)
    seen = [len(decoded) for _ in Decoder(1, device="cpu").iter_frames(v)]
    assert seen == [2] * 4 + [3] * 4 + [3] * 4


def test_host_path_on_the_cpu_is_plain():
    hp = HostPath(torch.device("cpu"))
    frames = _frames(9, 3)
    up = hp.upload_frames(frames)
    assert up.dtype == torch.uint8 and not up.is_pinned()
    np.testing.assert_array_equal(up.numpy(), np.stack(frames))
    t = [torch.arange(6, dtype=torch.int16).reshape(2, 3) + i
         for i in range(4)]
    assert torch.equal(hp.upload_stack(t), torch.stack(t))
    assert torch.equal(hp.download(up).wait(), up)
    assert not hasattr(hp, "h2d")
