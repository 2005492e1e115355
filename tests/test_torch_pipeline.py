"""The whole vcs_h264_tpu_torch slice against the JAX package on the CPU:
Encoder.encode_frames -> .npz -> Decoder.decode with
CodecConfig.production(), raw I-frames and lossy intra I-frames
(intra_qstep=24), each package's stream decoded by the other, and the
port's isolation from JAX and from the GPU when run on the CPU (production,
reference mode, B-frames, 4:2:0 and the luma-only search). Reference mode,
B-frames, 4:2:0 and the luma-only search against the JAX package:
tests/test_torch_reference.py, tests/test_torch_bframes.py,
tests/test_torch_pipeline420.py, tests/test_torch_search_luma.py."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu.config import CodecConfig as JaxConfig  # noqa: E402
from vcs_h264_tpu.models.decoder import Decoder as JaxDecoder  # noqa: E402
from vcs_h264_tpu.models.encoder import Encoder as JaxEncoder  # noqa: E402
from vcs_h264_tpu.models.gop import EncodedGOP as JaxGOP  # noqa: E402
from vcs_h264_tpu.models.gop import EncodedVideo as JaxVideo  # noqa: E402

from vcs_h264_tpu_torch import CodecConfig  # noqa: E402
from vcs_h264_tpu_torch.interop import from_jax_video, to_numpy_video  # noqa: E402
from vcs_h264_tpu_torch.models import Decoder, EncodedVideo, Encoder  # noqa: E402
from vcs_h264_tpu_torch.models import intra_codec  # noqa: E402
from vcs_h264_tpu_torch.ops import inter_cuda, intra_cuda, motion_cuda  # noqa: E402

PAYLOAD = ("i_qcoef", "i_modes", "i_escape")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _assert_close_frames(got, want):
    assert len(got) == len(want)
    diff = np.abs(np.stack(got).astype(np.int64) - np.stack(want))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 1e-4


def _assert_same_stream(port, jax_video):
    assert len(port.gops) == len(jax_video.gops)
    for a, b in zip(port.gops, jax_video.gops):
        np.testing.assert_array_equal(a.i_frame.numpy(),
                                      np.asarray(b.i_frame))
        np.testing.assert_array_equal(a.mv.numpy(), np.asarray(b.mv))
        assert (a.residuals is None) == (b.residuals is None)
        if a.residuals is not None:
            assert a.residuals.dtype == torch.int16
            np.testing.assert_array_equal(a.residuals.numpy(),
                                          np.asarray(b.residuals))
        for k in PAYLOAD:
            assert (getattr(a, k) is None) == (getattr(b, k) is None), k
            if getattr(a, k) is not None:
                np.testing.assert_array_equal(getattr(a, k).numpy(),
                                              np.asarray(getattr(b, k)))


@pytest.mark.parametrize("n_frames", [10, 9])
def test_slice_matches_jax(rng, tmp_path, n_frames):
    """Two full IPPP GOPs plus a tail GOP (I + 1 P for 10 frames, the I-frame
    alone for 9): identical vectors and coefficients, decoded frames within
    +-1, and each package decodes the other's .npz."""
    frames = _clip(rng, n_frames, 64, 128)
    port = Encoder(CodecConfig.production(), device="cpu",
                   gop_batch=2).encode_frames(frames)
    jvid = JaxEncoder(JaxConfig.production(), gop_batch=2).encode_frames(frames)
    _assert_same_stream(port, jvid)
    assert any(g.mv.any() for g in port.gops), "search found no motion"

    dec = Decoder(device="cpu").decode(port)
    jdec = JaxDecoder().decode(jvid)
    _assert_close_frames(dec, jdec)
    assert all(f.shape == (64, 128, 3) and f.dtype == np.uint8 for f in dec)
    p_psnr = np.mean([10 * np.log10(255**2 / np.mean(
        (dec[i].astype(float) - frames[i]) ** 2))
        for i in range(n_frames) if i % 4])
    assert p_psnr > 30.0

    port.save_npz(tmp_path / "port.npz")
    jvid.save_npz(str(tmp_path / "jax.npz"))
    _assert_close_frames(JaxDecoder().decode(
        JaxVideo.load_npz(str(tmp_path / "port.npz"))), dec)
    from_jax_file = EncodedVideo.load_npz(str(tmp_path / "jax.npz"))
    _assert_same_stream(from_jax_file, jvid)
    _assert_close_frames(Decoder(device="cpu").decode(from_jax_file), jdec)
    assert motion_cuda.LAUNCHES == {"sad_search": 0, "compensate": 0}
    assert not any(inter_cuda.LAUNCHES.values())


@pytest.mark.parametrize("n_frames", [10, 9])
def test_lossy_intra_slice_matches_jax(rng, tmp_path, n_frames):
    """CodecConfig.production(intra_qstep=24): two full GOPs plus a tail GOP
    with a P-frame (10 frames) or the I-frame alone (9). Identical vectors,
    coefficients, I-frame reconstructions and intra payloads; the payload
    decodes to the stored I-frame; decoded frames within +-1; each package
    loads and decodes the other's .npz, payload keys included; the payload
    crosses in memory both ways."""
    frames = _clip(rng, n_frames, 64, 128)
    port = Encoder(CodecConfig.production(intra_qstep=24), device="cpu",
                   gop_batch=2).encode_frames(frames)
    jvid = JaxEncoder(JaxConfig.production(intra_qstep=24),
                      gop_batch=2).encode_frames(frames)
    _assert_same_stream(port, jvid)
    assert [g.num_p for g in port.gops][-1] == (1 if n_frames == 10 else 0)
    for g in port.gops:
        assert g.i_frame.dtype == torch.uint8 and g.i_qcoef.dtype == torch.int16
        assert torch.equal(intra_codec.decode_intra_frame_lossy(
            intra_codec.IntraFrameLossy(g.i_qcoef, g.i_modes, g.i_escape),
            24), g.i_frame)

    dec = Decoder(device="cpu").decode(port)
    jdec = JaxDecoder().decode(jvid)
    _assert_close_frames(dec, jdec)
    i_psnr = np.mean([10 * np.log10(255**2 / np.mean(
        (dec[i].astype(float) - frames[i]) ** 2))
        for i in range(0, n_frames, 4)])
    assert 20.0 < i_psnr < 60.0, i_psnr       # lossy, and not garbage

    port.save_npz(tmp_path / "port.npz")
    jvid.save_npz(str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert {f"gop{len(port.gops) - 1}_{k}" for k in ("iq", "imodes",
                                                        "iesc")} <= set(a.files)
        for k in a.files:
            if k != "_meta":
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k])
    from_port_file = JaxVideo.load_npz(str(tmp_path / "port.npz"))
    _assert_same_stream(port, from_port_file)
    _assert_close_frames(JaxDecoder().decode(from_port_file), dec)
    from_jax_file = EncodedVideo.load_npz(str(tmp_path / "jax.npz"))
    _assert_same_stream(from_jax_file, jvid)
    _assert_close_frames(Decoder(device="cpu").decode(from_jax_file), jdec)

    _assert_same_stream(from_jax_video(jvid), jvid)
    back = to_numpy_video(port)
    rebuilt = JaxVideo(JaxConfig(**back["config"]), back["height"],
                       back["width"], back["fps"], back["num_frames"],
                       [JaxGOP(**g) for g in back["gops"]])
    _assert_same_stream(port, rebuilt)
    assert intra_cuda.LAUNCHES == {"intra_encode": 0, "intra_decode": 0}


def test_decoder_strips_the_intra_payload(rng, monkeypatch):
    """The P-frame decode never sees the lossy-intra payload: i_frame
    already holds its reconstruction, and uploading it would cost about an
    I-frame of host-to-device bytes per GOP."""
    from vcs_h264_tpu_torch.models import pipeline
    frames = _clip(rng, 6, 16, 32)
    video = Encoder(CodecConfig.production(intra_qstep=24), device="cpu",
                    gop_batch=1).encode_frames(frames)
    assert all(g.i_qcoef is not None for g in video.gops)
    seen = []
    orig = pipeline.decode_gop_batch

    def spy(gop, cfg, backend="auto"):
        seen.append([getattr(gop, k) for k in PAYLOAD])
        return orig(gop, cfg, backend)

    monkeypatch.setattr(pipeline, "decode_gop_batch", spy)
    assert len(Decoder(device="cpu").decode(video)) == 6
    assert seen and all(v is None for s in seen for v in s)


def test_all_intra_pattern_roundtrips_raw(rng):
    """gop_pattern ("I",): every GOP is an I-frame alone, stored raw, so
    decode returns the input exactly and no P-frame path runs."""
    frames = _clip(rng, 3, 16, 24)
    cfg = CodecConfig.production(gop_pattern=("I",))
    video = Encoder(cfg, device="cpu").encode_frames(frames)
    assert [g.num_p for g in video.gops] == [0, 0, 0]
    np.testing.assert_array_equal(
        np.stack(Decoder(device="cpu").decode(video)), np.stack(frames))


def test_interop_in_memory(rng):
    frames = _clip(rng, 6, 48, 64)
    jvid = JaxEncoder(JaxConfig.production()).encode_frames(frames)
    port = from_jax_video(jvid)
    _assert_same_stream(port, jvid)
    jdec = JaxDecoder().decode(jvid)
    _assert_close_frames(Decoder(device="cpu").decode(port), jdec)

    back = to_numpy_video(port)
    rebuilt = JaxVideo(JaxConfig(**back["config"]), back["height"],
                       back["width"], back["fps"], back["num_frames"],
                       [JaxGOP(**g) for g in back["gops"]])
    np.testing.assert_array_equal(np.stack(JaxDecoder().decode(rebuilt)),
                                  np.stack(jdec))


def test_pipeline_single_gop_entry_points(rng):
    from vcs_h264_tpu_torch.models import pipeline
    frames = _clip(rng, 3, 48, 64)
    planar = torch.from_numpy(np.stack(frames)).permute(0, 3, 1, 2).contiguous()
    cfg = CodecConfig.production()
    gop = pipeline.encode_gop(planar[0], planar[1:], cfg)
    assert gop.num_p == 2 and gop.num_coded == 3
    out = pipeline.decode_gop(gop, cfg)
    assert out.shape == (3, 3, 48, 64) and out.dtype == torch.uint8
    assert torch.equal(out[0], planar[0])


@pytest.mark.parametrize("kwargs", [
    dict(quant_mode="reference"), dict(gop_pattern=("I", "B", "P")),
    dict(with_residual=False), dict(chroma_420=True),
    dict(search_luma_only=True),
    dict(chroma_420=True, gop_pattern=("I", "B", "P")),
])
def test_now_ported_modes_run_in_the_entry_points(kwargs, tmp_path, rng):
    """Modes the entry points refused before they were ported (reference
    mode, B-frames, no residual, 4:2:0, the luma-only search): Encoder ->
    .npz -> Decoder gives every frame back. A raw I-frame comes back
    exactly, except in 4:2:0, which subsamples its chroma. The stream does
    not record `search_luma_only`, an encoder-side choice."""
    cfg = CodecConfig.production(**kwargs)
    frames = _clip(rng, cfg.gop_len + 2, 16, 16)
    Encoder(cfg, device="cpu").encode_frames(frames).save_npz(
        str(tmp_path / "v.npz"))
    loaded = EncodedVideo.load_npz(str(tmp_path / "v.npz"))
    assert loaded.config == dataclasses.replace(cfg, search_luma_only=False)
    out = Decoder(device="cpu").decode(loaded)
    assert len(out) == len(frames)
    assert all(f.shape == (16, 16, 3) and f.dtype == np.uint8 for f in out)
    if not cfg.chroma_420:
        np.testing.assert_array_equal(out[0], frames[0])


def test_checkpoints_not_ported(rng, tmp_path):
    """Checkpoints are ported now (tests/test_torch_checkpoint.py): a
    checkpointed encode writes one file per GOP and returns the stream an
    encode without them gives."""
    frames = _clip(rng, 6, 16, 16)
    enc = Encoder(CodecConfig.production(), device="cpu")
    video = enc.encode_frames(frames, checkpoint_dir=str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["gop_000000.npz",
                                            "gop_000001.npz"]
    want = enc.encode_frames(frames)
    for a, b in zip(video.gops, want.gops):
        assert torch.equal(a.mv, b.mv)
        assert torch.equal(a.residuals, b.residuals)


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for machines "
                    "without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        Encoder(CodecConfig.production())
    with pytest.raises(RuntimeError, match="CUDA"):
        Decoder(device="cuda")


_ISOLATION = """
import os
import sys
import tempfile
import numpy as np
import torch
torch.set_num_threads(1)
from vcs_h264_tpu_torch.io import bitstream
tmp_dir = tempfile.TemporaryDirectory()
tmp = tmp_dir.name
from vcs_h264_tpu_torch import CodecConfig
from vcs_h264_tpu_torch.models import Decoder, Encoder
from vcs_h264_tpu_torch.ops import inter_cuda, intra_cuda, motion_cuda
rng = np.random.default_rng(0)
from vcs_h264_tpu_torch import interop
from vcs_h264_tpu_torch.models import pipeline420
from vcs_h264_tpu_torch.ops import subsample
frames = [rng.integers(0, 256, (16, 32, 3), dtype=np.uint8) for _ in range(8)]
for cfg in (CodecConfig.production(), CodecConfig.production(intra_qstep=24),
            CodecConfig(), CodecConfig.bframes(),
            CodecConfig.production(chroma_420=True, intra_qstep=24),
            CodecConfig.production(chroma_420=True, intra_qstep=24,
                                   gop_pattern=("I", "B", "P")),
            CodecConfig.production(intra_qstep=24, search_luma_only=True)):
    video = Encoder(cfg, device="cpu").encode_frames(frames)
    assert len(Decoder(device="cpu").decode(video)) == 8
    assert len(interop.to_numpy_video(video)["gops"]) == len(video.gops)
    if cfg.quant_mode == "rounded":
        path = os.path.join(tmp, "v.vcs")
        bitstream.save_vcs(video, path, device="cpu")
        loaded = bitstream.load_vcs(path, device="cpu")
        assert len(Decoder(device="cpu").decode(loaded)) == 8
assert bitstream.native_loaded()
import json
from vcs_h264_tpu_torch.io import video as video_io
from vcs_h264_tpu_torch.utils import metrics, profiling
class Reader(list):
    fps = 10.0
for cfg in (CodecConfig.production(intra_qstep=24),
            CodecConfig.production(chroma_420=True, intra_qstep=24)):
    ckpt = os.path.join(tmp, "ckpt420" if cfg.chroma_420 else "ckpt")
    log = ckpt + ".jsonl"
    logger = metrics.MetricsLogger(log)
    enc = Encoder(cfg, 1, logger, True, device="cpu")
    video = enc.encode_stream(Reader(frames), checkpoint_dir=ckpt)
    logger.close()
    assert sorted(os.listdir(ckpt)) == ["gop_000000.npz", "gop_000001.npz"]
    resumed = Encoder(cfg, 1, device="cpu").encode_stream(
        Reader(frames), checkpoint_dir=ckpt)
    assert [np.array_equal(a, b) for a, b in zip(
        Decoder(device="cpu").decode(video),
        Decoder(device="cpu").iter_frames(resumed))] == [True] * 8
    events = [json.loads(line)["event"] for line in open(log)]
    assert events.count("gop") == 2 and "stage_timings" in events
with profiling.device_trace(os.path.join(tmp, "trace")):
    with profiling.trace_annotation("x"):
        metrics.psnr_t(torch.ones(4), torch.zeros(4))
assert os.listdir(os.path.join(tmp, "trace"))
assert video_io.group_into_gops(frames, 4)[1][1].shape == (3, 16, 32, 3)
import contextlib
import io
from vcs_h264_tpu_torch import cli, parallel
with contextlib.redirect_stdout(io.StringIO()) as out:
    try:
        cli.main(["--help"])
    except SystemExit as e:
        assert e.code == 0
    image = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
    pred, yres, modes = cli.intra_study(image, "4x4", "cpu")
    assert pred.shape == image.shape and modes.shape == (8, 12)
    assert cli.dct_study(image, 90.0, 8, "cpu").shape == image.shape
    assert cli.chroma_study(image, "cpu").shape == image.shape
printed = out.getvalue()
assert "encode" in printed and "sparsity (Y)" in printed, printed
assert parallel.init_distributed() == (0, 1)
from vcs_h264_tpu_torch.parallel import mesh as pmesh, spatial
from vcs_h264_tpu_torch.tools import bench_scaling
assert bench_scaling.MESHES[0] == (1, 1)
m = pmesh.make_mesh(1, 2, ["cpu", "cpu"])
i_b = torch.from_numpy(rng.integers(0, 256, (1, 3, 64, 32), dtype=np.uint8))
p_b = torch.from_numpy(rng.integers(0, 256, (1, 3, 3, 64, 32),
                                    dtype=np.uint8))
for cfg, enc, dec in (
        (CodecConfig.production(intra_qstep=24),
         spatial.sharded_encode_gop_batch, spatial.sharded_decode_gop_batch),
        (CodecConfig.production(chroma_420=True, intra_qstep=24),
         spatial.sharded_encode_gop_batch_420,
         spatial.sharded_decode_gop_batch_420)):
    assert dec(enc(i_b, p_b, cfg, m), cfg, m).shape == (1, 4, 3, 64, 32)
from vcs_h264_tpu_torch.tools import (bench_sustained, clips, exp_720_stages,
                                      profile_stages)
small = clips.planar(clips.synthetic_clip(0, 8, 16, 32))
with contextlib.redirect_stdout(io.StringIO()):
    assert len(profile_stages.main(small, 1, "cpu")["stages"]) == 10
    assert len(exp_720_stages.main(small, 1, "cpu")["stages"]) == 7
assert bench_sustained.sustained(
    clips.ClipReader(clips.synthetic_clip(0, 5, 16, 32)),
    CodecConfig.production(intra_qstep=24), device="cpu")["frames"] == 5
from vcs_h264_tpu_torch import bench
bench.N_ITERS, bench.N_REPEAT = 1, 1
bench.EXTRA_ITERS = dict.fromkeys(bench.EXTRA_ITERS, 1)
with contextlib.redirect_stdout(io.StringIO()):
    last = bench.run(clips.planar(clips.synthetic_clip(0, 8, 16, 32)), "cpu",
                     source="synthetic:0, 16x32")
assert "extras_error" not in last, last
assert last["production_fps_1920x1080_lumasearch"] > 0, last
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "vcs_h264_tpu", "cv2"))
launches = {**motion_cuda.LAUNCHES, **inter_cuda.LAUNCHES, **intra_cuda.LAUNCHES}
print(bad, launches)
sys.exit(1 if bad or any(launches.values()) else 0)
"""


def test_port_imports_no_jax_and_launches_nothing_on_cpu():
    proc = subprocess.run([sys.executable, "-c", _ISOLATION], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_refuses_to_run_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
