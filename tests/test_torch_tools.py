"""The port's measurement tools (`vcs_h264_tpu_torch/tools/`:
`profile_stages`, `exp_720_stages`, `bench_sustained`, their frame source
`clips` and their measure `_timing`) against the JAX package's tools on
the CPU.

The JAX tools read a video file this repo does not hold, so they are
neither imported nor run: their stage names and JSON keys are read from
their source with `ast`, and each stage's body is written out below as the
JAX tool runs it (rolled inputs, no sums), on the same frames. Each port
stage's outputs at iterations 0 and 5 are held to it within the ROADMAP's
parity contract; the fused Pallas kernels run in interpret mode, as
tests/test_inter_pallas.py runs them."""

import ast
import dataclasses
import functools
import hashlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from vcs_h264_tpu.config import CodecConfig as JaxConfig  # noqa: E402
from vcs_h264_tpu.io import bitstream as jbits  # noqa: E402
from vcs_h264_tpu.models import intra_codec as jintra  # noqa: E402
from vcs_h264_tpu.models import pipeline as jpipe  # noqa: E402
from vcs_h264_tpu.models import pipeline420 as jp420  # noqa: E402
from vcs_h264_tpu.models.encoder import Encoder as JaxEncoder  # noqa: E402
from vcs_h264_tpu.ops import inter_pallas as JIP  # noqa: E402
from vcs_h264_tpu.ops import motion as jmotion  # noqa: E402

from vcs_h264_tpu_torch import CodecConfig  # noqa: E402
from vcs_h264_tpu_torch.models import Encoder  # noqa: E402
from vcs_h264_tpu_torch.tools import (_timing, bench_sustained,  # noqa: E402
                                      clips, exp_720_stages, profile_stages)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = {"profile_stages": profile_stages, "exp_720_stages": exp_720_stages}
QSTEP = 24
ITS = (0, 5)
COEF_ATOL = 1e-3     # reference mode's float32 coefficients (ROADMAP)
JCCFG = JaxConfig(quant_mode="rounded", chroma_420=True, intra_i=True,
                  intra_qstep=QSTEP)         # profile_stages' 4:2:0 config
# the hash of chip_smoke.synthetic_clip(0, 34) (1280x720) before it moved
# to tools/clips.py
CLIP_SHA256 = ("03bbb4001523fd3941e79b4381c9c291"
               "b90b1d4e65b5f53a8bbcf9a04223023b")


def _jax_tool(name):
    with open(os.path.join(REPO, "tools", f"{name}.py")) as fh:
        return ast.parse(fh.read())


def _jax_stage_names(name):
    """The stage names of a JAX tool, in its order: the keys of
    `profile_stages`'s stage dicts, the first argument of
    `exp_720_stages`'s `timed` calls."""
    names = []
    for node in ast.walk(_jax_tool(name)):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "timed":
            names.append((node.lineno, node.args[0].value))
        if isinstance(node, ast.Dict) and node.keys and all(
                isinstance(k, ast.Constant) and isinstance(v, ast.Call)
                for k, v in zip(node.keys, node.values)):
            names += [(k.lineno, k.value) for k in node.keys]
    return [n for _, n in sorted(names)]


def _jax_json_keys(name):
    """The keys of the dict a JAX tool passes to `json.dumps`."""
    for node in ast.walk(_jax_tool(name)):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "dumps":
            return [k.value for k in node.args[0].keys]
    raise AssertionError(f"no json.dumps in tools/{name}.py")


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_stage_names_match_the_jax_tool(name):
    assert list(TOOLS[name].EXPECTED_KERNELS) == _jax_stage_names(name)


def test_bench_sustained_keys_match_the_jax_tool():
    frames = clips.synthetic_clip(3, 5, 16, 32)
    got = bench_sustained.sustained(clips.ClipReader(frames),
                                    CodecConfig.production(intra_qstep=QSTEP),
                                    device="cpu")
    assert list(got)[:-2] == _jax_json_keys("bench_sustained")
    assert list(got)[-2:] == ["source", "note"]
    assert (got["res"], got["frames"], got["platform"], got["source"]) == \
        (16, 5, "cpu", "synthetic")
    assert all(got[k] > 0 for k in list(got)[3:10])


# ---- the stages against the JAX tools' bodies ------------------------------

@pytest.fixture(scope="module")
def arr():
    """12 frames (3 GOPs) of the synthetic clip at 36x48, tiled 2x2 as the
    tools tile the 640x360 source: 72x96, whose 4:2:0 crop is 64 rows."""
    return clips.tiled(clips.planar(clips.synthetic_clip(7, 12, 36, 48)), 2)


@pytest.fixture(scope="module")
def port_stages(arr):
    i_b, p_b = clips.gop_batches(arr, 4, "cpu")
    return {name: tool.build_stages(i_b, p_b) for name, tool in TOOLS.items()}


@pytest.fixture(scope="module")
def jax_stages(arr):
    mp = pytest.MonkeyPatch()
    orig = pl.pallas_call

    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    mp.setattr(JIP.pl, "pallas_call", interpreted)
    yield _jax_stages(arr)
    mp.undo()


def _jax_stages(arr):
    g = 4
    b = len(arr) // g
    a = arr.astype(np.int32)              # the JAX tools' frames are int32
    i_b = jnp.asarray(a[::g][:b])
    p_b = jnp.asarray(np.stack([a[k * g + 1:k * g + g] for k in range(b)]))
    return {"profile_stages": _jax_profile_stages(i_b, p_b),
            "exp_720_stages": _jax_exp_720_stages(i_b, p_b)}


def _roll(x, it):
    return jnp.roll(x, it & 7, axis=-1)


def _jax_profile_stages(i_b, p_b):
    """tools/profile_stages.py's stage bodies, their outputs unsummed."""
    cfg = JaxConfig()
    kw = dict(bs=cfg.block_size, reach=cfg.search_reach,
              step=cfg.search_step, static_threshold=cfg.static_threshold)
    mv0 = functools.cache(lambda: jmotion.motion_search_gops(p_b, i_b,
                                                             **kw))
    recon0 = functools.cache(lambda: jmotion.motion_compensate_gops(
        mv0(), i_b, bs=cfg.block_size, reach=cfg.search_reach))
    pay0 = functools.cache(
        lambda: jintra.encode_intra_frames_lossy_batch(i_b, QSTEP)[0])
    pcfg = JaxConfig.production(intra_qstep=QSTEP)
    ccfg = JCCFG
    h420 = (i_b.shape[-2] // 16) * 16

    def resid(it):
        return jmotion.residuals_wrap(_roll(p_b, it), recon0())

    def production(it):
        pay, i_rec = jintra.encode_intra_frames_lossy_batch(_roll(i_b, it),
                                                            QSTEP)
        enc = jpipe.encode_gop_batch(i_rec, _roll(p_b, it), pcfg)
        return pay, enc, jpipe.decode_gop_batch(enc, pcfg)

    def chroma420(it):
        enc = jp420.encode_gop_batch_420(
            i_b[..., :h420, :], _roll(p_b, it)[..., :h420, :], ccfg)
        return enc, jp420.decode_gop_batch_420(enc, ccfg)

    def encode_decode(it):
        enc = jpipe.encode_gop_batch(i_b, _roll(p_b, it), cfg)
        return enc, jpipe.decode_gop_batch(enc, cfg)

    return {
        "search": lambda it: jmotion.motion_search_gops(_roll(p_b, it), i_b,
                                                        **kw),
        "compensate": lambda it: jmotion.motion_compensate_gops(
            jnp.roll(mv0(), it & 1, axis=2), i_b, bs=cfg.block_size,
            reach=cfg.search_reach),
        "resid_dct_enc": lambda it: jpipe.dct_compress_residual(resid(it),
                                                                cfg),
        "resid_dct_encdec": lambda it: jpipe.dct_decompress_residual(
            jpipe.dct_compress_residual(resid(it), cfg), cfg),
        "encode": lambda it: jpipe.encode_gop_batch(i_b, _roll(p_b, it), cfg),
        "encode+decode": encode_decode,
        "intra_lossy_enc": lambda it: jintra.encode_intra_frames_lossy_batch(
            _roll(i_b, it), QSTEP),
        "intra_lossy_dec": lambda it: jintra.decode_intra_frames_lossy_batch(
            jintra.IntraFrameLossy(_roll(pay0().qcoef, it), pay0().modes,
                                   pay0().escape), QSTEP),
        "production_e2e": production,
        "chroma420_e2e": chroma420,
    }


def _jax_exp_720_stages(i_b, p_b):
    """tools/exp_720_stages.py's stage bodies, their outputs unsummed."""
    cfg = JaxConfig.production(intra_qstep=QSTEP)
    bs, reach, qf = cfg.block_size, cfg.search_reach, cfg.quality_factor
    kw = dict(bs=bs, reach=reach, step=cfg.search_step,
              static_threshold=cfg.static_threshold)
    pay0 = functools.cache(
        lambda: jintra.encode_intra_frames_lossy_batch(i_b, QSTEP)[0])
    mv0 = functools.cache(lambda: jmotion.motion_search_gops(p_b, i_b,
                                                             **kw))
    co0 = functools.cache(lambda: JIP.encode_p_coeffs_fused(
        mv0(), i_b, p_b, bs, reach, qf))

    def inter(it):
        enc = jpipe.encode_gop_batch(i_b, _roll(p_b, it), cfg)
        return enc, jpipe.decode_gop_batch(enc, cfg)

    def xla_enc(it):
        recon = jmotion.motion_compensate_gops(mv0(), i_b, bs=bs,
                                               reach=reach)
        return jpipe.dct_compress_residual_signed(_roll(p_b, it) - recon, cfg)

    return {
        "intra_enc": lambda it: jintra.encode_intra_frames_lossy_batch(
            _roll(i_b, it), QSTEP),
        "intra_dec": lambda it: jintra.decode_intra_frames_lossy_batch(
            jintra.IntraFrameLossy(_roll(pay0().qcoef, it), pay0().modes,
                                   pay0().escape), QSTEP),
        "inter_encdec": inter,
        "search": lambda it: jmotion.motion_search_gops(_roll(p_b, it), i_b,
                                                        **kw),
        "fused_enc": lambda it: JIP.encode_p_coeffs_fused(
            mv0(), i_b, _roll(p_b, it), bs, reach, qf),
        "fused_dec": lambda it: JIP.decode_p_frames_fused(
            mv0(), i_b, _roll(co0(), it), bs, reach, qf),
        "xla_enc(comp+dctq)": xla_enc,
    }


def _same(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  want.astype(np.int64))


def _frames_close(got, want):
    """Decoded samples identical, or +-1 on fewer than 1e-4 of them."""
    diff = np.abs(got.numpy().astype(np.int64) - np.asarray(want))
    assert diff.shape == got.shape
    assert diff.max() <= 1 and (diff != 0).mean() < 1e-4


def _coef_close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=COEF_ATOL,
                               rtol=0)


def _gop_fields(got, want, float_res=False):
    """An EncodedGOP (420) batch against JAX's: every integer field
    identical, reference mode's float residuals within COEF_ATOL."""
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            (_coef_close if float_res and f.name == "residuals"
             else _same)(a, b)


def _bare_close(got, want):
    """Bare-plane coefficients: +-1 on fewer than 1e-3 of them."""
    diff = np.abs(got.numpy().astype(np.int64) - np.asarray(want))
    assert diff.shape == got.shape
    assert diff.max() <= 1 and (diff != 0).mean() < 1e-3


def _check_420(got, want):
    """The 4:2:0 stage under the bare-plane contract: every field but the
    residuals identical, the residuals +-1 on fewer than 1e-3; the port's
    decode against the JAX package's decode of the same (the port's)
    stream, +-2 on fewer than 1e-3 of BGR values."""
    (enc, dec), (jenc, _) = got, want
    fields = {}
    for f in dataclasses.fields(enc):
        a, b = getattr(enc, f.name), getattr(jenc, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            (_bare_close if f.name in ("res_y", "res_c") else _same)(a, b)
            fields[f.name] = jnp.asarray(a.numpy()).astype(b.dtype)
    same_stream = jp420.decode_gop_batch_420(jp420.EncodedGOP420(**fields),
                                             JCCFG)
    diff = np.abs(dec.numpy().astype(np.int64) - np.asarray(same_stream))
    assert diff.shape == dec.shape
    assert diff.max() <= 2 and (diff != 0).mean() < 1e-3


def _payload(got, want):
    for a, b in zip(got, want):
        _same(a, b)


# each stage's comparison: port outputs, JAX outputs
CHECKS = {
    "search": _same,
    "compensate": _same,
    "resid_dct_enc": _coef_close,
    "resid_dct_encdec": _frames_close,
    "encode": lambda g, w: _gop_fields(g, w, float_res=True),
    "encode+decode": lambda g, w: (_gop_fields(g[0], w[0], float_res=True),
                                   _frames_close(g[1], w[1])),
    "intra_lossy_enc": lambda g, w: (_payload(g[0], w[0]), _same(g[1], w[1])),
    "intra_lossy_dec": _same,
    "production_e2e": lambda g, w: (_payload(g[0], w[0]),
                                    _gop_fields(g[1], w[1]),
                                    _frames_close(g[2], w[2])),
    "chroma420_e2e": _check_420,
    "intra_enc": lambda g, w: (_payload(g[0], w[0]), _same(g[1], w[1])),
    "intra_dec": _same,
    "inter_encdec": lambda g, w: (_gop_fields(g[0], w[0]),
                                  _frames_close(g[1], w[1])),
    "fused_enc": _same,
    "fused_dec": _frames_close,
    "xla_enc(comp+dctq)": _same,
}

# the stages that compile the JAX package's lossy intra (about 15 s each
# on a CPU with a cold cache) are tested in tests/test_torch_tools_intra.py
# and tests/test_torch_tools_420.py, so that xdist runs them apart
INTRA_STAGES = ("intra_lossy_enc", "intra_lossy_dec", "production_e2e",
                "intra_enc", "intra_dec")
C420_STAGES = ("chroma420_e2e",)


def stage_cases(names) -> list:
    """(tool, stage, it) of the stages `names` of both tools."""
    return [(tool, name, it) for tool, mod in sorted(TOOLS.items())
            for name in mod.EXPECTED_KERNELS if name in names for it in ITS]


def check_stage(port_stages, jax_stages, tool, name, it):
    CHECKS[name](port_stages[tool][name](it), jax_stages[tool][name](it))


def test_stages_are_split_between_the_files():
    names = {n for mod in TOOLS.values() for n in mod.EXPECTED_KERNELS}
    assert set(INTRA_STAGES) | set(C420_STAGES) < names


@pytest.mark.parametrize("tool,name,it", stage_cases(
    set(CHECKS) - set(INTRA_STAGES) - set(C420_STAGES)))
def test_stage_matches_the_jax_tool(port_stages, jax_stages, tool, name, it):
    check_stage(port_stages, jax_stages, tool, name, it)


def test_prerolled_copies_equal_np_roll():
    x = np.random.default_rng(0).integers(0, 256, (2, 3, 3, 8, 24), np.uint8)
    copies = _timing.rolled(torch.from_numpy(x))
    assert len(copies) == _timing.ROLLS == 8
    for k, c in enumerate(copies):
        assert c.is_contiguous()
        np.testing.assert_array_equal(c.numpy(), np.roll(x, k, axis=-1))
    for k, c in enumerate(_timing.rolled(torch.from_numpy(x), 2, dim=2)):
        np.testing.assert_array_equal(c.numpy(), np.roll(x, k, axis=2))


def test_synthetic_clip_keeps_its_bytes():
    frames = clips.synthetic_clip(0, 34)
    a = np.stack(frames)
    assert a.shape == (34, 720, 1280, 3) and a.dtype == np.uint8
    assert hashlib.sha256(a.tobytes()).hexdigest() == CLIP_SHA256


def test_tiling_and_gops_match_the_jax_tools():
    src = clips.planar(clips.synthetic_clip(1, 9, 368, 24))
    assert src.shape == (9, 3, 368, 24)
    np.testing.assert_array_equal(clips.tiled(src, 2),
                                  np.tile(src, (1, 1, 2, 2)))
    three = clips.tiled(src, 3)           # bench.py's 1080p crop
    np.testing.assert_array_equal(three,
                                  np.tile(src, (1, 1, 3, 3))[..., :1080, :1920])
    assert three.shape == (9, 3, 1080, 72)
    i_b, p_b = clips.gop_batches(src, 4, "cpu")
    np.testing.assert_array_equal(i_b.numpy(), src[::4][:2])
    np.testing.assert_array_equal(
        p_b.numpy(), np.stack([src[k * 4 + 1:k * 4 + 4] for k in range(2)]))
    with pytest.raises(ValueError):
        clips.gop_batches(src[:3], 4, "cpu")


def test_cpu_measure_has_no_device_numbers():
    calls = []
    r = _timing.measure(lambda it: calls.append(it) or torch.ones(4) * it, 3,
                        torch.device("cpu"))
    assert calls == [0, 0, 1, 2]          # one warm iteration, then 3
    assert r["ms"] > 0 and r["device_ms"] is None and r["launches"] is None


class _FakeEvent:
    """A CUDA event on a fake device: each iteration's window takes 2 ms;
    `started[0]` says whether the device has reached it when queried."""
    started = [False]
    t = [0.0]

    def __init__(self, enable_timing):
        assert enable_timing

    def record(self):
        _FakeEvent.t[0] += 1.0
        self.at = _FakeEvent.t[0] * 2.0

    def query(self):
        return _FakeEvent.started[0]

    def elapsed_time(self, end):
        return end.at - self.at


def _fake_cuda(monkeypatch, started):
    holds = []
    seq = iter(started)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "_sleep",
                        lambda cycles: (holds.append(cycles),
                                        _FakeEvent.started.__setitem__(
                                            0, next(seq))))
    monkeypatch.setattr(_timing, "_sync", lambda device: None)
    return holds


def test_queued_device_ms_times_again_when_the_host_fell_behind(monkeypatch):
    # attempt 0: the device reached the second iteration before the host
    # had queued it; attempt 1, with holds 4x longer: the host was ahead
    holds = _fake_cuda(monkeypatch, [False, True, False, False, False,
                                     False, False, False])
    calls = []
    ms = _timing.queued_device_ms(lambda it: calls.append(it), 3,
                                  torch.device("cuda"), host_ms=10.0)
    assert ms == 2.0
    assert calls == [0, 1, 2, 0, 1, 2]
    first = int(_timing.hold_seconds(10.0, 0) * _timing.HOLD_HZ)
    assert _timing.hold_seconds(10.0, 0) == pytest.approx(0.025)
    assert holds == [first] * 3 + [4 * first] * 3


def test_queued_device_ms_raises_when_the_host_never_gets_ahead(monkeypatch):
    _fake_cuda(monkeypatch, [True] * 2 * _timing.QUEUE_ATTEMPTS)
    with pytest.raises(RuntimeError, match="before the host"):
        _timing.queued_device_ms(lambda it: None, 2, torch.device("cuda"),
                                 host_ms=1.0)


# ---- bench_sustained against the JAX package -------------------------------

class Sink(list):
    """Keeps the frames written to it."""
    write = list.append


def test_sustained_matches_jax_bytes_and_range_coder(tmp_path):
    frames = clips.synthetic_clip(2, 8, 32, 48)    # 2 GOPs
    cfg = CodecConfig.production(intra_qstep=QSTEP)
    jcfg = JaxConfig.production(intra_qstep=QSTEP)
    sink = Sink()
    got = bench_sustained.sustained(clips.ClipReader(frames), cfg,
                                    device="cpu", out_dir=str(tmp_path),
                                    sink=sink)
    assert got["frames"] == len(sink) == 8
    jvideo = JaxEncoder(jcfg, gop_batch=8).encode_stream(
        clips.ClipReader(frames))
    jbits.save_vcs(jvideo, str(tmp_path / "jax.vcs"))
    blob = (tmp_path / "out.vcs").read_bytes()
    assert blob == (tmp_path / "jax.vcs").read_bytes()
    assert got["vcs_bytes_per_frame"] == len(blob) // 8

    video = Encoder(cfg, 8, device="cpu").encode_stream(
        clips.ClipReader(frames))
    streams = bench_sustained.range_coder_streams(video, 8)
    want = [jbits._zigzag_plane(np.round(np.asarray(g.residuals))
                                .astype(np.int16), 8)
            for g in jvideo.gops if g.residuals is not None]
    assert len(streams) == len(want) == 2
    for s, w in zip(streams, want):
        assert s.dtype == np.int16
        np.testing.assert_array_equal(s, w)
    blobs, t_enc, t_dec = bench_sustained.range_coder_bench(streams, 8)
    assert blobs == [jbits.rc_encode_i16_cbf(w, 64) for w in want]
    assert t_enc > 0 and t_dec > 0


# ---- the command lines, the --video layer -----------------------------------

def _write_clip(path, frames):
    import cv2
    h, w = frames[0].shape[:2]
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 12.0,
                          (w, h))
    assert out.isOpened()
    for f in frames:
        out.write(f)
    out.release()


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 9-frame 32x48 MJPG clip at 12 fps."""
    pytest.importorskip("cv2")
    path = tmp_path_factory.mktemp("clip") / "clip.avi"
    _write_clip(path, clips.synthetic_clip(5, 9, 32, 48))
    return str(path)


def test_read_video(clip):
    frames = clips.read_video(clip, 5)
    assert len(frames) == 5 and frames[0].shape == (32, 48, 3)
    assert len(clips.read_video(clip, 100)) == 9
    assert clips.source_frames(clip, 0, 4)[1] == clip
    assert clips.source_frames(None, 3, 2)[1] == "synthetic:3"
    with pytest.raises(FileNotFoundError):
        clips.read_video(clip + ".none", 1)


@pytest.mark.parametrize("tool,argv", [
    ("profile_stages", ["--res", "720"]),
    ("exp_720_stages", ["--frames", "8", "--iters", "1", "--tile", "2"]),
])
def test_stage_tool_reads_a_video(clip, capsys, tool, argv):
    out = TOOLS[tool].cli(argv + ["--video", clip, "--device", "cpu"])
    printed = capsys.readouterr().out.splitlines()
    assert json.loads(printed[-1]) == out
    assert (out["device"], out["source"], out["res"]) == ("cpu", clip,
                                                          "96x64")
    assert list(out["stages"]) == list(TOOLS[tool].EXPECTED_KERNELS)
    for name, r in out["stages"].items():
        assert r["ms"] > 0 and r["device_ms"] is None \
            and r["launches"] is None
        assert any(line.startswith(name + " ") for line in printed)


@pytest.mark.parametrize("res", ["360", "720"])
def test_bench_sustained_reads_and_writes_video(clip, capsys, res):
    out = bench_sustained.cli(["--video", clip, "--res", res, "--frames",
                               "6", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out
    assert list(out) == _jax_json_keys("bench_sustained") + ["source"]
    assert (out["res"], out["frames"], out["platform"]) == (
        int(res) // 360 * 32, 6, "cpu")


@pytest.mark.parametrize("tool,argv", [
    ("profile_stages", ["--res", "720"]),
    ("exp_720_stages", ["--frames", "4"]),
    ("bench_sustained", ["--frames", "4"]),
])
def test_cuda_without_a_card_raises(tool, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for machines "
                    "without one")
    mod = TOOLS.get(tool, bench_sustained)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.cli(argv + ["--synthetic", "0"])
