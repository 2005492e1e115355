"""The port's bench (`vcs_h264_tpu_torch/bench.py`) against the root
`bench.py` on the CPU.

`bench.py` reads a video this repo does not hold and its loops are
closures, so it is neither imported nor run: its constants and the keys of
its lines are read from its source with `ast`, and each step it times is
written out below as it composes it (`bench.py:122-128, 169-175`), on the
same frames (the synthetic clip at 64x96, 8 frames, 2 GOPs; int32 on the
JAX side, as `bench.py:112-115` uploads them). Each port step at rolls 0
and 5 is held to it within the ROADMAP's parity contract. The production
loops: tests/test_torch_bench_intra.py; the 4:2:0 step:
tests/test_torch_bench_420.py (they compile the JAX package's lossy intra,
about 15-25 s a shape, and xdist runs the files apart)."""

import ast
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vcs_h264_tpu.config import CodecConfig as JaxConfig  # noqa: E402
from vcs_h264_tpu.models import pipeline as jpipe  # noqa: E402

from test_torch_tools import _frames_close, _gop_fields  # noqa: E402
from vcs_h264_tpu_torch import CodecConfig, bench  # noqa: E402
from vcs_h264_tpu_torch.tools import clips  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITS = (0, 5)
G = 4
BASE_FPS = 1.4171794083620084        # BASELINE_MEASURED.json end_to_end_fps
KEYS = ("encode_decode_fps_640x360", "production_fps_640x360",
        "encode_decode_fps_1280x720", "encode_decode_fps_1280x720_lumasearch",
        "chroma420_fps_640x352", "production_fps_1920x1080",
        "production_fps_1920x1080_lumasearch")


def _jax_bench():
    with open(os.path.join(REPO, "bench.py")) as fh:
        return ast.parse(fh.read())


def _jax_constants() -> dict:
    return {t.id: ast.literal_eval(n.value)
            for n in _jax_bench().body if isinstance(n, ast.Assign)
            for t in n.targets if isinstance(t, ast.Name)
            and isinstance(n.value, ast.Constant)}


def _jax_result_keys() -> list:
    """The keys of `bench.py`'s `result`, in the order they first appear
    in its source: the dict literal, `result.update(...)`, then each
    `result[...] =`; without the popped "provisional" and the error."""
    found = []
    for node in ast.walk(_jax_bench()):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and getattr(node.targets[0], "id", "") == "result":
            found += [(k.lineno, k.value) for k in node.value.keys]
        elif isinstance(node, ast.Call) \
                and getattr(node.func, "attr", "") == "update" \
                and getattr(node.func.value, "id", "") == "result":
            found += [(kw.value.lineno, kw.arg) for kw in node.keywords]
        elif isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, ast.Store) \
                and getattr(node.value, "id", "") == "result":
            found.append((node.lineno, node.slice.value))
    keys = []
    for _, k in sorted(found):
        if k not in keys and k not in ("provisional", "extras_error"):
            keys.append(k)
    return keys


def _jax_placeholder_keys() -> list:
    for node in ast.walk(_jax_bench()):
        if isinstance(node, ast.Dict) and any(
                getattr(k, "value", None) == "note" for k in node.keys):
            return [k.value for k in node.keys]
    raise AssertionError("no placeholder in bench.py")


# ---- the frames, the JAX compositions --------------------------------------

@pytest.fixture(scope="module")
def arr():
    """The synthetic clip at 64x96, 8 frames: 2 GOPs of 4."""
    return clips.planar(clips.synthetic_clip(0, 8, 64, 96))


@pytest.fixture(scope="module")
def port_in(arr):
    return clips.gop_batches(arr, G, "cpu")


@pytest.fixture(scope="module")
def jax_in(arr):
    """bench.py:109-115: I-frames and P-frames as int32."""
    a = arr.astype(np.int32)
    b = len(a) // G
    return (jnp.asarray(a[::G][:b]),
            jnp.asarray(np.stack([a[k * G + 1:k * G + G] for k in range(b)])))


def jroll(x, it):
    return jnp.roll(x, it & 7, axis=-1)


def jax_enc_dec(cfg):
    """bench.py:117-120."""
    def enc_dec(i_frames, p_frames):
        enc = jpipe.encode_gop_batch(i_frames, p_frames, cfg)
        dec = jpipe.decode_gop_batch(enc, cfg)
        return enc, dec
    return enc_dec


@pytest.fixture(scope="module")
def jax_steps():
    """bench.py's psnr_step (:122-128) and its headline step's body
    (:169-175) under jit, as bench.py compiles them."""
    enc_dec = jax_enc_dec(JaxConfig())

    @jax.jit
    def psnr_step(i_frames, p_frames):
        enc, dec = enc_dec(i_frames, p_frames)
        err = (dec[:, 1:] - p_frames).astype(jnp.float32)
        mse = jnp.mean(err * err, axis=(2, 3, 4))      # [B, P] per frame
        sink = jnp.sum(enc.mv) + jnp.sum(dec)
        return mse, sink

    return {"psnr_step": psnr_step, "enc_dec": jax.jit(enc_dec)}


def jax_psnr_capped99(mse, b):
    """bench.py:137-143."""
    mse_r = np.asarray(mse).ravel()
    p_psnr = np.where(mse_r > 0,
                      10 * np.log10(255.0 ** 2 / np.maximum(mse_r, 1e-12)),
                      np.inf)
    per_frame = np.concatenate([np.full(b, np.inf), p_psnr])
    return float(np.mean(np.minimum(per_frame, 99.0)))


# ---- the steps against bench.py's ------------------------------------------

def test_psnr_step_matches_bench_py(port_in, jax_in, jax_steps):
    mse, total = bench.psnr_step(*port_in, CodecConfig())
    jmse, jtotal = jax_steps["psnr_step"](*jax_in)
    assert mse.dtype == torch.float32 and mse.shape == jmse.shape == (2, 3)
    np.testing.assert_allclose(mse.numpy(), np.asarray(jmse), rtol=1e-3)
    got = bench.psnr_capped99(mse.numpy(), 2)
    want = jax_psnr_capped99(jmse, 2)
    assert 30 < want < 99 and abs(got - want) < 0.01
    assert total.dtype == torch.int64 and total.dim() == 0
    # the sinks are the sums of the same outputs; the frames may differ by
    # +-1 on fewer than 1e-4 of 49 152 samples, so by at most 4
    assert abs(int(total) - int(jtotal)) <= 4


@pytest.mark.parametrize("it", ITS)
def test_headline_step_matches_bench_py(port_in, jax_in, jax_steps, it):
    i_b, p_b = jax_in
    (enc, dec), total = bench.headline_step(*port_in, CodecConfig())(it)
    jenc, jdec = jax_steps["enc_dec"](i_b, jroll(p_b, it))
    _gop_fields(enc, jenc, float_res=True)
    _frames_close(dec, jdec)
    assert int(total) == int(enc.mv.sum()) + int(dec.sum())


def test_headline_steps_roll_the_p_frames(port_in):
    step = bench.headline_step(*port_in, CodecConfig())
    (enc0, _), _ = step(0)
    (enc8, _), _ = step(8)                  # it & 7 == 0
    (enc5, _), _ = step(5)
    assert torch.equal(enc0.mv, enc8.mv)
    assert torch.equal(enc0.i_frame, enc5.i_frame)
    assert not torch.equal(enc0.residuals, enc5.residuals)


# ---- the keys: what the bench and chip_smoke.py time ------------------------

def _budget(*values):
    """A `left()` that reads `values` in turn, then the last for ever."""
    it = iter(values)
    last = [values[-1]]

    def left():
        last[0] = next(it, last[0])
        return last[0]
    return left


@pytest.mark.parametrize("left, n_extras", [
    ((900,), 6), ((100,), 4), ((44,), 0),
    # bench.py:256-320 reads the budget before each extra, and skips the
    # luma-only key with its plain one (720p nested; 1080p at 120 s)
    ((900, 900, 44), 2), ((900, 900, 900, 900, 119), 4),
    ((900, 900, 900, 900, 900, 44), 5)])
def test_keys_follow_bench_py_budget(arr, left, n_extras):
    got = list(bench.keys(arr, "cpu", _budget(*left)))
    assert [k.name for k in got] == ["provisional", *KEYS[:1 + n_extras]]
    loops = [list(k.loops) for k in got]
    assert loops[:2] == [["psnr_step"], ["headline"]]
    assert all(set(lp) <= set(bench.EXPECTED_KERNELS) for lp in loops)
    assert [k.n_iters for k in got[:2]] == [1, bench.N_ITERS]
    assert all(k.n_iters == bench.EXTRA_ITERS[k.name.replace(
        "_lumasearch", "")] for k in got[2:])


# ---- the lines -------------------------------------------------------------

def test_constants_match_bench_py():
    c = _jax_constants()
    assert (bench.N_FRAMES, bench.N_ITERS, bench.N_REPEAT, bench.QSTEP) == \
        (c["N_FRAMES"], c["N_ITERS"], c["N_REPEAT"], c["QSTEP"])
    assert list(bench.EXTRA_ITERS.values()) == [8, 4, 8, 4]   # bench.py:
    assert set(bench.EXTRA_ITERS) < set(KEYS)          # 256-320's loops
    assert bench.load_baseline() == (BASE_FPS, pytest.approx(54.366, 1e-4))


def test_lines_keys_and_frame_counts(arr, monkeypatch, capsys):
    """A CPU run of `run` with a clock that advances one second a reading,
    so every timed window is one second and each value is its frame count
    (over two windows for the production keys)."""
    ticks = iter(range(10 ** 6))
    monkeypatch.setattr(bench, "now", lambda: float(next(ticks)))
    monkeypatch.setattr(bench, "N_ITERS", 2)
    monkeypatch.setattr(bench, "EXTRA_ITERS", {
        "production_fps_640x360": 2, "encode_decode_fps_1280x720": 1,
        "chroma420_fps_640x352": 3, "production_fps_1920x1080": 1})
    last = bench.run(arr, "cpu", source="synthetic:0")
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]

    first, provisional = lines[0], lines[1]
    assert [k for k in first if k != "source"] == _jax_placeholder_keys()
    assert first["value"] == 0 and first["provisional"] is True
    assert provisional["provisional"] is True
    assert provisional["value"] == 8.0                  # b * g / one window
    assert provisional["device"] == "cpu"
    assert lines[-1] == last and "provisional" not in last
    assert "extras_error" not in last
    assert [k for k in last if k != "source"] == _jax_result_keys()
    assert last["metric"] == KEYS[0]
    assert [k for k in last if k in KEYS] == list(KEYS[1:])
    assert all(line["source"] == "synthetic:0" for line in lines)
    for before, after in zip(lines[2:], lines[3:]):       # progressive
        assert after.items() >= before.items()

    b, b7, b9 = 2, 2, 2        # whole GOPs of the 8, 32 and 16 frames used
    assert (last["frames"], last["seconds"], last["runs_s"]) == \
        (2 * b * G, 1, [1, 1, 1])
    want = {"production_fps_640x360": 2 * b * G / 2,
            "encode_decode_fps_1280x720": 1 * b7 * G / 2,
            "encode_decode_fps_1280x720_lumasearch": 1 * b7 * G / 2,
            "chroma420_fps_640x352": 3 * b * G / 1,
            "production_fps_1920x1080": 1 * b9 * G / 2,
            "production_fps_1920x1080_lumasearch": 1 * b9 * G / 2}
    assert last["value"] == 2 * b * G / 1
    assert {k: last[k] for k in KEYS[1:]} == want
    for line in lines[1:]:
        assert line["vs_baseline"] == round(line["value"] / BASE_FPS, 1)
        assert (line["baseline_fps"], line["baseline_psnr_capped99_db"]) \
            == bench.load_baseline()
    assert math.isfinite(last["psnr_capped99_db"])
    assert 30 < last["psnr_capped99_db"] < 99


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run(np.zeros((4, 3, 16, 16), np.uint8), source="zeros")


def test_unreadable_video_prints_the_error_line(tmp_path, capsys):
    missing = str(tmp_path / "none.mp4")
    assert bench.main(["--video", missing, "--device", "cpu"]) == 1
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert (line["value"], line["error"], line["source"]) == \
        (0, "video unavailable", missing)
