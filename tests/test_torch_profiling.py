"""The tracing and profiling hooks of vcs_h264_tpu_torch
(`utils/profiling.py`) against the JAX package's on the CPU, and the
encoder's hooks: `trace_annotation` names a range in the profiler's
timeline, `device_trace` writes a trace file, `StageTimer` keeps the JAX
timer's box protocol and summary keys and waits for the device only for a
result that holds CUDA tensors, and `Encoder(metrics=..., profile=True)`
logs the JAX encoder's events, fields and stage names."""

import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from vcs_h264_tpu.config import CodecConfig as JaxConfig  # noqa: E402
from vcs_h264_tpu.models.encoder import Encoder as JaxEncoder  # noqa: E402
from vcs_h264_tpu.utils import metrics as jmetrics  # noqa: E402
from vcs_h264_tpu.utils import profiling as jprofiling  # noqa: E402

from vcs_h264_tpu_torch import CodecConfig  # noqa: E402
from vcs_h264_tpu_torch.models import Encoder, EncodedGOP  # noqa: E402
from vcs_h264_tpu_torch.utils import metrics, profiling  # noqa: E402


def test_trace_annotation_names_a_range():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.trace_annotation("encode_gop_batch"):
            torch.ones(4) + 1
    assert "encode_gop_batch" in {e.key for e in prof.key_averages()}


def test_device_trace_writes_a_trace_file(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.device_trace(str(logdir)):
        with profiling.trace_annotation("decode"):
            torch.arange(64).sum()
    files = list(logdir.iterdir())
    assert len(files) == 1 and files[0].name.endswith(".pt.trace.json")
    trace = json.loads(files[0].read_text())
    assert any(e.get("name") == "decode" for e in trace["traceEvents"])


def _drive(timer):
    for name, result in (("a", None), ("b", torch.ones(2)), ("a", None)):
        with timer.stage(name) as box:
            if result is not None:
                box["result"] = result
    with timer.stage("c", result=torch.zeros(1)):
        pass


def test_stage_timer_matches_jax():
    port, jax_timer = profiling.StageTimer(), jprofiling.StageTimer()
    _drive(port)
    _drive(jax_timer)
    assert port.counts == jax_timer.counts == {"a": 2, "b": 1, "c": 1}
    ps, js = port.summary(), jax_timer.summary()
    assert list(ps) == list(js)
    for k in ps:
        assert list(ps[k]) == list(js[k]) == ["total_s", "calls", "mean_ms"]
        assert ps[k]["calls"] == js[k]["calls"]
        assert ps[k]["mean_ms"] == pytest.approx(
            1e3 * ps[k]["total_s"] / ps[k]["calls"])


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on a CUDA device."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("make,waits", [
    (lambda t: t, False),
    (lambda t: None, False),
    (lambda t: 3, False),
    (lambda t: torch.Tensor._make_subclass(_OnCard, t), True),
    (lambda t: (t, [torch.Tensor._make_subclass(_OnCard, t)]), True),
    (lambda t: {"x": (t, t)}, False),
    (lambda t: EncodedGOP(t, torch.Tensor._make_subclass(_OnCard, t), None),
     True),
    (lambda t: EncodedGOP(t, t, None), False),
], ids=["cpu tensor", "none", "int", "cuda tensor", "nested cuda",
        "nested cpu", "gop with cuda", "gop on cpu"])
def test_stage_timer_waits_only_for_cuda_results(monkeypatch, make, waits):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(1))
    timer = profiling.StageTimer()
    with timer.stage("s") as box:
        box["result"] = make(torch.ones(2))
    assert calls == ([1] if waits else [])


def _frames(rng, n, h, w):
    base = rng.integers(0, 256, (h + 2 * n, w + 2 * n, 3))
    return [np.ascontiguousarray(base[t:t + h, t:t + w]).astype(np.uint8)
            for t in range(n)]


def _records(fh):
    return [json.loads(line) for line in fh.getvalue().splitlines()]


@pytest.mark.parametrize("kw,checkpoint", [
    (dict(intra_qstep=24), False),
    (dict(), True),
    (dict(chroma_420=True, intra_qstep=24), True),
    (dict(gop_pattern=("I", "B", "P")), False),
], ids=["lossy intra", "raw I, checkpoints", "4:2:0 checkpoints", "B"])
def test_encoder_hooks_match_jax(rng, tmp_path, kw, checkpoint):
    """Same events in the same order, the same fields in each, equal
    per-GOP statistics (the 4:2:0 luma coefficients may differ by +-1 on
    a bare plane, so its nonzero share within 1e-3), the same stage names
    timed."""
    frames = _frames(rng, 10, 16, 32)
    logs = []
    for name, enc_cls, cfg_cls, mod, extra in (
            ("port", Encoder, CodecConfig, metrics, dict(device="cpu")),
            ("jax", JaxEncoder, JaxConfig, jmetrics, {})):
        fh = io.StringIO()
        enc = enc_cls(cfg_cls.production(**kw), 2, mod.MetricsLogger(fh),
                      True, **extra)
        enc.encode_frames(frames, checkpoint_dir=(
            str(tmp_path / name) if checkpoint else None))
        logs.append(_records(fh))
    port, jax_recs = logs
    assert [r["event"] for r in port] == [r["event"] for r in jax_recs]
    gop_len = len(kw.get("gop_pattern", "IPPP"))
    assert [r["event"] for r in port].count("gop") == -(-10 // gop_len)
    for p, j in zip(port, jax_recs):
        assert list(p) == list(j)
        if p["event"] == "gop":
            assert p["gop"] == j["gop"]
            assert p["static_block_ratio"] == j["static_block_ratio"]
            if "nonzero_coeff_ratio" in p:
                assert abs(p["nonzero_coeff_ratio"]
                           - j["nonzero_coeff_ratio"]) <= (
                    1e-3 if kw.get("chroma_420") else 0)
        elif p["event"] == "encode_summary":
            assert (p["frames"], p["gops"]) == (j["frames"], j["gops"])
    stages = set(port[-1]) - {"ts", "event"}
    want = {"encode_gop_batch_420"} if kw.get("chroma_420") else (
        {"encode_gop_batch"} | ({"intra_i_encode"} if kw.get("intra_qstep")
                                else set()))
    if checkpoint and not kw.get("chroma_420"):
        want.add("checkpoint_write")
    assert port[-1]["event"] == "stage_timings" and stages == want


def test_encoder_without_hooks_logs_nothing(rng):
    enc = Encoder(CodecConfig.production(), 2, device="cpu")
    assert enc.metrics is None and enc.stage_timer is None
    enc.encode_frames(_frames(rng, 5, 16, 16))


@pytest.mark.parametrize("args", [
    ("cpu",), (None, "yes"), (None, 1)],
    ids=["metrics", "profile str", "profile int"])
def test_encoder_refuses_bad_hooks(args):
    with pytest.raises(TypeError):
        Encoder(CodecConfig.production(), 2, *args, device="cpu")


def test_psnr_t_feeds_a_metrics_record(rng):
    """A device PSNR logs as a plain float once read."""
    fh = io.StringIO()
    a = torch.from_numpy(_frames(rng, 1, 8, 8)[0])
    metrics.MetricsLogger(fh).log("frame", psnr=float(
        metrics.psnr_t(a, a.flip(0))))
    rec = _records(fh)[0]
    assert rec["psnr"] == pytest.approx(float(jmetrics.psnr_jnp(
        jnp.asarray(a.numpy()), jnp.asarray(a.flip(0).numpy()))), abs=1e-4)
    assert os.path.sep not in rec["event"]
