"""The program's spans and counters (`utils/profiling.py`) inside the
`.vcs` container and the decoder, on a tiny 4:4:4 IPPP lossy-intra stream
(the codec of the benchmark's 720p cell) and a tiny 4:2:0 IBPBPBP stream
(the 1080p cell's): nothing is recorded and no profiler range entered
without a profiler; under one every span is recorded inside its root, on
the calling thread and the container's pool alike, with the counts the
stream defines; the bytes and frames are the same either way; the
benchmark's eight readers of the recording give per-frame values, and None
without a `save_vcs` root, and the two readers of the copies None unless
the trace holds as many copies."""

import collections
import concurrent.futures
import importlib.util
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu_torch import CodecConfig  # noqa: E402
from vcs_h264_tpu_torch.io.bitstream import load_vcs, save_vcs  # noqa: E402
from vcs_h264_tpu_torch.models import Decoder, Encoder  # noqa: E402
from vcs_h264_tpu_torch.utils import profiling  # noqa: E402
from vcs_h264_tpu_torch.utils.profiling import Span  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = [torch.profiler.ProfilerActivity.CPU]
ROOTS = ("save_vcs", "load_vcs")
# span -> its root; decode.wait has none
TABLE = {"save_vcs.pull": "save_vcs", "vcs.rc_encode": "save_vcs",
         "vcs.zigzag": None, "vcs.rc_decode": "load_vcs",
         "load_vcs.intra": "load_vcs", "decode.wait": None}
STREAMS = {
    "444_ippp": (dict(intra_qstep=24), 4),
    "420_ibpbpbp": (dict(chroma_420=True, intra_qstep=24,
                         gop_pattern=tuple("IBPBPBP")), 7),
}


@pytest.fixture(autouse=True)
def _empty_recording():
    profiling.clear()
    yield
    profiling.clear()


def _frames(n, h=16, w=32, seed=5):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 2 * n, w + 2 * n, 3))
    return [np.ascontiguousarray(base[t:t + h, t:t + w]).astype(np.uint8)
            for t in range(n)]


def _round_trip(stream, tmp_path, n_gops=2, tag="a"):
    """Encode -> save_vcs -> load_vcs -> Decoder.decode on the CPU ->
    (the encoded video, the file's bytes, the decoded frames)."""
    kw, gop_len = STREAMS[stream]
    cfg = CodecConfig.production(**kw)
    video = Encoder(cfg, 8, device="cpu").encode_frames(
        _frames(n_gops * gop_len))
    path = str(tmp_path / f"{tag}.vcs")
    save_vcs(video, path, device="cpu")
    decoded = Decoder(8, device="cpu").decode(load_vcs(path, device="cpu"))
    with open(path, "rb") as fh:
        return video, fh.read(), decoded


def _raise(*args, **kwargs):
    raise AssertionError("record_function entered with no profiler")


@pytest.mark.parametrize("stream", STREAMS)
def test_off_means_off(stream, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    _round_trip(stream, tmp_path)
    assert not profiling.recording()
    assert profiling.recorded() == []


class _Serial:
    """A stand-in for the container's thread pool that runs every task on
    the calling thread."""

    def __init__(self, max_workers=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def map(self, fn, items):
        return [fn(x) for x in items]


@pytest.mark.parametrize("stream", STREAMS)
def test_every_span_under_the_profiler(stream, tmp_path, monkeypatch):
    """Two GOPs: the coder runs on the container's thread pool, and records
    the spans it records on the calling thread, each once."""
    with torch.profiler.profile(activities=CPU):
        video, _, decoded = _round_trip(stream, tmp_path)
    spans = profiling.recorded()
    names = collections.Counter(s.name for s in spans)
    assert set(TABLE) | set(ROOTS) <= set(names)
    assert [names[r] for r in ROOTS] == [1, 1]
    profiling.clear()
    monkeypatch.setattr(concurrent.futures, "ThreadPoolExecutor", _Serial)
    with torch.profiler.profile(activities=CPU):
        _round_trip(stream, tmp_path, tag="serial")
    assert collections.Counter(s.name for s in profiling.recorded()) == names
    roots = {s.name: s for s in spans if s.name in ROOTS}
    for s in spans:
        assert s.ns >= 0
        if TABLE.get(s.name):
            assert s.ns <= roots[TABLE[s.name]].ns
    assert roots["save_vcs"].counts == {"frames": video.num_frames}
    assert roots["load_vcs"].counts == {}
    (pull,) = [s for s in spans if s.name == "save_vcs.pull"]
    fields = [v for g in video.gops for v in g._fields()
              if v is not None and v.numel()]
    assert pull.counts == {"d2h_copies": len(fields),
                           "d2h_bytes": sum(v.nbytes for v in fields)}
    (intra,) = [s for s in spans if s.name == "load_vcs.intra"]
    assert intra.counts["d2h_copies"] == (2 if "420" in stream else 1)
    waits = [s for s in spans if s.name == "decode.wait"]
    assert sum(s.counts["d2h_copies"] for s in waits) == len(waits)
    assert sum(s.counts["d2h_bytes"] for s in waits) == sum(
        f.nbytes for f in decoded)


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("n_gops", [1, 2], ids=["one gop", "pool"])
def test_every_span_name_reaches_the_profiler(stream, n_gops, tmp_path):
    """One GOP, as a live segment: every span runs on the calling thread,
    every name reaches the profiler's timeline, and each range lies in its
    root's. Two GOPs: the spans of the calling thread do; the pool's
    threads, which the profiler does not record, keep theirs in the
    recording alone."""
    with torch.profiler.profile(activities=CPU) as prof:
        _round_trip(stream, tmp_path, n_gops)
    keys = {e.key for e in prof.key_averages()}
    assert {"save_vcs.pull", "load_vcs.intra", "decode.wait",
            *ROOTS} <= keys
    if n_gops == 1:
        assert set(TABLE) | set(ROOTS) <= keys
        for e in prof.events():
            if TABLE.get(e.name):
                up = e.cpu_parent
                while up is not None and up.name not in ROOTS:
                    up = up.cpu_parent
                assert up is not None and up.name == TABLE[e.name]


@pytest.mark.parametrize("stream", STREAMS)
def test_output_unchanged_by_recording(stream, tmp_path):
    _, off_bytes, off_frames = _round_trip(stream, tmp_path, tag="off")
    with torch.profiler.profile(activities=CPU):
        _, on_bytes, on_frames = _round_trip(stream, tmp_path, tag="on")
    assert profiling.recorded()
    assert on_bytes == off_bytes
    assert len(on_frames) == len(off_frames)
    for a, b in zip(on_frames, off_frames):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("profiler", ["profile", "autograd legacy"])
def test_recording_follows_the_profiler(profiler):
    """Both the profiler of `torch.profiler` and the autograd profiler's
    API (through which `emit_nvtx` records) turn recording on."""
    make = {"profile": lambda: torch.profiler.profile(activities=CPU),
            "autograd legacy": lambda: torch.autograd.profiler.profile(
                use_kineto=False)}[profiler]
    assert not profiling.recording()
    with profiling.trace_annotation("before"):
        pass
    with make():
        assert profiling.recording()
        with profiling.trace_annotation("during", frames=3) as entered:
            profiling.add_counts(frames=1, d2h_bytes=8)
    assert entered is None
    assert not profiling.recording()
    (span,) = profiling.recorded()
    assert span.name == "during" and span.ns >= 0
    assert span.counts == {"frames": 4, "d2h_bytes": 8}


def test_carried_tasks_name_their_submitter_under_load():
    """More threads than cores, a short switch interval: the submitter's
    recording passes to every task, whose spans are each recorded once
    with their own counts."""
    n_threads, per_thread = 16, 100
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with torch.profiler.profile(activities=CPU):
            with profiling.trace_annotation("submit"):
                def task(k):
                    for _ in range(per_thread):
                        with profiling.trace_annotation("task", k=k):
                            profiling.add_counts(n=1)
                workers = [threading.Thread(target=profiling.carry(task),
                                            args=(k,))
                           for k in range(n_threads)]
                for w in workers:
                    w.start()
                for w in workers:
                    w.join(timeout=60)
                assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    spans = profiling.recorded()
    (submit,) = [s for s in spans if s.name == "submit"]
    tasks = [s for s in spans if s.name == "task"]
    assert len(tasks) == n_threads * per_thread
    assert submit.counts == {}
    assert all(s.counts["n"] == 1 for s in tasks)
    assert sorted(s.counts["k"] for s in tasks) == sorted(
        k for k in range(n_threads) for _ in range(per_thread))
    assert profiling.carry(task) is task


def test_profiled_encoder_stages_reach_the_timeline():
    """`Encoder(profile=True)` times its stages and names them in the
    profiler's timeline."""
    enc = Encoder(CodecConfig.production(intra_qstep=24), 2, None, True,
                  device="cpu")
    with torch.profiler.profile(activities=CPU) as prof:
        enc.encode_frames(_frames(8))
    stages = {"intra_i_encode", "encode_gop_batch"}
    assert stages <= {e.key for e in prof.key_averages()}
    assert stages == {s.name for s in profiling.recorded()}
    assert set(enc.stage_timer.summary()) == stages


# ---------------------------------------------------------------------------
# the benchmark's readers of the recording

def _reader(name):
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location(
        f"metric_{name}", REPO / "benchmark" / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _span(name, ms, **counts):
    return Span(name, int(ms * 1e6), counts)


def _planted():
    """Two profiled segments of 4 and 3 frames, 12 copies to host memory
    each."""
    return [
        _span("save_vcs", 40, frames=4), _span("save_vcs", 30, frames=3),
        _span("load_vcs", 20),
        _span("save_vcs.pull", 2.0, d2h_copies=10, d2h_bytes=3_000_000),
        _span("save_vcs.pull", 1.5, d2h_copies=12, d2h_bytes=4_000_000),
        _span("vcs.rc_encode", 10), _span("vcs.rc_encode", 11),
        _span("vcs.rc_decode", 7), _span("vcs.zigzag", 0.7),
        _span("vcs.zigzag", 0.7),
        _span("load_vcs.intra", 3.5, d2h_copies=1, d2h_bytes=500_000),
        _span("decode.wait", 1.4, d2h_copies=1, d2h_bytes=2_500_000),
        _span("encode_gop_batch", 5.0),
    ]


def _traced(copies, segments=1):
    """A sub-window's trace with `segments` segments and `copies` copies
    from the device to host memory, beside copies and work that are
    not."""
    device = [(0.1 * k, 0.1 * k + 0.01,
               f"Memcpy DtoH (Device -> {'Pinned' if k % 3 else 'Pageable'})",
               "gpu_memcpy") for k in range(copies)]
    device += [(5.0, 5.1, "Memcpy HtoD (Pinned -> Device)", "gpu_memcpy"),
               (5.2, 5.3, "Memcpy DtoD (Device -> Device)", "gpu_memcpy"),
               (5.4, 5.5, "intra_decode_kernel", "kernel")]
    spans = [(float(k), k + 0.5, "benchmark.save_vcs")
             for k in range(segments)]
    spans += [(0.0, 0.2, "benchmark.load_vcs")]
    return SimpleNamespace(trace=SimpleNamespace(device=device, spans=spans))


READERS = {
    "save_vcs_pull_ms_per_frame": 3.5 / 7,
    "vcs_rc_encode_ms_per_frame": 21 / 7,
    "vcs_rc_decode_ms_per_frame": 7 / 7,
    "vcs_zigzag_ms_per_frame": 1.4 / 7,
    "load_vcs_intra_ms_per_frame": 3.5 / 7,
    "decoder_wait_ms_per_frame": 1.4 / 7,
    "d2h_copies_per_frame": 24 / 7,
    "d2h_mb_per_frame": 10.0 / 7,
}


@pytest.mark.parametrize("name", READERS)
def test_reader_of_the_recording(name, monkeypatch):
    read = _reader(name)
    rec = _traced(12)
    monkeypatch.setattr(profiling, "recorded", _planted)
    assert read(rec) == pytest.approx(READERS[name])
    monkeypatch.setattr(profiling, "recorded", lambda: [
        s for s in _planted() if s.name != "save_vcs"])
    assert read(rec) is None
    monkeypatch.setattr(profiling, "recorded", list)
    assert read(rec) is None


@pytest.mark.parametrize("name", ["d2h_copies_per_frame", "d2h_mb_per_frame"])
def test_copy_readers_hold_the_count_against_the_trace(name, monkeypatch):
    """The trace holds the last attempt of the sub-window and the recording
    every attempt: the two agree a segment, or the reader finds nothing."""
    read = _reader(name)
    monkeypatch.setattr(profiling, "recorded", _planted)
    assert read(_traced(24, segments=2)) == pytest.approx(READERS[name])
    assert read(_traced(12 * 3, segments=3)) == pytest.approx(READERS[name])
    for rec in (_traced(11), _traced(13), _traced(12, segments=2),
                _traced(0), SimpleNamespace(trace=None), None):
        assert read(rec) is None
