"""The trace reader on a made-up Chrome trace: the device's busy union and
idle share inside the sub-window, kernel time by name, idle time named by
the innermost host span, and the launch check, which fails the profile
loudly when the trace lacks counted launches."""

import json

import pytest

from benchmark.harness import trace


def _events(kernels=2):
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_SPAN,
           "ts": 1000.0, "dur": 1000.0},
          {"ph": "X", "cat": "user_annotation", "name": "benchmark.encode",
           "ts": 1000.0, "dur": 400.0},
          {"ph": "X", "cat": "user_annotation", "name": "encode_gop_batch",
           "ts": 1100.0, "dur": 200.0},
          {"ph": "X", "cat": "user_annotation", "name": "benchmark.save_vcs",
           "ts": 1400.0, "dur": 600.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
           "ts": 900.0, "dur": 150.0}]
    for k in range(kernels):
        ev.append({"ph": "X", "cat": "kernel",
                   "name": "void sad_search_words_kernel<8>(...)",
                   "ts": 1100.0 + 50 * k, "dur": 100.0})
    return ev


def test_busy_union_and_kernel_time():
    t = trace.Trace(_events())
    assert t.window_s == pytest.approx(1e-3)
    # memcpy clipped to [1000, 1050], kernels [1100, 1250]: 200 us busy
    assert t.busy_s == pytest.approx(200e-6)
    assert t.kernel_seconds(("sad_search_",)) == pytest.approx(200e-6)
    assert t.kernel_count("sad_search_") == 2
    b = t.breakdown()
    assert b["device_ops"][0][0].startswith("void sad_search_words")
    gaps = dict(b["idle_gaps"])
    # idle: [1050, 1100] in encode, [1250, 1300] in encode_gop_batch,
    # [1300, 1400] in encode and [1400, 2000] in save_vcs
    assert gaps == pytest.approx({"benchmark.encode": 150e-6,
                                  "encode_gop_batch": 50e-6,
                                  "benchmark.save_vcs": 600e-6})


def test_missing_launches_are_named():
    t = trace.Trace(_events(kernels=1))
    before = {n: 0 for names in trace.KERNEL_COUNTERS.values()
              for n in names}
    after = dict(before, **{"motion_cuda.sad_search": 2})
    assert trace.missing_launches(t, before, before) == [
        "sad_search_: counted 0, traced 1"]
    assert trace.missing_launches(t, before, after) == [
        "sad_search_: counted 2, traced 1"]


def test_a_trace_short_of_counted_launches_fails(monkeypatch, tmp_path):
    calls = {"n": 0}

    class FakeProfile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def export_chrome_trace(self, path):
            with open(path, "w") as fh:
                json.dump({"traceEvents": _events(kernels=1)}, fh)

    def counters():
        calls["n"] += 1
        return {n: (2 * calls["n"] if n == "motion_cuda.sad_search" else 0)
                for names in trace.KERNEL_COUNTERS.values() for n in names}

    monkeypatch.setattr(trace.torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(trace.torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(trace, "counters", counters)
    with pytest.raises(RuntimeError, match="lacks counted kernel launches"):
        trace.profile(lambda: None, str(tmp_path))
    assert calls["n"] == 2 * trace.ATTEMPTS
