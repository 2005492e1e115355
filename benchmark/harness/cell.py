"""One run of one cell: set-up, the measured window, the comparison with the
reference, and the result line.

The served path, one client in a closed loop: each segment is a run of
consecutive BGR uint8 frames already in host memory, and goes through the
program's public entry points back to back:
  1. Encoder.encode_frames, ended by torch.cuda.synchronize();
  2. save_vcs into a file under the run's temporary directory;
  3. load_vcs of that file;
  4. Decoder.decode, which gives the frames back in host memory.
Set-up first builds (only the first run in a checkout does) or loads the
program's native libraries, and the result reports that apart under
`libraries`. The encoder and decoder are built once in set-up, and one
segment warms every shape the window uses. The window runs from the first segment's
encode to the end of the last segment's decode, and ends with the first
segment that finishes after `seconds`.

A traced run first profiles a short sub-window of whole segments (each
step under a record_function span), then measures the window as an
untraced run does, and reports the cell's per-layer metrics.
"""

from __future__ import annotations

import contextlib
import gc
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from benchmark.harness import check, frames, manifest, records, trace
from benchmark.harness import traffic

STEPS = ("encode", "save_vcs", "load_vcs", "decode")
BANNED = ("jax", "jaxlib", "flax", "vcs_h264_tpu")


def banned_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's, Flax's
    or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


class Server:
    """The program's entry points, built once."""

    def __init__(self, config: dict, device):
        from vcs_h264_tpu_torch.config import CodecConfig
        from vcs_h264_tpu_torch.io.bitstream import load_vcs, save_vcs
        from vcs_h264_tpu_torch.models.decoder import Decoder
        from vcs_h264_tpu_torch.models.encoder import Encoder
        codec = dict(config["codec"], gop_pattern=tuple(
            config["codec"]["gop_pattern"]))
        self.cfg = CodecConfig(**codec)
        self.device = torch.device(device)
        self.enc = Encoder(self.cfg, config["gop_batch"], device=self.device)
        self.dec = Decoder(config["gop_batch"], device=self.device)
        self.save_vcs, self.load_vcs = save_vcs, load_vcs

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def serve(self, segment: list, path: str, annotate: bool = False):
        """One segment through steps 1-4 -> (decoded frames, the five step
        boundaries on the host clock)."""
        span = (torch.profiler.record_function if annotate
                else lambda _: contextlib.nullcontext())
        t = [time.perf_counter()]
        with span("benchmark.encode"):
            video = self.enc.encode_frames(segment)
            self._sync()
        t.append(time.perf_counter())
        with span("benchmark.save_vcs"):
            self.save_vcs(video, path, device=self.device)
        t.append(time.perf_counter())
        with span("benchmark.load_vcs"):
            loaded = self.load_vcs(path, device=self.device)
        t.append(time.perf_counter())
        with span("benchmark.decode"):
            out = self.dec.decode(loaded)
        t.append(time.perf_counter())
        return out, t


class Reservoir:
    """A uniform sample of k segments of the window, drawn from the seed as
    they come (reservoir sampling), so that only those keep their file and
    decoded frames."""

    def __init__(self, k: int, seed: int, workdir: str):
        self.rng = np.random.default_rng([seed, traffic.SAMPLE])
        self.k, self.workdir = k, workdir
        self.items = []

    def place(self, i: int):
        """-> (the file segment i writes, its slot in the sample or None)."""
        slot = i if i < self.k else int(self.rng.integers(0, i + 1))
        if slot >= self.k:
            return f"{self.workdir}/scratch{i % 2}.vcs", None
        return f"{self.workdir}/keep{slot}.vcs", slot

    def keep(self, slot, item) -> None:
        if slot is None:
            return
        if slot == len(self.items):
            self.items.append(item)
        else:
            self.items[slot] = item

    def sample(self) -> list:
        return sorted(self.items, key=lambda it: it[0])


def load_libraries(device) -> dict:
    """Build, where this checkout has not yet, and load the program's native
    libraries first in set-up: the .vcs range coder and, on a card, the
    CUDA kernels. -> {"built": whether this run built one, "seconds": the
    time it took, a part of setup_s}."""
    from vcs_h264_tpu_torch.io import bitstream
    from vcs_h264_tpu_torch.ops import _build
    on_card = device.type == "cuda"
    paths = [bitstream.native_library_path()]
    if on_card:
        paths.append(_build.library_path())
    built = not all(p.exists() for p in paths)
    t = time.perf_counter()
    bitstream.load_native()
    if on_card:
        _build.load_library()
    return dict(built=built, seconds=time.perf_counter() - t)


def _segment(pool, off: int, seg: int) -> list:
    return list(pool[off:off + seg])


def measure(server, pool, seg, offsets, seconds, reservoir) -> dict:
    """The window: segments back to back until one ends past `seconds`."""
    h, w = pool.shape[1:3]
    out = dict(latency=[], frames=[], spans={s: [] for s in STEPS},
               attempted=0, failed=0, error=None, start=None, end=None)
    i = 0
    while out["start"] is None or out["end"] - out["start"] < seconds:
        off = next(offsets)
        path, slot = reservoir.place(i)
        out["attempted"] += 1
        try:
            decoded, t = server.serve(_segment(pool, off, seg), path)
        except Exception:                # the run reports it and ends
            out["failed"] += 1
            out["error"] = traceback.format_exc()
            break
        if out["start"] is None:
            out["start"] = t[0]
        out["end"] = t[-1]
        if len(decoded) != seg or any(
                f.shape != (h, w, 3) or f.dtype != np.uint8 for f in decoded):
            out["failed"] += 1
        out["latency"].append(t[-1] - t[0])
        out["frames"].append(len(decoded))
        for k, step in enumerate(STEPS):
            out["spans"][step].append(t[k + 1] - t[k])
        reservoir.keep(slot, (i, off, path, decoded))
        i += 1
    return out


def _device_info(device) -> dict:
    if device.type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                    count=1,
                    memory_peak_bytes=torch.cuda.max_memory_allocated(device))
    return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)


def run(root, name: str, seed: int, seconds: float, traced: bool, device,
        t0: float, log=sys.stderr) -> dict:
    """One run of cell `name` -> its result. `t0`: the process's start on
    the perf_counter clock."""
    cell = manifest.Cell(root, name)
    config, mix = cell.config, cell.mix
    traffic.check_mix(mix)
    seed = seed % (1 << 64)
    device = torch.device(device)
    libraries = load_libraries(device)
    server = Server(config, device)
    gop_len = server.cfg.gop_len
    seg = traffic.segment_frames(mix, gop_len, config["gop_batch"])
    pool = frames.frame_pool(seed, traffic.POOL_FRAMES, config["height"],
                             config["width"], device)
    workdir = tempfile.mkdtemp(prefix="vcs-bench-")
    try:
        warm = traffic.offsets(seed, traffic.WARMUP, len(pool), seg)
        server.serve(_segment(pool, next(warm), seg), f"{workdir}/warm.vcs")
        tr, profiled = None, []
        if traced and device.type == "cuda":
            offs = traffic.offsets(seed, traffic.PROFILE, len(pool), seg)

            def run_segments():
                profiled.clear()
                start = time.perf_counter()
                while (not profiled or time.perf_counter() - start
                       < traffic.TRACE_MIN_SECONDS):
                    off = next(offs)
                    server.serve(_segment(pool, off, seg),
                                 f"{workdir}/profiled.vcs", annotate=True)
                    profiled.append(off)

            tr = trace.profile(run_segments, workdir)
        reservoir = Reservoir(mix["check_segments"], seed, workdir)
        win = measure(server, pool, seg,
                      traffic.offsets(seed, traffic.WINDOW, len(pool), seg),
                      seconds, reservoir)
        dev = _device_info(device)
        del server
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        print(f"segments: {len(win['latency'])} completed of "
              f"{win['attempted']} attempted, {seg} frames each", file=log)
        if win["latency"]:
            lat = 1e3 * np.asarray(win["latency"])
            steps = ", ".join(f"{k} {1e3 * np.mean(v):.1f}"
                              for k, v in win["spans"].items())
            print(f"segment ms: min {lat.min():.1f}, median "
                  f"{np.median(lat):.1f}, max {lat.max():.1f}; mean ms by "
                  f"step: {steps}", file=log)
        if win["error"]:
            print(win["error"], file=log)
        t_check = time.perf_counter()
        checks, n_compared = check.judge(
            reservoir.sample(), pool, config, seed, seg,
            mix["check_gops_per_segment"], device)
        print(f"comparison with the reference: {n_compared} GOPs in "
              f"{time.perf_counter() - t_check:.1f} s", file=log)

        def search_log():
            found = []
            starts = [o + g * gop_len for o in profiled
                      for g in range(seg // gop_len)]
            check.reference_gops(pool, starts, gop_len, config, device,
                                 log=found)
            return found

        window_s = (win["end"] - win["start"]) if win["start"] else 0.0
        rec = records.Records(
            spans=win["spans"], frames=win["frames"], latency=win["latency"],
            window_s=window_s,
            setup_s=(win["start"] - t0) if win["start"] else None,
            trace=tr, config=config,
            profiled_gops=len(profiled) * (seg // gop_len),
            search_log=search_log)
        metrics = {}
        for m in (cell.per_layer if traced else cell.end_to_end):
            value = cell.reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if tr is not None:
            dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result = dict(correct=(win["failed"] == 0
                               and check.passed(checks, n_compared)),
                      attempted=win["attempted"], failed=win["failed"],
                      metrics=metrics, device=dev)
        if tr is not None:
            result["breakdown"] = tr.breakdown()
        result["libraries"] = libraries
        how = "built" if libraries["built"] else "loaded"
        print(f"native libraries: {how} in {libraries['seconds']:.2f} s of "
              "setup_s", file=log)
        result["gops_compared"] = n_compared
        for k, v in checks.items():
            print(f"{k} {v['value']} (limit {v['limit']})", file=log)
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
