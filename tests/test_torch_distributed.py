"""The GOP axis across processes of vcs_h264_tpu_torch
(`parallel/distributed.py`) against the JAX package's on the CPU: the GOP
assignment, the frame spans and the merge of checkpoint directories are
the JAX functions' over a grid; without a coordinator `init_distributed`
is (0, 1) and the barrier a no-op; a two-process encode of the port's CLI
over gloo (`--procs 2 --device cpu`, the second rank started first) writes
the `.vcs` bytes of a one-process encode of either package; and
directories that JAX encoders wrote merge, and resume in the port with no
GOP encoded again, to the same bytes.

The JAX package's own two-process test runs jax.distributed; nothing here
does."""

import contextlib
import io
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
cv2 = pytest.importorskip("cv2")

from vcs_h264_tpu import cli as jcli  # noqa: E402
from vcs_h264_tpu.config import CodecConfig as JaxConfig  # noqa: E402
from vcs_h264_tpu.models.encoder import Encoder as JaxEncoder  # noqa: E402
from vcs_h264_tpu.parallel import distributed as jdist  # noqa: E402

from vcs_h264_tpu_torch import CodecConfig, cli, parallel  # noqa: E402
from vcs_h264_tpu_torch.io.bitstream import save_vcs  # noqa: E402
from vcs_h264_tpu_torch.models import Encoder, pipeline  # noqa: E402
from vcs_h264_tpu_torch.models import intra_codec  # noqa: E402
from vcs_h264_tpu_torch.parallel import distributed  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, H, W = 10, 32, 48
FLAGS = ["--production", "--intra-qstep", "24"]


@pytest.mark.parametrize("num_gops", [0, 1, 3, 7, 16])
@pytest.mark.parametrize("procs", [1, 2, 3, 5])
def test_assignment_and_spans_match_jax(num_gops, procs):
    spans = []
    for pid in range(procs):
        got = parallel.assign_gops(num_gops, procs, pid)
        assert got == jdist.assign_gops(num_gops, procs, pid)
        for gop_len, frames in ((4, num_gops * 4), (7, num_gops * 7 - 3)):
            frames = max(frames, 0)
            assert parallel.frame_range_for_gops(got, gop_len, frames) == \
                jdist.frame_range_for_gops(got, gop_len, frames)
        spans.extend(got)
    assert spans == list(range(num_gops))


def _fill(d, names):
    os.makedirs(d, exist_ok=True)
    for name in names:
        with open(os.path.join(d, name), "w") as fh:
            fh.write(f"{os.path.basename(d)}:{name}")


@pytest.mark.parametrize("layout", [
    [["gop_000000.npz", "gop_000001.npz"], ["gop_000002.npz"]],
    [["gop_000000.npz", "notes.txt"], ["gop_000000.npz", "gop_000003.npz"],
     []],
    [[], []]], ids=["two spans", "overlap and other files", "empty"])
def test_merge_checkpoint_dirs_matches_jax(tmp_path, layout):
    results = []
    for who, merge in (("port", parallel.merge_checkpoint_dirs),
                       ("jax", jdist.merge_checkpoint_dirs)):
        dirs = [str(tmp_path / who / f"rank{r}") for r in range(len(layout))]
        for d, names in zip(dirs, layout):
            _fill(d, names)
        out = str(tmp_path / who / "merged")
        n = merge(dirs, out)
        contents = {name: open(os.path.join(out, name)).read()
                    for name in sorted(os.listdir(out))}
        results.append((n, contents))
    assert results[0] == results[1]


def test_without_a_coordinator_the_world_is_one(monkeypatch):
    for var in ("VCS_COORDINATOR", "VCS_NUM_PROCS", "VCS_PROC_ID"):
        monkeypatch.delenv(var, raising=False)
    assert parallel.init_distributed() == (0, 1)
    assert parallel.init_distributed(None, 4, 2) == (0, 1)
    parallel.process_barrier("nothing to wait for", timeout_ms=1)
    assert not torch.distributed.is_initialized()
    assert distributed.rank_device("cpu", 3) == torch.device("cpu")


def _frames(seed=21, n=N, h=H, w=W):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 2 * n, w + 2 * n, 3))
    return [np.ascontiguousarray(base[t:t + h, t:t + w]).astype(np.uint8)
            for t in range(n)]


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dist") / "clip.avi")
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (W, H))
    assert out.isOpened()
    for f in _frames():
        out.write(f)
    out.release()
    return path


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _two_ranks(clip, out, ckpt):
    """The port's CLI in two processes, the second rank started first ->
    (return codes, outputs)."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}
    procs = []
    for rank in (1, 0):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "vcs_h264_tpu_torch.cli", "encode", clip,
             "-o", out, "--procs", "2", "--proc-id", str(rank),
             "--coordinator", f"localhost:{port}", "--device", "cpu",
             "--checkpoint-dir", ckpt, *FLAGS],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
        time.sleep(0.5)
    outputs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=120)
        finally:
            p.kill()
        outputs.append(stdout.decode(errors="replace"))
    return [p.returncode for p in procs], "\n".join(outputs)


def test_two_process_encode_matches_one_process(clip, tmp_path):
    out, ckpt = str(tmp_path / "dist.vcs"), str(tmp_path / "ckpt")
    rcs, joined = _two_ranks(clip, out, ckpt)
    if any(rcs) and "address already in use" in joined.lower():
        rcs, joined = _two_ranks(clip, out, ckpt)     # the port was taken
    assert rcs == [0, 0], joined
    assert "[proc 0/2] encoded GOPs 0..1" in joined
    assert "[proc 1/2] encoded GOPs 2..2" in joined
    assert f"[proc 0/2] wrote {out} (3 GOPs, 2 procs)" in joined
    assert sorted(os.listdir(ckpt)) == [f"gop_{g:06d}.npz" for g in range(3)]

    single, jax_single = str(tmp_path / "one.vcs"), str(tmp_path / "jax.vcs")
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["encode", clip, "-o", single, *FLAGS, "--device", "cpu"])
        jcli.main(["encode", clip, "-o", jax_single, *FLAGS,
                   "--platform", "cpu"])
    blobs = [open(p, "rb").read() for p in (out, single, jax_single)]
    assert blobs[0] == blobs[1] == blobs[2]


def _count_encodes(monkeypatch):
    calls = []
    for mod, name in ((pipeline, "encode_gop_batch"),
                      (pipeline, "encode_gop"),
                      (intra_codec, "encode_intra_frames_lossy_batch")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    return calls


@pytest.mark.parametrize("kw", [
    dict(quant_mode="rounded", intra_i=True, intra_qstep=24),
    dict(quant_mode="rounded", intra_i=True, gop_pattern=("I", "B", "P"))],
    ids=["production", "production B"])
def test_jax_directories_merge_and_resume_in_the_port(tmp_path, monkeypatch,
                                                      kw):
    frames = _frames()
    gop_len = CodecConfig(**kw).gop_len
    n_gops = -(-N // gop_len)
    dirs = []
    for rank in range(2):
        idxs = jdist.assign_gops(n_gops, 2, rank)
        lo, hi = jdist.frame_range_for_gops(idxs, gop_len, N)
        dirs.append(str(tmp_path / f"jax_rank{rank}"))
        JaxEncoder(JaxConfig(**kw), 2).encode_frames(
            frames[lo:hi], checkpoint_dir=dirs[-1], gop_index_offset=idxs[0])
    merged = str(tmp_path / "merged")
    assert parallel.merge_checkpoint_dirs(dirs, merged) == n_gops
    calls = _count_encodes(monkeypatch)
    resumed = Encoder(CodecConfig(**kw), 2, device="cpu").encode_frames(
        frames, checkpoint_dir=merged)
    assert calls == []
    monkeypatch.undo()
    want = Encoder(CodecConfig(**kw), 2, device="cpu").encode_frames(frames)
    paths = [str(tmp_path / f"{n}.vcs") for n in ("resumed", "encoded")]
    save_vcs(resumed, paths[0], device="cpu")
    save_vcs(want, paths[1], device="cpu")
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
