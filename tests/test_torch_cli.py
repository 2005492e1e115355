"""The command-line driver of vcs_h264_tpu_torch (`cli.py`, `--device cpu`)
against the JAX package's (`vcs_h264_tpu.cli`, `--platform cpu`), both run
in this process on an MJPG clip and a PNG that cv2 writes.

`encode` writes the JAX CLI's `.vcs` bytes (production with lossy intra,
4:2:0, production B) or its `.npz` fields (reference mode); each package's
`decode` reads the other's file to frames within the parity contract of
ROADMAP.md; `roundtrip` prints the same mean PSNR and logs the JAX
records' keys; the studies print the same statistics and write the same
images (the DCT study within ±1 on fewer than 1e-3 of values); `--plot`
writes a PNG; `--device cuda` without a card raises; `.npz` is appended
as `np.savez` appends it; the parser takes every JAX flag with its
default, `--platform` becoming `--device`."""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
cv2 = pytest.importorskip("cv2")

from vcs_h264_tpu import cli as jcli  # noqa: E402
from vcs_h264_tpu.io import video as jvideo  # noqa: E402
from vcs_h264_tpu.models.gop import EncodedVideo as JaxVideo  # noqa: E402

from vcs_h264_tpu_torch import CodecConfig, cli  # noqa: E402
from vcs_h264_tpu_torch.io import video  # noqa: E402
from vcs_h264_tpu_torch.io.bitstream import load_vcs, save_vcs  # noqa: E402
from vcs_h264_tpu_torch.models import Encoder  # noqa: E402
from vcs_h264_tpu_torch.models.gop import EncodedVideo  # noqa: E402
from vcs_h264_tpu_torch.utils.metrics import psnr  # noqa: E402

N, H, W = 10, 64, 96
CASES = {
    "production": (["--production", "--intra-qstep", "24"], "vcs"),
    "4:2:0": (["--chroma-420"], "vcs"),
    "production B": (["--gop", "IBPBPBP", "--production"], "vcs"),
    "reference": ([], "npz"),
}
# Decoded frames of one stream, the two packages against each other: the
# largest difference and the share of values that may differ (ROADMAP.md,
# *Parity contract*: ±1 at .5 ties at full resolution; a bare plane's ±1
# is up to ±2 after the colour conversion, on fewer than 1e-3 of values).
FRAME_BOUND = {"production": (1, 1e-4), "production B": (1, 1e-4),
               "reference": (1, 1e-4), "4:2:0": (2, 1e-3)}


def _frames(seed=11, n=N, h=H, w=W):
    """A smooth random texture panned a few pixels a frame, with noise."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 255, (h // 8 + 4, w // 8 + 4, 3)).astype(np.float32)
    tex = cv2.resize(coarse, (w + 8 * 4, h + 8 * 4),
                     interpolation=cv2.INTER_CUBIC)
    frames = []
    for t in range(n):
        f = tex[t:t + h, 2 * t:2 * t + w] + rng.integers(-2, 3, (h, w, 3))
        frames.append(np.clip(np.rint(f), 0, 255).astype(np.uint8))
    return frames


def _run(main, argv):
    """Run a CLI's main in this process -> its standard output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _jax(argv):
    return _run(jcli.main, [*argv, "--platform", "cpu"])


def _port(argv):
    return _run(cli.main, [*argv, "--device", "cpu"])


class Recorder:
    """Stands in for VideoWriter: keeps the frames written to each path."""
    frames = {}

    def __init__(self, path, width, height, fps=25.0, fourcc="auto"):
        self.path = path
        Recorder.frames[path] = []

    def write(self, frame):
        Recorder.frames[self.path].append(np.array(frame))

    def close(self):
        pass


@pytest.fixture
def recorder(monkeypatch):
    Recorder.frames = {}
    monkeypatch.setattr(jvideo, "VideoWriter", Recorder)
    monkeypatch.setattr(video, "VideoWriter", Recorder)
    return Recorder.frames


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The clip (MJPG, 12 fps) and the image (PNG, not a multiple of 16)."""
    d = tmp_path_factory.mktemp("cli")
    out = cv2.VideoWriter(str(d / "clip.avi"), cv2.VideoWriter_fourcc(*"MJPG"),
                          12.0, (W, H))
    assert out.isOpened()
    for f in _frames():
        out.write(f)
    out.release()
    assert cv2.imwrite(str(d / "image.png"), _frames(12, 1, 50, 70)[0])
    return d


@pytest.fixture(scope="module")
def encoded(root):
    """case -> (JAX file, port file, JAX output, port output), each CLI
    encoding the clip once per module."""
    done = {}

    def make(case):
        if case not in done:
            flags, ext = CASES[case]
            name = case.replace(" ", "_").replace(":", "")
            paths = [str(root / f"{who}_{name}.{ext}")
                     for who in ("jax", "port")]
            outs = (_jax(["encode", str(root / "clip.avi"), "-o", paths[0],
                          *flags]),
                    _port(["encode", str(root / "clip.avi"), "-o", paths[1],
                           *flags]))
            done[case] = (*paths, *outs)
        return done[case]
    return make


def _encode_line(out):
    m = re.search(r"encoded (\d+) frames in [\d.]+s \([\d.]+ fps\) -> (\S+) "
                  r"\((\d+) bytes, [\d.]+x vs raw\)", out)
    assert m, out
    return int(m.group(1)), m.group(2), int(m.group(3))


@pytest.mark.parametrize("case", list(CASES))
def test_encode_matches_jax(encoded, case):
    jpath, ppath, jout, pout = encoded(case)
    jn, jwritten, jsize = _encode_line(jout)
    pn, pwritten, psize = _encode_line(pout)
    assert (pn, pwritten, psize) == (jn, ppath, os.path.getsize(ppath))
    assert jn == N and jwritten == jpath
    if CASES[case][1] == "vcs":
        with open(jpath, "rb") as a, open(ppath, "rb") as b:
            jbytes, pbytes = a.read(), b.read()
        if case != "4:2:0":
            assert pbytes == jbytes
            return
        # bare planes: coefficients ±1 on fewer than 1e-3 of them (ROADMAP.md,
        # *Parity contract*), so the range coder's bytes may differ; the
        # streams are held to the contract, and the port's writer gives the
        # JAX CLI's bytes for the JAX CLI's stream
        got, want = (load_vcs(p, device="cpu") for p in (ppath, jpath))
        _same_stream(got, want, case)
        resaved = os.path.join(os.path.dirname(ppath), "resaved.vcs")
        save_vcs(want, resaved, device="cpu")
        with open(resaved, "rb") as fh:
            assert fh.read() == jbytes
        return
    _same_stream(EncodedVideo.load_npz(ppath), JaxVideo.load_npz(jpath), case)


def _same_stream(got, want, case):
    """Two streams field for field: integers identical, float32 within
    1e-3, bare-plane residuals ±1 on fewer than 1e-3 of them."""
    assert (got.height, got.width, got.num_frames, got.fps) == \
        (want.height, want.width, want.num_frames, want.fps) == (H, W, N, 12.0)
    assert len(got.gops) == len(want.gops)
    n_diff = n_all = 0
    for gp, gj in zip(got.gops, want.gops):
        for f in dataclasses.fields(gj):
            x, y = getattr(gp, f.name), getattr(gj, f.name)
            assert (x is None) == (y is None), f.name
            if y is None:
                continue
            x, y = x.cpu().numpy(), np.asarray(y)
            if y.dtype == np.float32:
                np.testing.assert_allclose(x, y, atol=1e-3, rtol=0)
            elif case == "4:2:0" and f.name in ("res_y", "res_c"):
                d = np.abs(x.astype(np.int32) - y)
                assert d.max() <= 1, f.name
                n_diff += int((d != 0).sum())
                n_all += d.size
            else:
                np.testing.assert_array_equal(x.astype(y.dtype), y,
                                              err_msg=f.name)
    print(f"{case}: residual values that differ {n_diff} of {n_all}")
    assert n_diff < 1e-3 * max(n_all, 1)


def test_encode_with_checkpoints_resumes(root, encoded, tmp_path,
                                         monkeypatch):
    """--checkpoint-dir: one file per GOP, the JAX CLI's bytes, and a second
    encode that loads every GOP and encodes none."""
    from vcs_h264_tpu_torch.models import pipeline
    jpath = encoded("production")[0]
    flags = [*CASES["production"][0], "--checkpoint-dir", str(tmp_path / "ck")]
    out = str(tmp_path / "ck.vcs")
    _port(["encode", str(root / "clip.avi"), "-o", out, *flags])
    assert sorted(os.listdir(tmp_path / "ck")) == [
        f"gop_{g:06d}.npz" for g in range(-(-N // 4))]
    calls = []
    monkeypatch.setattr(pipeline, "encode_gop_batch",
                        lambda *a, **k: calls.append(a))
    monkeypatch.setattr(pipeline, "encode_gop",
                        lambda *a, **k: calls.append(a))
    again = str(tmp_path / "again.vcs")
    _port(["encode", str(root / "clip.avi"), "-o", again, *flags])
    assert calls == []
    blobs = [open(p, "rb").read() for p in (jpath, out, again)]
    assert blobs[0] == blobs[1] == blobs[2]


def _within(got, want, case, what):
    """Two lists of decoded frames within the case's bound; prints the
    differing share."""
    assert len(got) == len(want) == N, what
    d = np.abs(np.stack(got).astype(np.int32) - np.stack(want))
    share = float(np.mean(d != 0))
    print(f"{case}, {what}: max |diff| {d.max()}, share that differs "
          f"{share:.2e}")
    worst, bound = FRAME_BOUND[case]
    assert d.max() <= worst and share < bound, what


def _across(got, want, case, root, what):
    """Decoded frames of the two packages' own streams: within the case's
    bound where the streams are identical; in 4:2:0, whose coefficients may
    differ by ±1 (a ±1 moves an 8x8 block of a plane), each frame's PSNR
    against the clip within 0.01 dB."""
    if case != "4:2:0":
        _within(got, want, case, what)
        return
    clip = jvideo.VideoReader(str(root / "clip.avi"),
                              block_multiple=16).read_all()
    for i, (a, b, f) in enumerate(zip(got, want, clip)):
        pa, pb = psnr(a, f), psnr(b, f)
        assert abs(pa - pb) <= 0.01, (what, i, pa, pb)
    print(f"{case}, {what}: every frame's PSNR within 0.01 dB")


@pytest.mark.parametrize("case", list(CASES))
def test_each_decodes_the_others_file(root, encoded, case, recorder,
                                      tmp_path):
    jpath, ppath, _, _ = encoded(case)
    outs = {}
    for who, run in (("jax", _jax), ("port", _port)):
        for src in (jpath, ppath):
            name = str(tmp_path / f"{who}_of_{os.path.basename(src)}.mp4")
            printed = run(["decode", src, "-o", name])
            assert re.search(rf"decoded {N} frames in [\d.]+s -> ", printed)
            outs[who, src] = recorder[name]
    for src in (jpath, ppath):
        _within(outs["port", src], outs["jax", src], case,
                f"port vs JAX decode of {os.path.basename(src)}")
    _across(outs["port", jpath], outs["jax", ppath], case, root,
            "port decode of the JAX file vs JAX decode of the port file")


def _mean_psnr(out):
    m = re.search(rf"{N} frames in [\d.]+s \([\d.]+ fps\), mean PSNR "
                  r"([\d.]+|inf) dB", out)
    assert m, out
    return float(m.group(1))


def _records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


@pytest.mark.parametrize("case", list(CASES))
def test_roundtrip_matches_jax(root, case, recorder, tmp_path):
    flags = CASES[case][0] + (["--profile"] if case == "production" else [])
    runs = {}
    for who, run in (("jax", _jax), ("port", _port)):
        metrics = str(tmp_path / f"{who}.jsonl")
        out = str(tmp_path / f"{who}.mp4")
        printed = run(["roundtrip", str(root / "clip.avi"), "-o", out,
                       "--metrics", metrics, *flags])
        assert f"wrote {out}" in printed
        runs[who] = (_mean_psnr(printed), _records(metrics), recorder[out],
                     printed)
    (jpsnr, jrec, jframes, jprinted), (ppsnr, prec, pframes, pprinted) = \
        runs["jax"], runs["port"]
    print(f"{case}: mean PSNR JAX {jpsnr} dB, port {ppsnr} dB")
    assert abs(ppsnr - jpsnr) <= 0.01
    assert [r["event"] for r in prec] == [r["event"] for r in jrec]
    assert [sorted(r) for r in prec] == [sorted(r) for r in jrec]
    assert ("stage timings" in pprinted) == ("stage timings" in jprinted) \
        == (case == "production")
    _across(pframes, jframes, case, root, "roundtrip frames")


def _png(path):
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert img is not None, path
    return img


@pytest.mark.parametrize("mode", ["4x4", "16x16"])
def test_intra_study_matches_jax(root, tmp_path, mode):
    outs, printed = {}, {}
    for who, run in (("jax", _jax), ("port", _port)):
        outs[who] = str(tmp_path / f"{who}.png")
        printed[who] = run(["intra", str(root / "image.png"), "-o",
                            outs[who], "--mode", mode])
    stats = [re.findall(r"sparsity \((\w+)\): ([\d.]+)", printed[w])
             for w in ("jax", "port")]
    assert stats[0] == stats[1] and [s[0] for s in stats[0]] == \
        ["Y", "Cb", "Cr"]
    img = _png(outs["port"])
    assert img.shape == (48, 64, 3)
    np.testing.assert_array_equal(img, _png(outs["jax"]))


def test_chroma_study_matches_jax(root, tmp_path):
    outs, psnrs = {}, {}
    for who, run in (("jax", _jax), ("port", _port)):
        outs[who] = str(tmp_path / f"{who}.png")
        printed = run(["chroma", str(root / "image.png"), "-o", outs[who]])
        psnrs[who] = float(re.search(r"4:2:0 roundtrip PSNR: ([\d.]+) dB",
                                     printed).group(1))
    got, want = _png(outs["port"]), _png(outs["jax"])
    assert got.shape == want.shape == (50, 70, 3)
    d = np.abs(got.astype(np.int32) - want)
    print(f"chroma study: max |diff| {d.max()}, share that differs "
          f"{np.mean(d != 0):.2e}")
    assert d.max() <= 1 and np.mean(d != 0) < 1e-4
    assert abs(psnrs["port"] - psnrs["jax"]) <= 0.01


def _dct_coefficients(img, qf):
    """The DCT study's quantised coefficients [3, nbh, nbw, 8, 8] of a BGR
    image by the JAX package's ops and by the port's, and the exact
    quotients (float64 DCT of the same YCrCb planes over the table)."""
    from vcs_h264_tpu.ops import blocks as jb, color as jc, dct as jd
    from vcs_h264_tpu.ops import quant as jq
    from vcs_h264_tpu_torch.ops import blocks as pb, color as pc, dct as pd
    from vcs_h264_tpu_torch.ops import quant as pq
    planes = img.transpose(2, 0, 1).astype(np.int32)
    ycc = np.asarray(jc.bgr_to_ycrcb_planes(planes)).astype(np.float32) - 128
    q = np.array(jq.quant_tables(qf))[:, None, None]
    jax_q = np.asarray(jq.quantize(jd.dct2_blocks(jb.plane_to_blocks(
        jnp.asarray(ycc), 8)), q, rounded=True))
    port_q = pq.quantize(pd.dct2_blocks(pb.plane_to_blocks(
        torch.from_numpy(ycc), 8)), torch.from_numpy(q), rounded=True)
    d = jd.dct_matrix_np(8)
    exact = d @ np.asarray(jb.plane_to_blocks(ycc, 8), np.float64) @ d.T / q
    return jax_q, port_q.numpy(), exact


@pytest.mark.parametrize("qf", [99.0, 50.0])
def test_dct_study_matches_jax(root, tmp_path, qf):
    """Quantised coefficients are identical but at exact .5 ties, which two
    float32 DCTs that sum in another order may round apart (the DC term of
    an integer block is sum / 8); each such coefficient moves its 8x8 block
    of the image. Elsewhere the images are identical, and each CLI prints
    the sparsity of its coefficients and the PSNR of its image."""
    outs, printed = {}, {}
    for who, run in (("jax", _jax), ("port", _port)):
        outs[who] = str(tmp_path / f"{who}.png")
        printed[who] = run(["dct", str(root / "image.png"), "-o", outs[who],
                            "--qf", str(qf)])
    got, want = _png(outs["port"]), _png(outs["jax"])
    assert got.shape == want.shape == (48, 64, 3)
    img = cv2.resize(_png(str(root / "image.png")), (64, 48))
    jax_q, port_q, exact = _dct_coefficients(img, qf)
    apart = jax_q != port_q
    tie = np.abs(np.abs(exact - np.floor(exact)) - 0.5) < 1e-3
    assert np.all(np.abs(jax_q - port_q) <= 1) and np.all(tie[apart])
    moved = apart.any(axis=(0, -2, -1))                    # [nbh, nbw]
    d = np.abs(got.astype(np.int32) - want)
    block_diff = d.reshape(6, 8, 8, 8, 3).max(axis=(1, 3, 4))
    print(f"dct study QF={qf}: coefficients rounded apart at .5 ties "
          f"{int(apart.sum())} of {apart.size}; image max |diff| {d.max()}, "
          f"share that differs {np.mean(d != 0):.2e}, in {int(moved.sum())} "
          f"of {moved.size} blocks")
    assert not block_diff[~moved].any()
    for who, out, coef in (("jax", want, jax_q), ("port", got, port_q)):
        assert f"roundtrip PSNR at QF={qf}: {psnr(out, img):.2f} dB" \
            in printed[who]
        assert f"sparsity: {1 - np.count_nonzero(coef) / coef.size:.6f}" \
            in printed[who]


def test_plot_writes_a_png(root, tmp_path):
    for argv in (["intra", "--plot"], ["dct", "--plot"],
                 ["chroma", "--plot"]):
        path = str(tmp_path / f"{argv[0]}_plot.png")
        printed = _port([argv[0], str(root / "image.png"), argv[1], path])
        assert f"wrote comparison plot -> {path}" in printed
        img = _png(path)
        assert img.ndim == 3 and img.shape[1] > img.shape[0] > 100


def test_cuda_without_a_card_raises(root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for machines "
                    "without one")
    for argv in (["intra", str(root / "image.png")],
                 ["encode", str(root / "clip.avi"), "-o",
                  str(tmp_path / "x.vcs")]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main([*argv, "--device", "cuda"])
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("name,written", [
    ("stream", "stream.npz"), ("stream.npz", "stream.npz"),
    ("stream.vcs", "stream.vcs"), ("a.b", "a.b.npz")])
def test_save_stream_by_extension(tmp_path, name, written):
    v = Encoder(CodecConfig.production(intra_qstep=24),
                device="cpu").encode_frames(_frames(n=5, h=16, w=32))
    jv = JaxVideo.load_npz(cli.save_stream(v, str(tmp_path / "v.npz"),
                                           "cpu"))
    dirs = [tmp_path / "port", tmp_path / "jax"]
    for d in dirs:
        d.mkdir()
    got = cli.save_stream(v, str(dirs[0] / name), "cpu")
    want = jcli._save_stream(jv, str(dirs[1] / name))
    assert os.path.basename(got) == os.path.basename(want) == written
    assert os.listdir(dirs[0]) == os.listdir(dirs[1]) == [written]
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read() or not written.endswith(".vcs")
    loaded = cli.load_stream(got, "cpu")
    assert loaded.num_frames == 5 and len(loaded.gops) == 2
    for a, b in zip(loaded.gops, v.gops):
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert (x is None) == (y is None), f.name
            assert x is None or torch.equal(x.cpu().to(y.dtype), y), f.name


def test_trace_dir_writes_a_trace(root, tmp_path):
    trace = str(tmp_path / "trace")
    printed = _port(["encode", str(root / "clip.avi"), "-o",
                     str(tmp_path / "x.vcs"), "--production", "--trace-dir",
                     trace, "--max-frames", "4"])
    assert f"capturing device trace -> {trace}" in printed
    files = os.listdir(trace)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")


@pytest.mark.parametrize("flags", [
    [], ["--production"], ["--production", "--intra-qstep", "24"],
    ["--intra-qstep", "12"], ["--intra-i"], ["--chroma-420"],
    ["--chroma-420", "--intra-qstep", "24", "--gop", "IBPBPBP"],
    ["--quant-mode", "rounded", "--qf", "75"], ["--no-dct", "--block-size",
                                                 "4"],
    ["--no-residual"], ["--search-luma-only", "--production"],
    ["--gop", "IPP", "--no-dct", "--block-size", "16"]],
    ids=lambda f: " ".join(f) or "defaults")
def test_cfg_matches_jax_field_for_field(flags):
    """The configuration each CLI builds from the same flags (--production
    and --chroma-420 force rounded quantisation, --intra-qstep implies
    --intra-i)."""
    argv = ["encode", "in.avi", "-o", "out.vcs", *flags]
    got = cli._cfg(cli.build_parser().parse_args(argv))
    want = jcli._cfg(_parser_of(jcli.main).parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _parser_of(main):
    """The top-level argparse parser a CLI's main builds."""
    class Got(Exception):
        pass

    def grab(self, *a, **k):
        raise Got(self)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        main([])
    except Got as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = orig
    raise AssertionError("main parsed no arguments")


def _options(parser):
    """command -> {flag or positional: (dest, default, choices, type,
    required, nargs, action class)}."""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    tree = {}
    for cmd, p in sub.choices.items():
        tree[cmd] = {
            (a.option_strings[-1] if a.option_strings else a.dest):
            (a.dest, a.default, a.choices, a.type, a.required, a.nargs,
             type(a).__name__)
            for a in p._actions if not isinstance(a, argparse._HelpAction)}
    return tree


def test_parser_takes_every_jax_flag_with_its_default():
    want, got = _options(_parser_of(jcli.main)), _options(cli.build_parser())
    assert _options(_parser_of(cli.main)) == got
    assert sorted(got) == sorted(want) == sorted(
        ["encode", "decode", "roundtrip", "intra", "dct", "chroma"])
    for cmd, opts in want.items():
        platform = opts.pop("--platform")
        assert platform[1] == "default"
        device = got[cmd].pop("--device")
        assert device[1:3] == ("cuda", ("cuda", "cpu"))
        assert got[cmd] == opts, cmd
