"""Per-GOP checkpoints of vcs_h264_tpu_torch (`models/encoder.py`)
against the JAX package's on the CPU: the configuration fingerprint is the
same string; the files of each GOP have the same keys, dtypes and values
(4:2:0 residuals within the bare-plane contract of ROADMAP.md: +-1 on
fewer than 1e-3 of coefficients; reference-mode float32 coefficients
within 1e-3); a directory written by either package resumes in the other
to an equal stream with nothing encoded again; a stale fingerprint is
encoded again; `gop_index_offset` names the files."""

import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu.config import CodecConfig as JaxConfig  # noqa: E402
from vcs_h264_tpu.models import encoder as jencoder  # noqa: E402
from vcs_h264_tpu.models import intra_codec as jintra  # noqa: E402
from vcs_h264_tpu.models import pipeline as jpipeline  # noqa: E402
from vcs_h264_tpu.models import pipeline420 as jp420  # noqa: E402

from vcs_h264_tpu_torch import CodecConfig  # noqa: E402
from vcs_h264_tpu_torch.models import encoder, intra_codec  # noqa: E402
from vcs_h264_tpu_torch.models import pipeline, pipeline420  # noqa: E402
from vcs_h264_tpu_torch.models.encoder import Encoder  # noqa: E402
from vcs_h264_tpu_torch.models.gop import (EncodedVideo,  # noqa: E402
                                            load_gop_npz)

IBP = ("I", "B", "P")
PROD = dict(quant_mode="rounded", intra_i=True)
CASES = {
    "lossy intra": dict(PROD, intra_qstep=24),
    "raw I": dict(PROD),
    "reference": dict(),
    "no dct": dict(with_dct=False, block_size=4, search_reach=8,
                   search_step=1),
    "B": dict(PROD, intra_qstep=24, gop_pattern=IBP),
    "reference B": dict(gop_pattern=IBP),
    "4:2:0": dict(PROD, intra_qstep=24, chroma_420=True),
    "4:2:0 B": dict(PROD, intra_qstep=24, chroma_420=True, gop_pattern=IBP),
}
RES_420 = ("resy", "resc", "bresy", "bresc")
N_FRAMES, H, W = 10, 16, 32


def _frames(seed=7, n=N_FRAMES):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (H + 2 * n, W + 2 * n, 3))
    return [np.ascontiguousarray(base[t:t + H, 2 * t // 3:2 * t // 3 + W])
            .astype(np.uint8) for t in range(n)]


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """case -> (JAX video, port video, JAX directory, port directory), each
    package encoding the same frames into a checkpoint directory of its
    own, once per module."""
    @functools.lru_cache(maxsize=None)
    def make(case):
        root = tmp_path_factory.mktemp(case.replace(" ", "_")
                                       .replace(":", ""))
        frames = _frames()
        jdir, pdir = str(root / "jax"), str(root / "port")
        jvid = jencoder.Encoder(JaxConfig(**CASES[case]), 2).encode_frames(
            frames, checkpoint_dir=jdir)
        pvid = Encoder(CodecConfig(**CASES[case]), 2,
                       device="cpu").encode_frames(frames,
                                                   checkpoint_dir=pdir)
        return jvid, pvid, jdir, pdir
    return make


def _files(d):
    return sorted(os.listdir(d))


def _arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("kw", [
    dict(), dict(PROD), dict(PROD, intra_qstep=24), dict(gop_pattern=IBP),
    dict(PROD, chroma_420=True, intra_qstep=12),
    dict(with_dct=False, block_size=4, search_reach=8, search_step=1),
    dict(PROD, search_luma_only=True), dict(quality_factor=75.0,
                                            static_threshold=500),
    dict(with_residual=False), dict(PROD, signed_residual=False),
    dict(gop_pattern=("I", "P")),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_fingerprint_is_the_jax_string(kw):
    assert encoder._cfg_fingerprint(CodecConfig(**kw)) == \
        jencoder._cfg_fingerprint(JaxConfig(**kw))


@pytest.mark.parametrize("case", list(CASES))
def test_checkpoint_files_match_jax(written, case):
    jvid, pvid, jdir, pdir = written(case)
    names = _files(jdir)
    assert names == _files(pdir) == [f"gop_{g:06d}.npz"
                                     for g in range(len(jvid.gops))]
    n_diff = n_all = 0
    for name in names:
        ja, pa = _arrays(os.path.join(jdir, name)), _arrays(
            os.path.join(pdir, name))
        assert list(pa) == list(ja) or sorted(pa) == sorted(ja)
        for k, want in ja.items():
            got = pa[k]
            assert got.dtype == want.dtype and got.shape == want.shape, k
            if k in RES_420:
                d = np.abs(got.astype(np.int32) - want)
                assert d.max() <= 1, (name, k)
                n_diff += int((d != 0).sum())
                n_all += d.size
            elif got.dtype == np.float32:
                np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"{name} {k}")
    assert n_diff <= 1e-3 * max(n_all, 1)


def _count(monkeypatch, targets):
    """Replace each (module, name) with a wrapper that counts its calls."""
    calls = []
    for mod, name in targets:
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    return calls


PORT_ENCODES = ((pipeline, "encode_gop_batch"), (pipeline, "encode_gop"),
                (pipeline420, "encode_gop_batch_420"),
                (pipeline420, "ingest_420"),
                (pipeline420, "encode_intra_420"),
                (intra_codec, "encode_intra_frames_lossy_batch"))


def _jax_counting(monkeypatch):
    """Count the calls of the JAX encoder's device programs (its factories
    are called whether or not a GOP is pending)."""
    calls = []
    for mod, name in ((jpipeline, "jit_encode_gop_batch"),
                      (jpipeline, "jit_encode_gop"),
                      (jp420, "jit_encode_gop_batch_420")):
        factory = getattr(mod, name)

        def counted(cfg, _factory=factory, _name=name):
            fn = _factory(cfg)

            def run(*a, **k):
                calls.append(_name)
                return fn(*a, **k)
            return run
        monkeypatch.setattr(mod, name, counted)
    calls_intra = _count(monkeypatch, [(jintra,
                                        "encode_intra_frames_lossy_batch")])
    return calls, calls_intra


def _assert_same_stream(a, b, cfg):
    """Two streams field for field through numpy (either package's)."""
    assert len(a.gops) == len(b.gops)
    for ga, gb in zip(a.gops, b.gops):
        for f in dataclasses.fields(ga):
            x, y = getattr(ga, f.name), getattr(gb, f.name)
            assert (x is None) == (y is None), f.name
            if x is not None:
                x, y = np.asarray(x), np.asarray(y)
                np.testing.assert_array_equal(x.astype(y.dtype), y,
                                              err_msg=f.name)


@pytest.mark.parametrize("case", ["lossy intra", "reference", "B",
                                  "4:2:0 B"])
def test_jax_directory_resumes_in_the_port(written, monkeypatch, case):
    jvid, _, jdir, _ = written(case)
    calls = _count(monkeypatch, PORT_ENCODES)
    got = Encoder(CodecConfig(**CASES[case]), 2, device="cpu").encode_frames(
        _frames(), checkpoint_dir=jdir)
    assert calls == []
    assert all(g.mv.device.type == "cpu" for g in got.gops)
    _assert_same_stream(got, jvid, got.config)


@pytest.mark.parametrize("case", ["lossy intra", "no dct", "reference B",
                                  "4:2:0"])
def test_port_directory_resumes_in_jax(written, monkeypatch, case):
    _, pvid, _, pdir = written(case)
    calls, calls_intra = _jax_counting(monkeypatch)
    got = jencoder.Encoder(JaxConfig(**CASES[case]), 2).encode_frames(
        _frames(), checkpoint_dir=pdir)
    assert calls == [] and calls_intra == []
    _assert_same_stream(got, pvid, pvid.config)


@pytest.mark.parametrize("case", ["lossy intra", "4:2:0 B"])
def test_loaded_gops_hold_load_npz_dtypes(written, tmp_path, case):
    _, pvid, _, pdir = written(case)
    cfg = pvid.config
    pvid.save_npz(str(tmp_path / "v.npz"))
    want = EncodedVideo.load_npz(str(tmp_path / "v.npz"))
    for g, name in enumerate(_files(pdir)):
        gop = load_gop_npz(os.path.join(pdir, name), cfg,
                           encoder._cfg_fingerprint(cfg))
        for f in dataclasses.fields(gop):
            x, y = getattr(gop, f.name), getattr(want.gops[g], f.name)
            assert (x is None) == (y is None), f.name
            if x is not None:
                assert x.device.type == "cpu" and x.dtype == y.dtype, f.name
                assert torch.equal(x, y), f.name


@pytest.mark.parametrize("case", ["lossy intra", "4:2:0"])
def test_stale_fingerprint_is_encoded_again(tmp_path, monkeypatch, case):
    frames = _frames(seed=3)
    d = str(tmp_path / "ckpt")
    Encoder(CodecConfig(**CASES[case]), 2, device="cpu").encode_frames(
        frames, checkpoint_dir=d)
    # a file from before fingerprints: no `cfg` key
    first = os.path.join(d, "gop_000000.npz")
    arrays = _arrays(first)
    del arrays["cfg"]
    np.savez_compressed(first, **arrays)
    assert load_gop_npz(first, CodecConfig(**CASES[case]), "x") is None
    calls = _count(monkeypatch, PORT_ENCODES)
    requant = CodecConfig(**dict(CASES[case], intra_qstep=12))
    got = Encoder(requant, 2, device="cpu").encode_frames(
        frames, checkpoint_dir=d)
    assert calls
    fresh = Encoder(requant, 2, device="cpu").encode_frames(frames)
    _assert_same_stream(got, fresh, requant)
    for name in _files(d):
        assert str(_arrays(os.path.join(d, name))["cfg"][0]) == \
            encoder._cfg_fingerprint(requant)
    # the same again: everything is on disk now
    del calls[:]
    Encoder(requant, 2, device="cpu").encode_frames(frames, checkpoint_dir=d)
    assert calls == []


def test_a_missing_gop_alone_is_encoded_again(tmp_path, monkeypatch):
    frames = _frames(seed=5)
    cfg = CodecConfig(**CASES["lossy intra"])
    d = str(tmp_path / "ckpt")
    full = Encoder(cfg, 2, device="cpu").encode_frames(frames,
                                                       checkpoint_dir=d)
    os.remove(os.path.join(d, "gop_000001.npz"))
    calls = _count(monkeypatch, PORT_ENCODES)
    got = Encoder(cfg, 2, device="cpu").encode_frames(frames,
                                                      checkpoint_dir=d)
    assert sorted(calls) == ["encode_gop_batch",
                             "encode_intra_frames_lossy_batch"]
    _assert_same_stream(got, full, cfg)
    assert os.path.exists(os.path.join(d, "gop_000001.npz"))


@pytest.mark.parametrize("offset", [0, 5, 999999])
def test_gop_index_offset_names_the_files(tmp_path, monkeypatch, offset):
    frames = _frames(seed=9, n=6)
    cfg = CodecConfig(**CASES["raw I"])
    d = str(tmp_path / "ckpt")
    v = Encoder(cfg, 2, device="cpu").encode_frames(
        frames, checkpoint_dir=d, gop_index_offset=offset)
    assert _files(d) == sorted([f"gop_{offset:06d}.npz",
                                f"gop_{offset + 1:06d}.npz"])
    jdir = str(tmp_path / "jax")
    jencoder.Encoder(JaxConfig(**CASES["raw I"]), 2).encode_frames(
        frames, checkpoint_dir=jdir, gop_index_offset=offset)
    assert _files(jdir) == _files(d)
    calls = _count(monkeypatch, PORT_ENCODES)
    again = Encoder(cfg, 2, device="cpu").encode_frames(
        frames, checkpoint_dir=d, gop_index_offset=offset)
    assert calls == []
    _assert_same_stream(again, v, cfg)
