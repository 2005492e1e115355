"""The entry points of vcs_h264_tpu_torch against those of the JAX package:
`Encoder` and `Decoder` bind the JAX classes' positional parameters in
their order, with the port's own (`device`, `backend`) keyword-only, and
`EncodedVideo.load_npz` reads the `_meta` of the JAX package's first
streams, stored as the repr of a dict, as the JAX loader does."""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu.config import CodecConfig as JaxConfig  # noqa: E402
from vcs_h264_tpu.models.decoder import Decoder as JaxDecoder  # noqa: E402
from vcs_h264_tpu.models.encoder import Encoder as JaxEncoder  # noqa: E402
from vcs_h264_tpu.models.gop import EncodedVideo as JaxVideo  # noqa: E402

from vcs_h264_tpu_torch import CodecConfig  # noqa: E402
from vcs_h264_tpu_torch.models import Decoder, EncodedVideo, Encoder  # noqa: E402

OWN = ("device", "backend")      # the port's own parameters


def _frames(rng, n, h, w):
    base = rng.integers(0, 256, (h + 2 * n, w + 2 * n, 3))
    return [np.ascontiguousarray(base[t:t + h, t:t + w]).astype(np.uint8)
            for t in range(n)]


def _params(cls):
    return [p for name, p in inspect.signature(cls.__init__).parameters.items()
            if name != "self"]


@pytest.mark.parametrize("port,jax_cls", [(Encoder, JaxEncoder),
                                          (Decoder, JaxDecoder)])
def test_positional_parameters_are_the_jax_classes(port, jax_cls):
    """The port's signature starts with those of the JAX class's parameters
    that it has, in the same order, positional, with equal defaults; what
    it adds is keyword-only."""
    mine = _params(port)
    theirs = {p.name: p for p in _params(jax_cls)}
    shared = [p for p in mine if p.name in theirs]
    assert shared and mine[:len(shared)] == shared
    assert [p.name for p in shared] == \
        [n for n in theirs if n in {p.name for p in shared}]
    for p in shared:
        assert p.kind == inspect.Parameter.POSITIONAL_OR_KEYWORD
        want = theirs[p.name].default
        if p.name == "cfg":          # each package's own default config
            assert dataclass_fields(p.default) == dataclass_fields(want)
        else:
            assert p.default == want
    rest = mine[len(shared):]
    assert [p.name for p in rest] == list(OWN)
    assert all(p.kind == inspect.Parameter.KEYWORD_ONLY for p in rest)


def dataclass_fields(cfg):
    import dataclasses
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if hasattr(JaxConfig(), f.name) and hasattr(CodecConfig(), f.name)}


def test_decoder_takes_gop_batch_first():
    assert Decoder(4, device="cpu").gop_batch == 4
    assert Decoder(device="cpu").gop_batch == JaxDecoder().gop_batch == 8


def test_encoder_defaults_to_reference_mode(rng):
    enc = Encoder(device="cpu")
    assert enc.cfg == CodecConfig() and enc.gop_batch == 8
    assert Encoder(CodecConfig.production(), 2, device="cpu").gop_batch == 2
    frames = _frames(rng, 5, 16, 24)
    video = enc.encode_frames(frames)
    assert video.config == CodecConfig()
    want = Encoder(CodecConfig(), device="cpu").encode_frames(frames)
    for a, b in zip(video.gops, want.gops):
        assert torch.equal(a.mv, b.mv)
        assert (a.residuals is None) == (b.residuals is None)
        assert a.residuals is None or torch.equal(a.residuals, b.residuals)
    assert video.gops[0].residuals is not None
    assert len(Decoder(device="cpu").decode(video)) == len(frames)


@pytest.mark.parametrize("make", [
    lambda: Encoder(CodecConfig(), 8, "cpu"),
    lambda: Encoder(CodecConfig(), 8, "cpu", "plain"),
    lambda: Decoder(8, "cpu"),
    lambda: Decoder("cpu"),
], ids=["encoder device", "encoder backend", "decoder device",
        "decoder device first"])
def test_device_and_backend_are_refused_positionally(make):
    with pytest.raises((TypeError, ValueError)):
        make()


@pytest.mark.parametrize("cfg_kw", [
    dict(), dict(production=True), dict(production=True, intra_qstep=24)],
    ids=["reference", "production", "production intra"])
def test_repr_meta_loads_in_both_packages(rng, tmp_path, cfg_kw):
    """A stream saved by the JAX package and re-saved with `_meta` as the
    repr of its dict (single quotes: not JSON) loads in both packages to
    equal fields, and the port decodes it to the JAX decoder's frames."""
    kw = dict(cfg_kw)
    jcfg = JaxConfig.production(**kw) if kw.pop("production", False) \
        else JaxConfig()
    frames = _frames(rng, 5, 16, 24)
    path, repr_path = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    JaxEncoder(jcfg, gop_batch=2).encode_frames(frames).save_npz(path)
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    import json
    meta = json.loads(str(arrays["_meta"][0]))
    arrays["_meta"] = np.array([repr(meta)])
    with pytest.raises(json.JSONDecodeError):
        json.loads(str(arrays["_meta"][0]))
    np.savez_compressed(repr_path, **arrays)

    from_json, from_repr = (EncodedVideo.load_npz(p) for p in (path, repr_path))
    jax_repr = JaxVideo.load_npz(repr_path)
    assert from_repr.config == from_json.config
    assert (from_repr.height, from_repr.width, from_repr.fps,
            from_repr.num_frames) == (jax_repr.height, jax_repr.width,
                                      jax_repr.fps, jax_repr.num_frames)
    assert len(from_repr.gops) == len(jax_repr.gops)
    import dataclasses
    for a, b, j in zip(from_repr.gops, from_json.gops, jax_repr.gops):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y)
                np.testing.assert_array_equal(
                    x.numpy(), np.asarray(getattr(j, f.name)))
    got = Decoder(device="cpu").decode(from_repr)
    want = JaxDecoder().decode(jax_repr)
    diff = np.abs(np.stack(got).astype(np.int64) - np.stack(want))
    assert diff.max() <= 1 and (diff != 0).mean() < 1e-4
