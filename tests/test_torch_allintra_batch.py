"""All-intra GOPs (`gop_pattern=("I",)`) on the batched path of the
Encoder and the Decoder, in 4:4:4 and 4:2:0, on the CPU: a batch of 8 GOPs
and a partial batch of 3 write the `.vcs` bytes of GOPs coded one at a time
and decode to the same frames, from the file and from the encoder's output,
whatever the decoder's batch; each GOP is the benchmark's plain reference
(`benchmark/reference/codec.py` `encode_intra_only`) field for field and
frame for frame; and a stream that mixes P/B and all-intra GOPs keeps its
frame order."""

import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu_torch import CodecConfig  # noqa: E402
from vcs_h264_tpu_torch.io.bitstream import load_vcs, save_vcs  # noqa: E402
from vcs_h264_tpu_torch.models import Decoder, Encoder  # noqa: E402
from vcs_h264_tpu_torch.models.gop import EncodedVideo  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
H, W = 32, 48
N_FRAMES = 11                   # a full batch of 8 GOPs and a batch of 3
# layout -> the benchmark configuration whose codec it takes
LAYOUTS = {"444": "rgb444_720p_lowdelay", "420": "c420_1080p_randomaccess"}
SEEDS = [4, 2**31 + 9]


def _codec(layout, pattern=("I",)) -> dict:
    path = REPO / "benchmark" / "configs" / f"{LAYOUTS[layout]}.json"
    return dict(json.loads(path.read_text())["codec"],
                gop_pattern=list(pattern))


def _cfg(layout, pattern=("I",)) -> CodecConfig:
    codec = _codec(layout, pattern)
    return CodecConfig(**dict(codec, gop_pattern=tuple(codec["gop_pattern"])))


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (H + 2 * n, W + 2 * n, 3))
    return [np.ascontiguousarray(base[t:t + H, t:t + W]).astype(np.uint8)
            for t in range(n)]


def _saved(video, path) -> bytes:
    save_vcs(video, str(path), device="cpu")
    return path.read_bytes()


def _decoded(video, gop_batch) -> np.ndarray:
    return np.stack(Decoder(gop_batch, device="cpu").decode(video))


def _reference_codec():
    """`benchmark/reference/codec.py`, imported from the checkout."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    return importlib.import_module("benchmark.reference.codec")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_batched_all_intra_is_bit_exact(layout, seed, tmp_path):
    cfg, frames = _cfg(layout), _frames(N_FRAMES, seed)
    one = Encoder(cfg, 1, device="cpu").encode_frames(frames)
    batched = Encoder(cfg, 8, device="cpu").encode_frames(frames)
    assert [g.num_coded for g in batched.gops] == [1] * N_FRAMES
    data = _saved(one, tmp_path / "one.vcs")
    assert _saved(batched, tmp_path / "batched.vcs") == data
    want = _decoded(load_vcs(str(tmp_path / "one.vcs"), device="cpu"), 1)
    loaded = load_vcs(str(tmp_path / "batched.vcs"), device="cpu")
    for gop_batch in (8, 3):
        np.testing.assert_array_equal(_decoded(loaded, gop_batch), want)
        np.testing.assert_array_equal(_decoded(batched, gop_batch), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_each_gop_is_the_plain_reference(layout, seed):
    codec = _reference_codec()
    frames = _frames(N_FRAMES, seed)
    video = Encoder(_cfg(layout), 8, device="cpu").encode_frames(frames)
    fields, recon = codec.encode_intra_only(
        torch.from_numpy(np.stack(frames)[:, None]),
        codec.Config.from_dict(_codec(layout)))
    for g, gop in enumerate(video.gops):
        program = {k: v for k, v in vars(gop).items() if v is not None}
        stored = {"i_frame"} if layout == "444" else {"i_y", "i_c"}
        assert set(program) == set(fields) | stored
        for k, v in fields.items():
            assert program[k].dtype == v.dtype, k
            assert torch.equal(program[k], v[g]), (g, k)
    np.testing.assert_array_equal(_decoded(video, 8), recon[:, 0].numpy())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_a_mixed_stream_keeps_its_frame_order(layout, tmp_path):
    """IPPP GOPs, full and short, between I-frame-only GOPs, some of them
    loaded from a file (host tensors) and some the encoder's: every
    decoder batch gives the frames of each GOP decoded alone, in order."""
    cfg = _cfg(layout, ("I", "P", "P", "P"))
    enc = Encoder(cfg, 8, device="cpu")
    frames = _frames(13, 7)
    nine = enc.encode_frames(frames[:9])          # full, full, I alone
    six = enc.encode_frames(frames[7:13])         # full, I + P
    _saved(nine, tmp_path / "nine.vcs")
    loaded = load_vcs(str(tmp_path / "nine.vcs"), device="cpu")
    i_only = [nine.gops[2], loaded.gops[2]]
    assert [g.num_p for g in i_only] == [0, 0]
    gops = [i_only[0], nine.gops[0], i_only[1], i_only[0], loaded.gops[1],
            six.gops[1], i_only[1], i_only[0], six.gops[0], i_only[1]]
    n = sum(g.num_coded for g in gops)

    def video(gs, num_frames):
        return EncodedVideo(config=cfg, height=H, width=W, fps=25.0,
                            num_frames=num_frames, gops=gs)

    want = np.concatenate([_decoded(video([g], g.num_coded), 1)
                           for g in gops])
    assert len(want) == n
    for gop_batch in (8, 3, 2):
        np.testing.assert_array_equal(_decoded(video(gops, n), gop_batch),
                                      want)
