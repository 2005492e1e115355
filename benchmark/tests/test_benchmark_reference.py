"""The plain reference against the program at a small size on the CPU, for
both configurations: the reference reader gives back the stream the
program's `save_vcs` wrote, field for field and to the last byte, and the
reference codec gives that stream and the program's decoded frames."""

import json

import numpy as np
import pytest

from benchmark.harness import check, frames
from benchmark.reference import codec, vcs_reader
from conftest import REPO

CONFIGS = ["rgb444_720p_lowdelay", "c420_1080p_randomaccess"]


def _config(name, h=48, w=64):
    cfg = json.loads((REPO / "benchmark" / "configs"
                      / f"{name}.json").read_text())
    cfg["height"], cfg["width"] = h, w
    return cfg


@pytest.mark.parametrize("seed", [3, 2**31 + 17])
@pytest.mark.parametrize("name", CONFIGS)
def test_reference_gives_the_programs_stream_and_frames(name, seed,
                                                        tmp_path):
    from vcs_h264_tpu_torch.config import CodecConfig
    from vcs_h264_tpu_torch.io.bitstream import load_vcs, save_vcs
    from vcs_h264_tpu_torch.models.decoder import Decoder
    from vcs_h264_tpu_torch.models.encoder import Encoder
    config = _config(name)
    c = config["codec"]
    n_gops, gop_len = 3, len(c["gop_pattern"])
    pool = frames.frame_pool(seed, n_gops * gop_len, config["height"],
                             config["width"], "cpu")
    cfg = CodecConfig(**dict(c, gop_pattern=tuple(c["gop_pattern"])))
    video = Encoder(cfg, 2, device="cpu").encode_frames(list(pool))
    path = tmp_path / "s.vcs"
    save_vcs(video, str(path), device="cpu")
    decoded = np.stack(Decoder(2, device="cpu").decode(
        load_vcs(str(path), device="cpu")))
    data = path.read_bytes()
    header, read, end = vcs_reader.read(data, set(range(n_gops)))
    assert end == len(data)
    assert (header["n_gops"], header["num_frames"]) == (n_gops, len(pool))
    ref, ref_frames = check.reference_gops(
        pool, [g * gop_len for g in range(n_gops)], gop_len, config, "cpu")
    for g in range(n_gops):
        program = {k: v.numpy() for k, v in vars(video.gops[g]).items()
                   if v is not None and k in ref[g]}
        assert set(read[g]) == set(ref[g]) == set(program)
        assert check.mismatch(read[g], program) == 0
        assert check.mismatch(read[g], ref[g]) == 0
    assert np.array_equal(decoded, ref_frames.reshape(decoded.shape))


def test_reference_refuses_what_it_does_not_code():
    c = dict(_config("rgb444_720p_lowdelay")["codec"], intra_qstep=0)
    with pytest.raises(ValueError):
        codec.Config.from_dict(c)


def test_mismatch_counts_values_and_shapes():
    a = {"x": np.zeros((2, 3)), "y": np.ones(4)}
    assert check.mismatch(a, a) == 0
    assert check.mismatch({"x": np.ones((2, 3)), "y": np.ones(4)}, a) == 6
    assert check.mismatch({"x": np.zeros((3, 2)), "y": np.ones(4)}, a) == 6
    assert check.mismatch({"x": np.zeros((2, 3))}, a) == 4


def test_reader_refuses_a_truncated_file(tmp_path):
    from vcs_h264_tpu_torch.config import CodecConfig
    from vcs_h264_tpu_torch.io.bitstream import save_vcs
    from vcs_h264_tpu_torch.models.encoder import Encoder
    c = _config("rgb444_720p_lowdelay", 32, 48)["codec"]
    cfg = CodecConfig(**dict(c, gop_pattern=tuple(c["gop_pattern"])))
    pool = frames.frame_pool(1, 4, 32, 48, "cpu")
    save_vcs(Encoder(cfg, 1, device="cpu").encode_frames(list(pool)),
             str(tmp_path / "s.vcs"), device="cpu")
    data = (tmp_path / "s.vcs").read_bytes()
    with pytest.raises(ValueError):
        vcs_reader.read(data[:-3], {0})
