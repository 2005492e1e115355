"""A run whose timed path is broken underneath comes out not correct: the
whole run, its look for a card skipped, on the CPU at a tiny size, once
for each fault a served codec can have, with the mixes' own sample of
segments and GOPs. Both mixes are tried: `live` (one GOP a segment) and
`vod` (a batch of GOPs a segment, where a fault may sit in one slot); an
all-intra cell, whose GOPs have no vectors, gets its own fault in the
intra payload."""

import numpy as np
import pytest

from conftest import add_allintra_cell, add_cell, run_cell


def _altered_frame(monkeypatch):
    """An answer altered where it is produced: one decoded sample."""
    from vcs_h264_tpu_torch.models.decoder import Decoder
    real = Decoder.decode

    def decode(self, video):
        out = real(self, video)
        out[0][0, 0, 0] ^= 1
        return out
    monkeypatch.setattr(Decoder, "decode", decode)


def _stale_frames(monkeypatch):
    """A step that returns its state unchanged: the decoder hands back the
    previous segment's frames."""
    from vcs_h264_tpu_torch.models.decoder import Decoder
    real, last = Decoder.decode, {}

    def decode(self, video):
        out = real(self, video)
        prev = last.get("out", out)
        last["out"] = out
        return prev
    monkeypatch.setattr(Decoder, "decode", decode)


def _half_batch(monkeypatch):
    """Half of each batch left out: the encoder codes the first half of a
    segment's GOPs and repeats them in place of the rest."""
    from vcs_h264_tpu_torch.models.encoder import Encoder
    real = Encoder.encode_frames

    def encode_frames(self, frames, *a, **k):
        video = real(self, frames, *a, **k)
        n = len(video.gops)
        if n > 1:
            video.gops[n // 2:] = video.gops[:n - n // 2]
        else:
            video.gops[0].mv.zero_()
        return video
    monkeypatch.setattr(Encoder, "encode_frames", encode_frames)


def _altered_vector(monkeypatch):
    """A token altered where it is produced, in one GOP slot of the batch:
    one motion vector of every segment's middle GOP."""
    from vcs_h264_tpu_torch.models.encoder import Encoder
    real = Encoder.encode_frames

    def encode_frames(self, frames, *a, **k):
        video = real(self, frames, *a, **k)
        video.gops[len(video.gops) // 2].mv[0, 0, 0, 0] += 1
        return video
    monkeypatch.setattr(Encoder, "encode_frames", encode_frames)


def _altered_intra_coefficient(monkeypatch):
    """A token altered where it is produced, in one GOP slot of the batch:
    one quantised luma intra coefficient of every segment's middle GOP."""
    from vcs_h264_tpu_torch.models.encoder import Encoder
    real = Encoder.encode_frames

    def encode_frames(self, frames, *a, **k):
        video = real(self, frames, *a, **k)
        video.gops[len(video.gops) // 2].iq_y[0, 0, 0] += 1
        return video
    monkeypatch.setattr(Encoder, "encode_frames", encode_frames)


def _padded_file(monkeypatch):
    """The container's size wrong: a byte written past the last section."""
    from vcs_h264_tpu_torch.io import bitstream
    real = bitstream.save_vcs

    def save_vcs(video, path, **k):
        real(video, path, **k)
        with open(path, "ab") as fh:
            fh.write(b"\0")
    monkeypatch.setattr(bitstream, "save_vcs", save_vcs)


FAULTS = {"altered_frame": (_altered_frame, "frames_mismatch"),
          "stale_frames": (_stale_frames, "frames_mismatch"),
          "half_batch": (_half_batch, "stream_mismatch"),
          "altered_vector": (_altered_vector, "stream_mismatch"),
          "padded_file": (_padded_file, "unparsed_bytes")}


@pytest.mark.parametrize("config, traffic", [
    ("rgb444_720p_lowdelay", "live"), ("c420_1080p_randomaccess", "vod")])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_path_is_not_correct(tiny_root, monkeypatch, fault, config,
                                      traffic):
    cell = add_cell(tiny_root, config, traffic)
    sound = run_cell(tiny_root, cell, seconds=0.3)
    assert sound["correct"]
    plant, number = FAULTS[fault]
    plant(monkeypatch)
    broken = run_cell(tiny_root, cell, seconds=0.3)
    assert not broken["correct"]
    assert broken["checks"][number]["value"] > 0
    assert np.isfinite(broken["checks"][number]["value"])


def test_an_altered_intra_coefficient_is_not_correct(tiny_root, monkeypatch):
    cell = add_allintra_cell(tiny_root)
    assert run_cell(tiny_root, cell, seconds=0.3)["correct"]
    _altered_intra_coefficient(monkeypatch)
    broken = run_cell(tiny_root, cell, seconds=0.3)
    assert not broken["correct"]
    assert broken["checks"]["stream_mismatch"]["value"] > 0
