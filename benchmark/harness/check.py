"""Whether the served path's outputs are correct: a sample of the window's
segments, drawn from the seed, held against the plain reference.

For each sampled segment the reference reader walks the segment's `.vcs`
file, accounting for every byte by the sections' length fields, and
decodes the sampled GOPs' fields (vectors, B modes, quantised
coefficients, the intra payload). The reference codec encodes the same
source frames itself. Three numbers are compared, each against its limit:

  stream_mismatch   values of the sampled GOPs' fields (and of the header's
                    geometry, pattern and counts) that differ from the
                    reference's; a field of the wrong shape or missing
                    counts all its values
  frames_mismatch   samples of the frames the window decoded for the sampled
                    GOPs that differ from the reference's decoded frames
  unparsed_bytes    bytes of the file the container's walk does not account
                    for, or the whole file when the walk fails

The codec's stream is integer and its decode exact, so every limit is 0.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from benchmark.harness import traffic
from benchmark.reference import codec, vcs_reader

LIMITS = {"stream_mismatch": 0, "frames_mismatch": 0, "unparsed_bytes": 0}
READERS = 4                     # processes decoding the sampled GOPs


def mismatch(ours: dict, theirs: dict) -> int:
    """Values of `theirs` (the reference's fields) that `ours` does not
    hold: differing values, and every value of a field of another shape."""
    n = 0
    for k in set(ours) | set(theirs):
        a, b = ours.get(k), theirs.get(k)
        if a is None or b is None or np.shape(a) != np.shape(b):
            n += max(np.size(a) if a is not None else 0,
                     np.size(b) if b is not None else 0)
        else:
            n += int(np.count_nonzero(np.asarray(a) != np.asarray(b)))
    return n


def _header_expected(config: dict, seg: int) -> dict:
    c = config["codec"]
    return dict(version=vcs_reader.VERSION, height=config["height"],
                width=config["width"], num_frames=seg,
                n_gops=seg // len(c["gop_pattern"]),
                block_size=c["block_size"],
                quality_factor=c["quality_factor"],
                gop_pattern=tuple(c["gop_pattern"]),
                intra_qstep=c["intra_qstep"])


def draw(seed: int, kept: list, per_segment: int, n_gops: int) -> list:
    """The GOPs compared in each kept segment, drawn from the seed."""
    rng = np.random.default_rng([seed, traffic.GOPS])
    return [sorted(rng.choice(n_gops, size=min(per_segment, n_gops),
                              replace=False).tolist()) for _ in kept]


def reference_gops(pool: np.ndarray, starts: list, gop_len: int,
                   config: dict, device, ftype=torch.float32, log=None):
    """The reference's fields and decoded frames of the GOPs whose first
    frames are pool[starts]: (list of per-GOP field dicts of numpy arrays,
    uint8 frames [G, L, H, W, 3] in host memory)."""
    cfg = codec.Config.from_dict(config["codec"])
    src = torch.from_numpy(np.stack([pool[s:s + gop_len] for s in starts]))
    fields, recon = codec.encode(src.to(device), cfg, ftype, log)
    per_gop = [{k: v[i].cpu().numpy() for k, v in fields.items()}
               for i in range(len(starts))]
    return per_gop, recon.cpu().numpy()


def _decode_fields(jobs: list) -> list:
    """The fields of each (file bytes, GOP) job, {} for None, decoded by
    READERS processes at once (the range decoders are pure Python)."""
    todo = [j for j in jobs if j is not None]
    if not todo:
        return [{} for _ in jobs]
    with ProcessPoolExecutor(
            max_workers=min(READERS, len(todo)),
            mp_context=multiprocessing.get_context("spawn")) as ex:
        done = iter(list(ex.map(vcs_reader.gop_fields, todo)))
    return [{} if j is None else next(done) for j in jobs]


def judge(kept: list, pool: np.ndarray, config: dict, seed: int, seg: int,
          per_segment: int, device):
    """kept: [(segment index, pool offset, .vcs path, decoded frames)] ->
    ({number: {"value", "limit"}}, the count of GOPs compared)."""
    gop_len = len(config["codec"]["gop_pattern"])
    n_gops = seg // gop_len
    picks = draw(seed, kept, per_segment, n_gops)
    expected = _header_expected(config, seg)
    stream = frames = unparsed = 0
    jobs, window = [], []           # per GOP: (file, GOP) or None, frames
    starts = []
    for (_, off, path, decoded), gops in zip(kept, picks):
        with open(path, "rb") as fh:
            data = fh.read()
        try:
            header, _, end = vcs_reader.read(data)
        except ValueError:
            header, end = {}, 0
        unparsed += len(data) - end
        stream += sum(header.get(k) != v for k, v in expected.items())
        for g in gops:
            jobs.append((data, g) if header else None)
            window.append(np.stack(decoded[g * gop_len:(g + 1) * gop_len]))
            starts.append(off + g * gop_len)
    read = _decode_fields(jobs)
    ref_fields, ref_frames = reference_gops(pool, starts, gop_len, config,
                                            device)
    for got, window_frames, want, ref in zip(read, window, ref_fields,
                                             ref_frames):
        stream += mismatch(got, want)
        frames += (int(np.count_nonzero(window_frames != ref))
                   if window_frames.shape == ref.shape else ref.size)
    values = dict(stream_mismatch=stream, frames_mismatch=frames,
                  unparsed_bytes=unparsed)
    return ({k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()},
            len(starts))


def passed(checks: dict, n_gops: int) -> bool:
    return n_gops > 0 and all(v["value"] <= v["limit"]
                              for v in checks.values())
