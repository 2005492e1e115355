"""The bound arithmetic: K2's bound at the kernel table's shape (8 GOPs of
3 P-frames of the clip the table was measured on, 3 x 720 x 1280, and the
4:2:0 luma search at C = 1 on the same frames) and K5's on 24 planes of
1280 x 720, as the table in PERF.md gives them: 0.1231 ms, 0.0240 ms and
0.0310 ms."""

import numpy as np
import pytest
import torch

from benchmark.harness import bounds
from benchmark.reference import plain_ops


def _clip_gops():
    from vcs_h264_tpu_torch.tools.clips import synthetic_clip
    clip = torch.from_numpy(np.stack(synthetic_clip(0, 34)[:32]))
    clip = clip.permute(0, 3, 1, 2).reshape(8, 4, 3, 720, 1280)
    return clip[:, 1:].contiguous(), clip[:, 0].contiguous()


def _call(curs, refs, threshold):
    g, f, c, h, w = curs.shape
    static = (plain_ops.static_sad(curs, refs[:, None], 8)
              <= threshold).numpy()
    return dict(g=g, f=f, c=c, h=h, w=w, bs=8, reach=16, step=3,
                static=static)


@pytest.mark.parametrize("luma, want_ms", [(False, 0.1231), (True, 0.0240)])
def test_search_bound_at_the_tables_shape(luma, want_ms):
    curs, refs = _clip_gops()
    threshold = 2000
    if luma:
        y_ref, _ = plain_ops.ingest_420(refs)
        y_cur, _ = plain_ops.ingest_420(curs)
        curs, refs, threshold = y_cur[:, :, None], y_ref[:, None], 2000 // 3
    n_bytes, n_ops = bounds.search_work(_call(curs, refs, threshold))
    assert round(1e3 * bounds.bound_seconds(n_bytes, n_ops), 4) == want_ms


def test_intra_encode_bound_at_the_tables_shape():
    n_bytes, n_ops = bounds.intra_encode_work(24, 720, 1280)
    assert round(1e3 * bounds.bound_seconds(n_bytes, n_ops), 4) == 0.0310
    assert n_ops / bounds.PEAK_OPS_PER_S > n_bytes / bounds.PEAK_BYTES_PER_S


def test_search_work_counts_static_blocks_once():
    call = dict(g=1, f=1, c=1, h=16, w=16, bs=8, reach=16, step=3,
                static=np.ones((1, 1, 2, 2), bool))
    assert bounds.search_work(call)[1] == 3 * 64 * 4
    call["static"][:] = False
    valid = bounds.valid_candidates(16, 16, 8, 16, 3)
    assert bounds.search_work(call)[1] == 3 * 64 * (4 + valid.sum())
