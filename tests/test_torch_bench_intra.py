"""The production loops of the port's bench (`bench.production_steps`:
loop_enc, plain and with the luma-only search, and loop_dec) against
`bench.py:221-247`'s step bodies on the CPU, at rolls 0 and 5; the rest of
the bench: tests/test_torch_bench.py. The JAX side is composed as
`bench.py` composes it, from the package's jitted intra codec and its
pipeline, without the outer jit of the loop, whose compile of the intra
scan would come again for each program."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu.config import CodecConfig as JaxConfig  # noqa: E402
from vcs_h264_tpu.models import intra_codec as jintra  # noqa: E402
from vcs_h264_tpu.models import pipeline as jpipe  # noqa: E402

from test_torch_bench import (  # noqa: E402,F401
    ITS, arr, jax_in, jroll, port_in)
from test_torch_tools import (_frames_close, _gop_fields,  # noqa: E402
                              _payload, _same)
from vcs_h264_tpu_torch import bench  # noqa: E402

QSTEP = bench.QSTEP


def jax_loop_enc(i_f, p_f, it, luma_search):
    """bench.py:230-240, one step's outputs."""
    pcfg = JaxConfig.production(intra_qstep=QSTEP,
                                search_luma_only=luma_search)
    p = jroll(p_f, it)
    i = jroll(i_f, it)
    payload, i_rec = jintra.encode_intra_frames_lossy_batch(i, QSTEP)
    enc = jpipe.encode_gop_batch(i_rec, p, pcfg)
    dec = jpipe.decode_gop_batch(enc, pcfg)
    return payload, i_rec, enc, dec


def jax_loop_dec(i_f, it):
    """bench.py:242-253, one step's output."""
    payload, _ = jintra.encode_intra_frames_lossy_batch(i_f, QSTEP)
    p2 = jintra.IntraFrameLossy(jroll(payload.qcoef, it), payload.modes,
                                payload.escape)
    return jintra.decode_intra_frames_lossy_batch(p2, QSTEP)


@pytest.mark.parametrize("luma_search", (False, True))
@pytest.mark.parametrize("it", ITS)
def test_loop_enc_matches_bench_py(port_in, jax_in, it, luma_search):
    loop_enc = bench.production_steps(*port_in, luma_search)["loop_enc"]
    (payload, i_rec, enc, dec), total = loop_enc(it)
    jpay, ji_rec, jenc, jdec = jax_loop_enc(*jax_in, it, luma_search)
    _payload(payload, jpay)
    _same(i_rec, ji_rec)
    _gop_fields(enc, jenc)
    _frames_close(dec, jdec)
    assert int(total) == (int(enc.mv.sum()) + int(dec.sum())
                          + int(payload.qcoef.sum()))


@pytest.mark.parametrize("it", ITS)
def test_loop_dec_matches_bench_py(port_in, jax_in, it):
    loop_dec = bench.production_steps(*port_in)["loop_dec"]
    i_dec, total = loop_dec(it)
    _same(i_dec, jax_loop_dec(jax_in[0], it))
    assert int(total) == int(i_dec.sum())
