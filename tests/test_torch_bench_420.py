"""The 4:2:0 step of the port's bench (`bench.chroma420_step`) against
`bench.py:289-299`'s step body on the CPU, at rolls 0 and 5, under the
ROADMAP's bare-plane contract; the rest of the bench:
tests/test_torch_bench.py. The JAX side is composed as `bench.py` composes
it, without the outer jit of the loop."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from vcs_h264_tpu.config import CodecConfig as JaxConfig  # noqa: E402
from vcs_h264_tpu.models import pipeline420 as jp420  # noqa: E402

from test_torch_bench import (  # noqa: E402,F401
    ITS, arr, jax_in, jroll, port_in)
from test_torch_tools import _check_420, _frames_close  # noqa: E402
from vcs_h264_tpu_torch import bench  # noqa: E402
from vcs_h264_tpu_torch.models import pipeline420  # noqa: E402

CCFG = JaxConfig(quant_mode="rounded", chroma_420=True, intra_i=True,
                 intra_qstep=bench.QSTEP)          # bench.py:289-290


def jax_step_420(i_f, p_f, it):
    """bench.py:291-299, one step's outputs."""
    i_c, p_c = i_f[..., :352, :], p_f[..., :352, :]
    enc = jp420.encode_gop_batch_420(jroll(i_c, it), jroll(p_c, it), CCFG)
    dec = jp420.decode_gop_batch_420(enc, CCFG)
    return enc, dec


@pytest.mark.parametrize("it", ITS)
def test_420_step_matches_bench_py(port_in, jax_in, it):
    """Every field but the residuals identical, the residuals +-1 on fewer
    than 1e-3; the port's decode against the JAX package's decode of the
    same (the port's) stream: planes +-1 on fewer than 1e-4, BGR +-2 on
    fewer than 1e-3 (`_check_420`)."""
    assert dataclasses.asdict(bench.C420) == dataclasses.asdict(CCFG)
    (enc, dec), total = bench.chroma420_step(*port_in)(it)
    jenc, jdec = jax_step_420(*jax_in, it)
    assert dec.shape == jdec.shape == (2, 4, 3, 64, 96)
    assert dec.dtype == torch.uint8
    _check_420((enc, dec), (jenc, jdec))
    same = jp420.EncodedGOP420(**{
        f.name: jnp.asarray(getattr(enc, f.name).numpy()).astype(
            getattr(jenc, f.name).dtype)
        for f in dataclasses.fields(enc) if getattr(enc, f.name) is not None})
    y, c = pipeline420.decode_gop_batch_420(enc, bench.C420, as_bgr=False)
    jy, jc = jp420.decode_gop_batch_420(same, CCFG, as_bgr=False)
    _frames_close(y, jy)
    _frames_close(c, jc)
    assert int(total) == int(dec.sum()) + int(enc.mv.sum())



def test_smoke_holds_a_bench_step_to_the_contract(port_in):
    """`chip_smoke.step_parity`, which holds each bench step on the card
    against the same call on the plain versions, on the 4:2:0 step's
    outputs: bare-plane coefficients +-1 on fewer than 1e-3, frames +-1 on
    fewer than 1e-4, vectors identical."""
    import chip_smoke
    out = bench.chroma420_step(*port_in)(0)[0]
    assert "bare-plane max |diff| 0" in chip_smoke.step_parity(out, out, "s")

    def changed(field, k, delta):
        """The outputs with the first k values of `field` moved by delta
        (uint8 by xor, so that none wraps)."""
        enc, dec = dataclasses.replace(out[0]), out[1].clone()
        t = dec if field == "dec" else getattr(enc, field).clone()
        if t.dtype == torch.uint8:
            t.view(-1)[:k] ^= delta
        else:
            t.view(-1)[:k] += delta
        if field != "dec":
            setattr(enc, field, t)
        return enc, dec

    ok = (("res_y", 1, 1), ("res_c", 1, -1), ("dec", 1, 1))
    bad = (("mv", 1, 1), ("res_y", 1, 2), ("res_y", 64, 1),
           ("dec", 1, 2), ("dec", 16, 1), ("i_y", 1, 2))
    for field, k, delta in ok:
        chip_smoke.step_parity(changed(field, k, delta), out, "s")
    for field, k, delta in bad:
        with pytest.raises(SystemExit, match=field.replace(
                "dec", r"out\[1\]")):
            chip_smoke.step_parity(changed(field, k, delta), out, "s")
