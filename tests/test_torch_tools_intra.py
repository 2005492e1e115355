"""The stages of the port's stage tools that run the lossy intra codec
(`profile_stages`: intra_lossy_enc, intra_lossy_dec, production_e2e;
`exp_720_stages`: intra_enc, intra_dec) against the JAX tools' bodies on
the CPU, at iterations 0 and 5; the other stages and the rest of the
tools: tests/test_torch_tools.py."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_torch_tools import (  # noqa: E402,F401
    INTRA_STAGES, arr, check_stage, jax_stages, port_stages, stage_cases)


@pytest.mark.parametrize("tool,name,it", stage_cases(INTRA_STAGES))
def test_stage_matches_the_jax_tool(port_stages, jax_stages, tool, name, it):
    check_stage(port_stages, jax_stages, tool, name, it)
