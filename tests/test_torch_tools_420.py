"""The 4:2:0 stage of the port's `profile_stages` (chroma420_e2e) against
the JAX tool's body on the CPU, at iterations 0 and 5, under the ROADMAP's
bare-plane contract; the other stages and the rest of the tools:
tests/test_torch_tools.py."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_torch_tools import (  # noqa: E402,F401
    C420_STAGES, arr, check_stage, jax_stages, port_stages, stage_cases)


@pytest.mark.parametrize("tool,name,it", stage_cases(C420_STAGES))
def test_stage_matches_the_jax_tool(port_stages, jax_stages, tool, name, it):
    check_stage(port_stages, jax_stages, tool, name, it)
