"""The port's plain closed-loop lossy intra wavefront against the JAX scan
at the shapes that stress its bookkeeping: several planes of a wide frame,
one block row (nbh = 1), one block column (nbw = 1, a plane taller than
the diagonals are long), and a narrow plane of the 1080p cells' 1072 rows,
which K5 codes in its tall form. Exact, as every intra output is an
integer. Kept apart from tests/test_torch_intra.py because each shape is
one XLA compile of the JAX scan."""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu.ops import intra as jintra  # noqa: E402

from vcs_h264_tpu_torch.ops import intra, intra_cuda  # noqa: E402


@pytest.mark.parametrize("n,h,w,qstep", [
    (3, 20, 64, 64),
    (1, 4, 36, 24),          # nbh = 1
    (1, 36, 4, 24),          # nbw = 1
    (1, 1072, 8, 24),        # nbh = 268: the 1080p cells' luma height, past
                             # the 256 block rows of K5's staged form
])
def test_lossy_wavefront_matches_jax(rng, n, h, w, qstep):
    planes = rng.integers(0, 256, (n, h, w)).astype(np.uint8)
    got = intra.intra_encode4x4_lossy_batch(torch.from_numpy(planes), qstep)
    want = jintra.intra_encode4x4_lossy_batch(
        jnp.asarray(planes, jnp.int32), qstep, backend="xla")
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w_).astype(np.int64))
    assert torch.equal(intra.intra_decode4x4_lossy_batch(*got[:3], qstep),
                       got[3])
    assert intra_cuda.LAUNCHES == {"intra_encode": 0, "intra_decode": 0}
