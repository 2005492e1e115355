"""vcs_h264_tpu_torch with nothing of the repository beside it: the package
alone is copied into a directory of the test's own (without its `build/`)
and run there in a process whose import path holds that directory only,
with `jax`, `vcs_h264_tpu` and `cv2` refused by an import hook and a
`RuntimeWarning` raised as an error. The `.vcs` range coder must build
from the copy's own `csrc/bitstream.cpp` and load, and the copy's
Encoder -> save_vcs -> load_vcs -> Decoder must give the bytes and frames
of the package in the repository on the same clip."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu_torch import CodecConfig  # noqa: E402
from vcs_h264_tpu_torch.io import bitstream as bits  # noqa: E402
from vcs_h264_tpu_torch.models import Decoder, Encoder  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "vcs_h264_tpu_torch"
SEED, FRAMES, H, W = 5, 8, 32, 48        # 2 GOPs of 4 frames
BLOCKED = ("jax", "vcs_h264_tpu", "cv2")
# label -> CodecConfig.production's arguments
CONFIGS = {
    "production": dict(intra_qstep=24),
    "c420": dict(chroma_420=True, intra_qstep=24),
}
TIMEOUT_S = 300


def clip(seed=SEED, n=FRAMES, h=H, w=W):
    """A smooth random texture panned 1 px down and 2 px left a frame:
    BGR uint8 [h, w, 3] frames, so the search finds vectors."""
    rng = np.random.default_rng(seed)
    m = 2 * n + 4
    tex = rng.integers(0, 256, (h + 2 * m + 3, w + 2 * m + 3, 3))
    tex = sum(tex[i:i + h + 2 * m, j:j + w + 2 * m]
              for i in range(4) for j in range(4)) // 16
    return [tex[m + t:m + t + h, m - 2 * t:m - 2 * t + w].astype(np.uint8)
            for t in range(n)]


_STANDALONE = """
import importlib.abc
import json
import os
import sys
import warnings

BLOCKED = %(blocked)r


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is refused in the stand-alone run")
        return None


sys.meta_path.insert(0, Refuse())
warnings.simplefilter("error", RuntimeWarning)

import numpy as np
import torch
torch.set_num_threads(2)
from vcs_h264_tpu_torch import CodecConfig
from vcs_h264_tpu_torch.io import bitstream
from vcs_h264_tpu_torch.models import Decoder, Encoder

out = sys.argv[1]
record = dict(pkg=os.path.dirname(bitstream.__file__),
              native_loaded=bitstream.native_loaded(),
              native_src=str(bitstream.NATIVE_SRC),
              native_library=str(bitstream.native_library_path()))
frames = list(np.load(os.path.join(out, "frames.npy")))
for label, kw in %(configs)r.items():
    path = os.path.join(out, label + ".vcs")
    video = Encoder(CodecConfig.production(**kw),
                    device="cpu").encode_frames(frames)
    bitstream.save_vcs(video, path, device="cpu")
    decoded = Decoder(device="cpu").decode(bitstream.load_vcs(path,
                                                              device="cpu"))
    np.save(os.path.join(out, label + ".npy"), np.stack(decoded))
print(json.dumps(record))
"""


@pytest.fixture(scope="module")
def standalone(tmp_path_factory):
    """The copy's run -> (its root, its output directory, its record)."""
    root = tmp_path_factory.mktemp("standalone")
    shutil.copytree(os.path.join(REPO, PKG), root / PKG,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    out = root / "out"
    out.mkdir()
    np.save(out / "frames.npy", np.stack(clip()))
    proc = subprocess.run(
        [sys.executable, "-c", _STANDALONE % dict(blocked=BLOCKED,
                                                   configs=CONFIGS),
         str(out)], cwd=root, capture_output=True, text=True,
        timeout=TIMEOUT_S, env={**os.environ, "PYTHONPATH": str(root)})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return root, out, json.loads(proc.stdout.strip().splitlines()[-1])


def test_standalone_loads_the_native_coder_from_its_own_source(standalone):
    root, _, record = standalone
    pkg = root / PKG
    assert record["pkg"] == str(pkg / "io")
    assert record["native_loaded"], record
    assert record["native_src"] == str(pkg / "csrc" / "bitstream.cpp")
    assert record["native_library"].startswith(str(pkg / "build") + os.sep)
    assert os.path.exists(record["native_library"])


@pytest.mark.parametrize("label", sorted(CONFIGS))
def test_standalone_vcs_is_the_repository_package_bytes(standalone, label,
                                                        tmp_path):
    _, out, _ = standalone
    frames = clip()
    path = str(tmp_path / (label + ".vcs"))
    video = Encoder(CodecConfig.production(**CONFIGS[label]),
                    device="cpu").encode_frames(frames)
    bits.save_vcs(video, path, device="cpu")
    with open(path, "rb") as fh, open(out / (label + ".vcs"), "rb") as gh:
        assert fh.read() == gh.read()
    decoded = np.stack(Decoder(device="cpu").decode(
        bits.load_vcs(path, device="cpu")))
    np.testing.assert_array_equal(np.load(out / (label + ".npy")), decoded)
    assert decoded.shape == (FRAMES, H, W, 3)
