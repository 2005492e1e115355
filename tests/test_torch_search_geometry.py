"""K2 at every search geometry the JAX package runs, on the CPU.

K2 (`vcs_h264_tpu_torch/csrc/motion_sad.cu`) has three forms, chosen by shape
alone in `csrc/sad_form.cuh` and, in the same arithmetic, by
`ops.motion_cuda.sad_search_form`: the word kernel, the byte kernel and the
direct form for windows that fit no block's shared memory. Here:

  * the Python rule at the main path's geometry (today's word kernel and
    shared memory), at G1-G9 (the geometries the wrapper used to refuse)
    and at a bs 8 window of 315 KB, and the Python rule equal to the C
    header compiled with g++ over a grid of geometries;
  * the plain search, which K2 is held to on the card, against the JAX
    package's XLA search at each of G1-G9's (bs, reach, step, C);
  * a numpy emulation of the direct form, thread by thread and warp by
    warp, identical to the plain search, and the minimum of the packed keys
    the same in any order, on random and flat (all-tie) inputs;
  * Encoder.encode_frames of the port against the JAX encoder at a full
    search (reach 32, step 1) and at bs 32 without the DCT.
"""

import os
import shutil
import subprocess

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu.config import CodecConfig as JaxConfig  # noqa: E402
from vcs_h264_tpu.models.encoder import Encoder as JaxEncoder  # noqa: E402
from vcs_h264_tpu.ops import motion as jmotion  # noqa: E402

from vcs_h264_tpu_torch import CodecConfig  # noqa: E402
from vcs_h264_tpu_torch.models import Encoder  # noqa: E402
from vcs_h264_tpu_torch.ops import motion, motion_cuda  # noqa: E402

from test_torch_pipeline import _clip  # noqa: E402
from test_torch_reference import assert_same_stream  # noqa: E402

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "vcs_h264_tpu_torch", "csrc")

# (bs, reach, step, C) -> (form of aligned operands, its shared bytes)
GEOMETRIES = {
    "G1": ((8, 32, 1, 3), ("words", 65280)),
    "G2": ((8, 32, 1, 1), ("words", 21760)),
    "G3": ((8, 64, 4, 3), ("words", 215808)),
    "G4": ((4, 64, 4, 3), ("words", 202848)),
    "G5": ((8, 64, 1, 1), ("words", 75776)),
    "G6": ((32, 64, 11, 3), ("bytes", 73299)),
    "G7": ((64, 16, 3, 3), ("bytes", 38796)),
    "G8": ((64, 128, 21, 1), ("bytes", 103952)),
    "G9": ((64, 128, 21, 3), ("direct", 0)),
    "G10": ((8, 160, 4, 3), ("direct", 0)),
}


@pytest.mark.parametrize("c,shmem", [(3, 20736), (1, 7168)])
def test_main_geometry_takes_the_word_kernel(c, shmem):
    """bs 8, reach 16, step 3: the word kernel with the shared memory and
    threads it had before the other forms came."""
    assert motion_cuda.sad_search_form(c, 8, 16, 3, True) == ("words", shmem,
                                                              128)
    assert motion_cuda.sad_search_form(c, 8, 16, 3, False)[0] == "bytes"


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_every_geometry_has_a_form(name):
    (bs, reach, step, c), want = GEOMETRIES[name]
    form, shmem, threads = motion_cuda.sad_search_form(c, bs, reach, step,
                                                       True)
    assert (form, shmem) == want
    k = motion.make_plan(4 * bs, 4 * bs, bs, reach, step).k
    assert threads == min(-(-k * k // 32) * 32, 1024)
    assert shmem <= 232448
    misaligned = motion_cuda.sad_search_form(c, bs, reach, step, False)
    assert misaligned[0] == ("bytes" if form == "words" else form)


def _c_forms(tmp_path, geometries):
    """`sad_search_form` of csrc/sad_form.cuh, compiled with g++, for each
    (C, bs, reach, step, aligned)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile csrc/sad_form.cuh")
    src = tmp_path / "form.cpp"
    src.write_text(
        '#include <cstdio>\n#include "sad_form.cuh"\n'
        "int main() {\n  int c, bs, r, s, a;\n"
        '  while (scanf("%d %d %d %d %d", &c, &bs, &r, &s, &a) == 5) {\n'
        "    const vcs_sad::SadPlan p = vcs_sad::sad_search_form(c, bs, r, s,"
        " a != 0);\n"
        '    printf("%d %zu %d\\n", p.form, p.shmem, p.threads);\n  }\n}\n')
    exe = tmp_path / "form"
    subprocess.run([gxx, "-std=c++17", "-O1", "-I", CSRC, "-o", str(exe),
                    str(src)], check=True, capture_output=True)
    out = subprocess.run([str(exe)], input="\n".join(
        " ".join(map(str, g)) for g in geometries), capture_output=True,
        text=True, check=True).stdout.split()
    return [(motion_cuda.SAD_FORMS[int(f)], int(m), int(t))
            for f, m, t in zip(out[::3], out[1::3], out[2::3])]


def test_python_rule_is_the_c_rule(tmp_path):
    """Every geometry the search admits on a grid of C, bs, reach and step,
    aligned and not: the same form, shared bytes and threads."""
    geos = []
    for c in (1, 2, 3):
        for bs in (2, 4, 6, 8, 16, 32, 64):
            for reach in (1, 5, 8, 16, 32, 64, 128, 160):
                for step in (1, 2, 3, 4, 11, 21):
                    plan = motion.make_plan(4 * bs, 4 * bs, bs, reach, step)
                    try:
                        motion.key_packing(plan, c)
                    except ValueError:
                        continue
                    geos += [(c, bs, reach, step, 1), (c, bs, reach, step, 0)]
    got = _c_forms(tmp_path, geos)
    want = [motion_cuda.sad_search_form(c, bs, r, s, bool(a))
            for c, bs, r, s, a in geos]
    assert got == want
    assert {f for f, _, _ in got} == set(motion_cuda.SAD_FORMS)


def _frames(rng, g, f, c, h, w):
    """refs [g, c, h, w] and curs [g, f, c, h, w]: a reference moved by
    (2, -3) with small noise, and one frame of random bytes."""
    refs = rng.integers(0, 256, (g, c, h, w), dtype=np.uint8)
    moved = np.roll(refs[:, None], (2, -3), axis=(-2, -1)).astype(np.int16)
    curs = np.clip(moved + rng.integers(-3, 4, (g, f, c, h, w)), 0, 255)
    curs[:, -1] = rng.integers(0, 256, (g, c, h, w))
    return refs, curs.astype(np.uint8)


def _interior(bs, reach):
    """The least multiple of bs with a block whose window lies inside."""
    c0 = -(-reach // bs) * bs
    return -(-(c0 + max(reach, bs) + bs) // bs) * bs


@pytest.mark.parametrize("name", [f"G{i}" for i in range(1, 10)])
def test_plain_search_matches_jax(rng, name):
    (bs, reach, step, c), _ = GEOMETRIES[name]
    h = w = _interior(bs, reach)
    refs, curs = _frames(rng, 1, 2, c, h, w)
    kw = dict(bs=bs, reach=reach, step=step)
    got = motion.motion_search_gops(torch.from_numpy(curs),
                                    torch.from_numpy(refs), **kw)
    want = np.asarray(jmotion.motion_search_gops(
        jnp.asarray(curs, jnp.int32), jnp.asarray(refs, jnp.int32),
        backend="xla", **kw))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).any()


def _warp_min(v):
    """__shfl_down_sync min over each warp of 32 lanes: a lane whose source
    is past the warp keeps its own value; lane 0 holds the result."""
    v = v.reshape(-1, 32).copy()
    for o in (16, 8, 4, 2, 1):
        src = np.concatenate([v[:, o:], v[:, 32 - o:]], axis=1)
        v = np.minimum(v, src)
    return v[:, 0]


def _direct_block(cur, ref, bi, bj, plan, th, sh, sent, order):
    """sad_search_direct_kernel for one block and frame: the static check
    first, then every thread's running key over its strided candidates in
    `order` (a permutation of the flat candidates), the warp minimum and
    the minimum over the warps -> (dx, dy)."""
    bs, k, step = plan.bs, plan.k, plan.step
    c, h, w = cur.shape
    ci, cj = bi * bs, bj * bs
    lo_i, hi_i = max(ci - plan.reach, 0), min(ci + plan.reach, h)
    lo_j, hi_j = max(cj - plan.reach, 0), min(cj + plan.reach, w)
    blk = cur[:, ci:ci + bs, cj:cj + bs].astype(np.int64)
    stat = np.maximum(ref[:, ci:ci + bs, cj:cj + bs] - blk, 0).sum()
    if stat <= th:
        return 0, 0
    threads = min(-(-k * k // 32) * 32, 1024)
    keys = np.full(threads, sent + (1 << sh) - 1, dtype=np.int64)
    for n, cand in enumerate(order):
        ki, kj = divmod(int(cand), k)
        pi, pj = lo_i + step * ki, lo_j + step * kj
        if pi + bs < hi_i and pj + bs < hi_j:
            sad = int(((ref[:, pi:pi + bs, pj:pj + bs] - blk) & 255).sum())
            t = n % threads
            keys[t] = min(keys[t], (sad << sh) + int(cand) + 1)
    best = min(int(_warp_min(keys).min()), sent)
    if best >= sent:
        return -cj, -ci
    ki, kj = divmod((best & ((1 << sh) - 1)) - 1, k)
    return lo_j + step * kj - cj, lo_i + step * ki - ci


@pytest.mark.parametrize("kind", ["random", "flat"])
@pytest.mark.parametrize("geometry", [(8, 12, 2, 3, 1100), (6, 9, 1, 1, 0),
                                      (4, 5, 3, 2, 300)])
def test_direct_form_emulation_matches_plain(rng, kind, geometry):
    """Thread by thread in flat order, and in two random orders: the same
    vectors as the plain search (a flat frame ties every candidate, so the
    first in row-major order must win whatever the order)."""
    bs, reach, step, c, th = geometry
    h, w = 5 * bs, 6 * bs
    if kind == "flat":                   # nothing static, every SAD c*bs*bs
        refs = np.full((1, c, h, w), 77, np.uint8)
        curs = np.full((1, 1, c, h, w), 76, np.uint8)
        th = -1
    else:
        refs, curs = _frames(rng, 1, 1, c, h, w)
    want = motion.motion_search_plain(torch.from_numpy(curs),
                                      torch.from_numpy(refs), bs=bs,
                                      reach=reach, step=step,
                                      static_threshold=th)[0, 0].numpy()
    plan = motion.make_plan(h, w, bs, reach, step)
    sh, sent = motion.key_packing(plan, c)
    cur, ref = curs[0, 0].astype(np.int64), refs[0].astype(np.int64)
    orders = [np.arange(plan.k ** 2)] + [rng.permutation(plan.k ** 2)
                                         for _ in range(2)]
    for order in orders:
        got = np.array([[_direct_block(cur, ref, bi, bj, plan, th, sh, sent,
                                       order)
                         for bj in range(plan.nbw)] for bi in range(plan.nbh)])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["random", "flat"])
def test_key_minimum_in_any_order(rng, kind):
    """The packed keys of one block: a running minimum over threads, warps
    and any order of the candidates is the whole minimum, which is the
    first minimum of the SADs in row-major order."""
    k, sh = 64, (64 * 64 + 1).bit_length()
    sad = (rng.integers(0, 2000, k * k) if kind == "random"
           else np.full(k * k, 500))
    keys = (sad << sh) + np.arange(1, k * k + 1)
    whole = keys.min()
    assert (whole & ((1 << sh) - 1)) - 1 == int(np.argmin(sad))
    for _ in range(3):
        order = rng.permutation(k * k)
        lanes = np.full(1024, np.iinfo(np.int64).max)
        for n, cand in enumerate(order):
            lanes[n % 1024] = min(lanes[n % 1024], keys[cand])
        assert _warp_min(lanes).min() == whole


def _encode_both(config_of, frames):
    """Both encoders on `frames`, each with `config_of(its CodecConfig)`."""
    port = Encoder(config_of(CodecConfig), device="cpu",
                   gop_batch=2).encode_frames(frames)
    jvid = JaxEncoder(config_of(JaxConfig), gop_batch=2).encode_frames(frames)
    return port, jvid


def test_encoder_full_search_matches_jax(rng):
    """production(intra_qstep=24) at reach 32, step 1 (K = 64): vectors,
    coefficients and the intra payload identical."""
    frames = _clip(rng, 4, 80, 96)
    port, jvid = _encode_both(lambda cls: cls.production(
        intra_qstep=24, search_reach=32, search_step=1), frames)
    assert_same_stream(port, jvid, torch.int16)
    for a, b in zip(port.gops, jvid.gops):
        for f in ("i_qcoef", "i_modes", "i_escape"):
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          np.asarray(getattr(b, f)))
    assert any(g.mv.any() for g in port.gops), "search found no motion"


def test_encoder_block_32_matches_jax(rng):
    """bs 32 without the DCT at the reference's sweep rule (reach 64, step
    11): vectors and wrap residuals identical."""
    frames = _clip(rng, 4, 160, 192)
    port, jvid = _encode_both(lambda cls: cls(
        block_size=32, with_dct=False, search_reach=64, search_step=11),
        frames)
    assert_same_stream(port, jvid, port.gops[0].residuals.dtype)
    assert any(g.mv.any() for g in port.gops), "search found no motion"
