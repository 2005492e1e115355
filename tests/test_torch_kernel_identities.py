"""The integer identities that the K2 and K5 CUDA kernels of
vcs_h264_tpu_torch rely on, held on the CPU with numpy from a seed:

  * K2 (`csrc/motion_sad.cu`) takes four byte differences in one 32-bit word:
    `wrap_sad4` and `sat_sad4` below repeat its `wrap_sad4` / `sat_sad4`
    operation for operation in uint32;
  * K5 (`csrc/intra_wavefront.cu`) divides by multiplication with the magic
    number of `ops.intra_cuda.quant_magic`, the routine the wrapper itself
    calls at every launch;
  * K2 decides "static" before it searches, so the vectors may not depend on
    the candidate SADs of a static block.
"""

import numpy as np
import jax.numpy as jnp
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu.ops import motion as jmotion  # noqa: E402

from vcs_h264_tpu_torch.ops import intra, motion  # noqa: E402
from vcs_h264_tpu_torch.ops.intra_cuda import quant_magic  # noqa: E402

HIGH = np.uint32(0x80808080)
CORNERS = (0, 1, 127, 128, 255)


def _bytes(words):
    return words.view(np.uint8).reshape(-1, 4).astype(np.int64)


def _byte_sum(words):
    """`__dp4a(word, 0x01010101, 0)`: the sum of the four unsigned bytes."""
    return sum((words >> np.uint32(s)) & np.uint32(255)
               for s in (0, 8, 16, 24)).astype(np.int64)


def wrap_sad4(a, b):
    """The kernel's word step: b enters as (b & ~H, ~b & H)."""
    b_low, nb_high = b & ~HIGH, ~b & HIGH
    t = (a | HIGH) - b_low               # uint32 arithmetic, wraps like the card's
    m = (a & HIGH) ^ nb_high
    return _byte_sum(t ^ m)


def sat_sad4(a, b):
    t = (a | HIGH) - (b & ~HIGH)
    d = t ^ ((a ^ ~b) & HIGH)
    ge = ((a & ~b) | (~(a ^ b) & t)) & HIGH
    return _byte_sum(d & ((ge >> np.uint32(7)) * np.uint32(255)))


def _words(kind, rng):
    if kind == "corners":            # every pair of corner bytes in every lane
        vals = np.array(CORNERS, dtype=np.uint8)
        a, b = np.meshgrid(vals, vals, indexing="ij")
        a, b = a.reshape(-1), b.reshape(-1)
        lanes = []
        for lane in range(4):        # the pair in one lane, corners around it
            for fill in CORNERS:
                wa = np.full((a.size, 4), fill, dtype=np.uint8)
                wb = np.full((a.size, 4), 255 - fill, dtype=np.uint8)
                wa[:, lane], wb[:, lane] = a, b
                lanes.append((wa, wb))
        a = np.concatenate([x for x, _ in lanes])
        b = np.concatenate([y for _, y in lanes])
    else:
        a = rng.integers(0, 256, (200_000, 4), dtype=np.uint8)
        b = rng.integers(0, 256, (200_000, 4), dtype=np.uint8)
        if kind == "near":           # differences around 0 and the wrap
            b = (a.astype(np.int64) + rng.integers(-2, 3, a.shape)) \
                .clip(0, 255).astype(np.uint8)
    return (np.ascontiguousarray(a).view(np.uint32).reshape(-1),
            np.ascontiguousarray(b).view(np.uint32).reshape(-1))


@pytest.mark.parametrize("kind", ["random", "near", "corners"])
def test_packed_wrapping_difference_sums_like_bytes(rng, kind):
    a, b = _words(kind, rng)
    want = ((_bytes(a) - _bytes(b)) & 255).sum(axis=1)
    np.testing.assert_array_equal(wrap_sad4(a, b), want)


@pytest.mark.parametrize("kind", ["random", "near", "corners"])
def test_packed_saturating_difference_sums_like_bytes(rng, kind):
    a, b = _words(kind, rng)
    want = np.maximum(_bytes(a) - _bytes(b), 0).sum(axis=1)
    np.testing.assert_array_equal(sat_sad4(a, b), want)


def test_packed_sad_of_a_block_matches_the_plain_search_terms(rng):
    """48 words of a 3 x 8 x 8 block accumulate to the plain wrapping SAD and
    the plain static SAD of that block."""
    ref = rng.integers(0, 256, (1, 3, 8, 8), dtype=np.uint8)
    cur = rng.integers(0, 256, (1, 1, 3, 8, 8), dtype=np.uint8)
    a = ref.reshape(-1).view(np.uint32)
    b = cur.reshape(-1).view(np.uint32)
    plain_wrap = int(motion.tile_sums(
        (torch.from_numpy(ref).to(torch.int16)
         - torch.from_numpy(cur[0]).to(torch.int16)) & 255, 8).sum())
    plain_sat = int(motion.static_sad(torch.from_numpy(cur),
                                      torch.from_numpy(ref)[:, None], 8).sum())
    assert int(wrap_sad4(a, b).sum()) == plain_wrap
    assert int(sat_sad4(a, b).sum()) == plain_sat


# --- K5: division by multiplication -----------------------------------------

MAX_NUMERATOR = 36 * 255 * 25        # |Cf X Cf^T| <= 36 * 255, times 400 G <= 25


def _magic_quant(n, qstep):
    """K5's iround_quant in uint64 numpy: the high 32 bits of the product,
    shifted."""
    magic, shift = quant_magic(qstep)
    assert 0 < magic < 2**32 and 0 <= shift < 32
    m = np.abs(n).astype(np.uint64)
    num = np.uint64(2) * m + np.uint64(400 * qstep)
    assert int(num.max()) < 2**25
    v = ((num * np.uint64(magic)) >> np.uint64(32)) >> np.uint64(shift)
    return np.sign(n) * v.astype(np.int64)


def _check_magic(qstep):
    n = np.arange(-MAX_NUMERATOR, MAX_NUMERATOR + 1, dtype=np.int64)
    want = intra._iround_div(torch.from_numpy(n), 400 * qstep).numpy()
    np.testing.assert_array_equal(_magic_quant(n, qstep), want)


@pytest.mark.parametrize("qstep", [1, 2, 3, 24, 255, 4096, 65535])
def test_magic_division_equals_iround_div(qstep):
    _check_magic(qstep)


@settings(max_examples=30, deadline=None)
@given(st.integers(min_value=1, max_value=65535))
def test_magic_division_equals_iround_div_any_qstep(qstep):
    _check_magic(qstep)


@pytest.mark.parametrize("qstep", [1, 24, 65535])
def test_magic_division_is_exact_below_two_to_the_25(rng, qstep):
    """The bound the routine states: every n < 2**25, not only the
    numerators the transform can produce."""
    magic, shift = quant_magic(qstep)
    n = np.concatenate([rng.integers(0, 2**25, 500_000),
                        np.arange(2**25 - 70_000, 2**25),
                        800 * qstep * np.arange(1, 2**25 // (800 * qstep) + 1)[:50_000],
                        800 * qstep * np.arange(1, 2**25 // (800 * qstep) + 1)[:50_000] - 1]
                       ).astype(np.uint64)
    got = (n * np.uint64(magic)) >> np.uint64(32 + shift)
    np.testing.assert_array_equal(got, n // np.uint64(800 * qstep))


# --- K2: static first ---------------------------------------------------------


def _clip(kind, rng, g, f, h, w):
    base = rng.uniform(0, 255, (g, 3, h // 8 + 2, w // 8 + 2))
    refs = torch.nn.functional.interpolate(
        torch.from_numpy(base), size=(h, w), mode="bilinear",
        align_corners=False).clamp(0, 255).round().to(torch.uint8).numpy()
    still = np.broadcast_to(refs[:, None], (g, f, 3, h, w))
    noise = rng.integers(-3, 4, (g, f, 3, h, w))
    moved = np.clip(np.roll(still, (2, -3), axis=(-2, -1)) + noise, 0, 255)
    if kind == "static":
        curs = still
    elif kind == "moving":
        curs = moved
    else:                            # frames alternate, halves differ
        curs = moved.copy()
        curs[:, 0::2] = np.clip(still[:, 0::2] + noise[:, 0::2], 0, 255)
        curs[..., : w // 2] = still[..., : w // 2]
    return refs, np.ascontiguousarray(curs).astype(np.uint8)


def _search_static_first(curs, refs, static_threshold):
    """The word kernel's order: decide "static" first, never look at the
    candidates of a static block (their SADs are blanked here), override
    nothing afterwards."""
    plan = motion.make_plan(curs.shape[-2], curs.shape[-1], 8, 16, 3)
    stat = motion.static_sad(curs, refs[:, None], 8) <= static_threshold
    sad = motion.sad_candidates(curs, refs, plan)
    sad[stat] = 0
    mv = motion.select_mvs(sad, curs, refs, plan, -1)     # -1: no override
    return torch.where(stat[..., None], torch.zeros_like(mv), mv)


@pytest.mark.parametrize("th", [0, 666, 2000, 16320])
@pytest.mark.parametrize("kind", ["static", "moving", "mixed"])
def test_static_decision_before_the_search_changes_nothing(rng, kind, th):
    refs, curs = _clip(kind, rng, 2, 3, 48, 64)
    tc, tr = torch.from_numpy(curs), torch.from_numpy(refs)
    want = motion.motion_search_plain(tc, tr, static_threshold=th)
    got = _search_static_first(tc, tr, th)
    assert torch.equal(got, want)
    jax_mv = np.asarray(jmotion.motion_search_gops(
        jnp.asarray(curs, jnp.int32), jnp.asarray(refs, jnp.int32),
        backend="xla", static_threshold=th))
    np.testing.assert_array_equal(got.numpy(), jax_mv)
    if kind == "mixed" and th in (666, 2000):
        frac = float((motion.static_sad(tc, tr[:, None], 8) <= th).float().mean())
        assert 0.0 < frac < 1.0          # both branches are exercised
