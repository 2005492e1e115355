"""The identities that the K1 to K6 CUDA kernels of vcs_h264_tpu_torch rely
on, held on the CPU with numpy from a seed:

  * K2 (`csrc/motion_sad.cu`) takes four byte differences in one 32-bit word:
    `wrap_sad4` and `sat_sad4` below repeat its `wrap_sad4` / `sat_sad4`
    operation for operation in uint32;
  * K5 (`csrc/intra_wavefront.cu`) divides by multiplication with the magic
    number of `ops.intra_cuda.quant_magic`, the routine the wrapper itself
    calls at every launch, and takes the form `ops.intra_cuda.encode_form`
    names from the plane's height: the staged form's row warps, the tall
    form's or the direct form, as the source's constants bound them;
  * K2 decides "static" before it searches, so the vectors may not depend on
    the candidate SADs of a static block;
  * K6 (`csrc/intra_wavefront.cu`, the clipped form) predicts with K5's
    `predict_all`, all nine modes as packed rows, and selects the mode's rows;
    adds the residual and clips two pixels at a time in 16-bit halves; takes
    the residual clamped to [-255, 255]; and lets two warps write finished
    groups of blocks out on a schedule that is arithmetic on the step
    number: `packed_predictors`, `add_clip_rows` and `flush_schedule` below
    repeat the kernel's expressions;
  * K4 (`csrc/inter_fused.cu`) runs each 8-point pass in one thread's
    registers in the order `ops/dct.py` sums in, cuts an 8-byte reference row
    out of aligned words, and exchanges values between the passes through a
    skewed shared buffer that no access pattern may hit with a bank conflict;
  * K3 (`csrc/inter_fused.cu`) is K4's strip run forwards: the RCT on a row's
    pixels, the two passes in a column's and a row's thread, the true division
    and the eight results' low 16 bits packed two to a word;
  * K1's fast form (`csrc/motion_comp.cu`) writes 16-byte words whose source
    rows it cuts out of aligned 32-bit words, the shift being one per block;
    `ops.motion_cuda.compensate_form` decides which shapes and operands take
    it;
  * the bare-plane K3/K4 and K7 (`csrc/inter_plane.cu`) run K3/K4's strip on
    one or two planes without the RCT: the passes, the true division and the
    packed store on a bare plane's .5 ties, the reference row of a thread at
    cells of 8 (`load_row8`) and of 4 (two vectors in one 16-byte read, two
    4-byte runs at their own shifts), the exchange buffer of NC planes, the
    wrappers' alignment checks; `strip_kernel` is the whole kernel, CTA by
    CTA, held against the references in tests/test_torch_c420.py.
"""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu.ops import motion as jmotion  # noqa: E402

from vcs_h264_tpu_torch.ops import dct, inter_cuda, intra, motion  # noqa: E402
from vcs_h264_tpu_torch.ops import intra_cuda, motion_cuda, quant  # noqa: E402
from vcs_h264_tpu_torch.sass_report import count_listing  # noqa: E402
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


# --- K5: the form by block rows ----------------------------------------------

WAVEFRONT_SRC = (Path(intra_cuda.__file__).resolve().parents[1] / "csrc"
                 / "intra_wavefront.cu")


def _source_constants():
    """The `constexpr int` constants of csrc/intra_wavefront.cu, evaluated
    in order with C's integer division."""
    out = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);",
                                 WAVEFRONT_SRC.read_text()):
        out[name] = eval(expr.replace("/", "//"), {"min": min}, dict(out))
    return out


@pytest.mark.parametrize("nbh,row_warps", [
    (1, 1), (180, 6), (256, 8), (257, 9), (268, 9), (272, 9),
    (intra_cuda.TALL_ENCODE_ROWS, 9), (intra_cuda.TALL_ENCODE_ROWS + 1, 0)])
def test_k5_form_by_block_rows(nbh, row_warps):
    """Up to 256 block rows the staged form with a thread per block row in
    ceil(nbh / 32) row warps, as before the tall form; 257 to 282 (1072,
    1080 and 1088 pixel rows among them) the tall form's 9; past it the
    direct form, 0."""
    assert intra_cuda.encode_form(4 * nbh) == row_warps
    assert intra_cuda.encode_form(4 * nbh + 3) == row_warps


def test_k5_forms_match_the_source():
    """The rule's limits are the launcher's: the staged form's row warps in
    a CTA of kEncThreads, the tall form's kTallRowWarps and kTallRows, the
    block rows whose carry and staged outputs fit in kSmemMax bytes, which
    is the wrappers' shared memory; a tall plane's rows fit its threads."""
    c = _source_constants()
    assert intra_cuda.STAGED_ENCODE_ROWS == 32 * c["kEncRowWarps"] == 256
    assert intra_cuda.TALL_ENCODE_ROWS == c["kTallRows"] == 282
    assert c["kTallRows"] <= 32 * c["kTallRowWarps"]
    assert c["kSmemMax"] == intra_cuda._SHMEM_MAX
    assert c["kTallRows"] * 4 * (c["kEncRowWords"] + c["kStageWords"]) \
        <= c["kSmemMax"]
    assert intra_cuda.encode_form(4 * c["kTallRows"]) == c["kTallRowWarps"]
    assert c["kTallThreads"] == 32 * (c["kTallRowWarps"] + c["kFlushWarps"])


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


# --- K6: packed predictors ---------------------------------------------------

M32 = 0xffffffff


def _pk(a, b, c, d):
    return (a | (b << 8) | (c << 16) | (d << 24)) & M32


def _rep4(v):
    return (v * 0x01010101) & M32


def _byte(w, k):
    return (w >> (8 * k)) & 255


def _funnel_r(lo, hi, shift):
    """`__funnelshift_r(lo, hi, shift)`: the low word of (hi:lo) >> shift."""
    return (((hi << 32) | lo) >> (shift & 31)) & M32


def _f3(a, b, c):
    return (a >> 2) + (b >> 1) + (c >> 2)


def _f2(a, b):
    return (a >> 1) + (b >> 1)


def _w3(x, wrap):
    return np.where(wrap, (3 * x) & 255, 3 * x)


def packed_predictors(U, L, UR, ul, a_u, a_l, a_ur):
    """`predict_all` of the kernel, expression for expression, on int64
    arrays: packed neighbours -> p[mode][row] packed rows."""
    u0, u1, u2, u3 = (_byte(U, k) for k in range(4))
    l0, l1, l2, l3 = (_byte(L, k) for k in range(4))
    r0, r1, r2, r3 = (_byte(UR, k) for k in range(4))
    p = [[None] * 4 for _ in range(9)]
    p[0] = [U] * 4
    p[1] = [_rep4(l0), _rep4(l1), _rep4(l2), _rep4(l3)]
    v = [u0 + l0, u1 + l1, u2 + l2, u3 + l3]
    s = np.where(a_u & a_l, sum(x & 255 for x in v), sum(v))
    p[2] = [_rep4(s >> 3)] * 4
    t6 = (r2 >> 2) + (_w3(r3, a_ur) >> 2)
    lo = _pk(_f3(u0, u1, u2), _f3(u1, u2, u3), _f3(u2, u3, r0), _f3(u3, r0, r1))
    hi = _pk(_f3(r0, r1, r2), _f3(r1, r2, r3), t6, 0)
    p[3] = [lo] + [_funnel_r(lo, hi, 8 * r) for r in range(1, 4)]
    d0, d1 = _f3(l1, l2, l3), _f3(l0, l1, l2)
    d2 = (u0 >> 2) + (l0 >> 1) + (l1 >> 2)
    d3 = (ul >> 2) + (u0 >> 1) + (l0 >> 2)
    d4, d5, d6 = _f3(ul, u0, u1), _f3(u0, u1, u2), _f3(u1, u2, u3)
    ulu = (u0 >> 2) + (ul >> 1) + (l0 >> 2)
    lo, hi = _pk(d0, d1, d2, d3), _pk(d4, d5, d6, 0)
    p[4] = [_funnel_r(lo, hi, 8 * (3 - r)) for r in range(3)] + [lo]
    a = _pk(_f2(ul, u0), _f2(u0, u1), _f2(u1, u2), _f2(u2, u3))
    b = _pk(ulu, d4, d5, d6)
    p[5] = [a, b, ((a << 8) & M32) | _f3(ul, l0, l1), ((b << 8) & M32) | d1]
    r0w = _pk(_f2(ul, l0), ulu, d4, d5)
    r1w = ((r0w << 16) & M32) | _pk(_f2(l0, l1), _f3(ul, l1, l2), 0, 0)
    r2w = ((r1w << 16) & M32) | _pk(_f2(l1, l2), d1, 0, 0)
    p[6] = [r0w, r1w, r2w, ((r2w << 16) & M32) | _pk(_f2(l2, l3), d0, 0, 0)]
    a = _pk(_f2(u0, u1), _f2(u1, u2), _f2(u2, u3), _f2(u3, r0))
    b = _pk(d5, d6, _f3(u2, u3, r0), _f3(u3, r0, r1))
    p[7] = [a, b, (a >> 8) | (_f2(r0, r1) << 24), (b >> 8) | (_f3(r0, r1, r2) << 24)]
    b2, b3 = _f2(l2, l3), (l2 >> 2) + (_w3(l3, a_l) >> 2)
    r0w = _pk(_f2(l0, l1), d1, _f2(l1, l2), d0)
    p[8] = [r0w, (r0w >> 16) | _pk(0, 0, b2, b3), _pk(b2, b3, l3, l3), _rep4(l3)]
    return p


def _neighbour_cases(rng, n):
    """n random neighbourhoods for each of the availability cases a block
    can meet, filled as the kernel fills them: 128 where a neighbour is
    missing, ur = u[3] four times without an upper-right block."""
    out = []
    for a_u, a_l, a_ur in ((0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 0, 1),
                           (1, 1, 0), (1, 1, 1)):
        u = rng.integers(0, 256, (n, 4)) if a_u else np.full((n, 4), 128)
        l = rng.integers(0, 256, (n, 4)) if a_l else np.full((n, 4), 128)
        ul = rng.integers(0, 256, n) if a_u and a_l else np.full(n, 128)
        ur = rng.integers(0, 256, (n, 4)) if a_ur \
            else np.repeat(u[:, 3:], 4, axis=1)
        # the corners that make the wraps bite
        u[: n // 4], l[: n // 8] = np.minimum(u[: n // 4] | 0xc0, 255), 255
        if not a_u:
            u[:] = 128
        if not a_l:
            l[:] = 128
        if not a_ur:
            ur = np.repeat(u[:, 3:], 4, axis=1)
        out.append((u, l, ul, ur, np.full(n, bool(a_u)), np.full(n, bool(a_l)),
                    np.full(n, bool(a_ur))))
    return [np.concatenate(x) for x in zip(*out)]


def _pack4(x):
    return _pk(x[:, 0], x[:, 1], x[:, 2], x[:, 3])


@pytest.mark.parametrize("mode", range(9))
def test_packed_predictor_rows_equal_the_plain_predictors(rng, mode):
    u, l, ul, ur, a_u, a_l, a_ur = _neighbour_cases(rng, 400)
    want = intra._preds9(*(torch.from_numpy(x.astype(np.int32))
                           for x in (u, l, ul, ur)),
                         *(torch.from_numpy(x) for x in (a_u, a_l, a_ur))
                         )[mode].numpy()
    assert want.min() >= 0 and want.max() <= 255     # a byte holds each
    p = packed_predictors(_pack4(u), _pack4(l), _pack4(ur), ul, a_u, a_l,
                          a_ur)
    got = np.stack([np.stack([_byte(p[mode][r], c) for c in range(4)], -1)
                    for r in range(4)], 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", [-128, -3, -1, 0, 4, 8, 9, 12, 127])
def test_selected_rows_are_the_modes_or_zero(rng, mode):
    """The kernel's select, `sel = mode == m ? p[m][rr] : sel` from zero,
    against `_pick`: a mode outside 0..8 (an escape enters as -1) predicts
    zero."""
    u, l, ul, ur, a_u, a_l, a_ur = _neighbour_cases(rng, 50)
    p = packed_predictors(_pack4(u), _pack4(l), _pack4(ur), ul, a_u, a_l,
                          a_ur)
    preds = intra._preds9(*(torch.from_numpy(x.astype(np.int32))
                            for x in (u, l, ul, ur)),
                          *(torch.from_numpy(x) for x in (a_u, a_l, a_ur)))
    n = u.shape[0]
    want = intra._pick(preds, torch.full((n,), mode, dtype=torch.int32),
                       torch.zeros(n, dtype=torch.bool)).numpy()
    for rr in range(4):
        sel = np.zeros(n, dtype=np.int64)
        for m in range(9):
            sel = np.where(mode == m, p[m][rr], sel)
        got = np.stack([_byte(sel, c) for c in range(4)], -1)
        np.testing.assert_array_equal(got, want[:, rr])


# --- K6: add and clip in 16-bit halves ---------------------------------------


def _byte_perm(x, y, sel):
    """`__byte_perm(x, y, sel)`: byte i of the result is byte sel[i] of the
    eight bytes (y:x)."""
    both = (y << 32) | x
    out = 0
    for i in range(4):
        out = out | (((both >> (8 * ((sel >> (4 * i)) & 7))) & 255) << (8 * i))
    return out


def _halves(w):
    """The two signed 16-bit halves of a word."""
    lo, hi = w & 0xffff, (w >> 16) & 0xffff
    return (np.where(lo >= 0x8000, lo - 0x10000, lo),
            np.where(hi >= 0x8000, hi - 0x10000, hi))


def _word(lo, hi):
    return (lo & 0xffff) | ((hi & 0xffff) << 16)


def _viaddmin_relu(a, b, c):
    """`__viaddmin_s16x2_relu`: max(min(a + b, c), 0) in each half."""
    (a0, a1), (b0, b1), (c0, c1) = _halves(a), _halves(b), _halves(c)
    return _word(np.maximum(np.minimum(a0 + b0, c0), 0),
                 np.maximum(np.minimum(a1 + b1, c1), 0))


def add_clip_rows(sel, ra, rb):
    """The kernel's reconstruction of one row: prediction bytes `sel`,
    residual halves (ra: pixels 0, 1; rb: pixels 2, 3) -> packed bytes."""
    lo = _viaddmin_relu(_byte_perm(sel, 0, 0x4140), ra, 0x00ff00ff)
    hi = _viaddmin_relu(_byte_perm(sel, 0, 0x4342), rb, 0x00ff00ff)
    return _byte_perm(lo, hi, 0x6420)


@pytest.mark.parametrize("lane", range(4))
def test_packed_add_and_clip_on_every_byte_and_residual(lane):
    """All 256 x 511 pairs of a predicted byte and a residual in [-255,
    255] in one lane, the other lanes at their corners."""
    pred, res = np.meshgrid(np.arange(256), np.arange(-255, 256),
                            indexing="ij")
    pred, res = pred.reshape(-1), res.reshape(-1)
    for other_p, other_r in ((0, -255), (255, 255), (0, 255), (255, -255)):
        p4 = np.full((pred.size, 4), other_p, dtype=np.int64)
        r4 = np.full((pred.size, 4), other_r, dtype=np.int64)
        p4[:, lane], r4[:, lane] = pred, res
        got = add_clip_rows(_pack4(p4), _word(r4[:, 0], r4[:, 1]),
                            _word(r4[:, 2], r4[:, 3]))
        want = np.clip(p4 + r4, 0, 255)
        np.testing.assert_array_equal(
            np.stack([_byte(got, c) for c in range(4)], -1), want)


@pytest.mark.parametrize("bound", [255, 256, 32767, 2**28])
def test_clamped_residual_reconstructs_the_same_pixel(bound):
    """clip(p + r) == clip(p + clamp(r, -255, 255)) for a prediction in
    0..255: what lets the residual travel as a clamped int16."""
    p = np.arange(256)[:, None]
    r = np.concatenate([np.arange(-300, 301), [-bound, bound, 1 - bound,
                                               bound - 1]])[None, :]
    np.testing.assert_array_equal(
        np.clip(p + r, 0, 255), np.clip(p + np.clip(r, -255, 255), 0, 255))


# --- K6: the flush schedule --------------------------------------------------

GROUP, FLUSH_WARPS = 8, 2


def flush_schedule(nbh, nbw, t, flusher):
    """The (row, group, blocks) a flush warp writes out in step t: the
    kernel's arithmetic, line for line."""
    out = []
    tp = t - 1
    s = tp if tp & 1 else tp - 1
    if s >= GROUP - 1:
        top = (s - (GROUP - 1)) // 2
        j_lo = (top - nbh + 4) // 4 if top >= nbh else 0
        j_hi = min(top // 4, nbw // GROUP - 1)
        j = j_lo + 2 * (tp - s) + flusher
        while j <= j_hi:
            out.append((top - 4 * j, j, GROUP))
            j += 2 * FLUSH_WARPS
    twice = tp - (nbw - 1)
    if flusher == 0 and nbw % GROUP and twice >= 0 and not twice & 1 \
            and twice // 2 < nbh:
        out.append((twice // 2, nbw // GROUP, nbw % GROUP))
    return out


@pytest.mark.parametrize("nbh,nbw", [
    (1, 1), (1, 2), (2, 1), (2, 2), (1, 8), (1, 9), (3, 7), (5, 9), (2, 16),
    (7, 24), (12, 2), (40, 3), (66, 2), (33, 17), (90, 160), (180, 320),
    (268, 480), (270, 480), (282, 480), (288, 2), (288, 40)])
def test_flush_writes_every_block_once_before_it_is_overwritten(nbh, nbw):
    """Simulates the clipped decode's steps, and K5's (268 and 282 block
    rows: its tall form at the 1080p cells' luma and at its last row
    count): row threads stage block (bi,
    t - 2 bi) in one of their row's two group tiles, the flush warps write
    groups out in the same step without a barrier between them. Every block
    must leave exactly once, as the block it is, and no tile may be written
    by its row in a step in which it is flushed."""
    steps = 2 * (nbh - 1) + nbw
    stage = np.full((nbh, 2, GROUP), -1, dtype=np.int64)
    written = np.zeros((nbh, nbw), dtype=np.int64)
    for t in range(steps + 2):
        staged_now = set()
        rows = np.arange(nbh)
        bj = t - 2 * rows
        live = (bj >= 0) & (bj < nbw)
        for bi, j in zip(rows[live], bj[live]):
            staged_now.add((int(bi), int(j // GROUP) & 1))
        for flusher in range(FLUSH_WARPS):
            for row, j, n in flush_schedule(nbh, nbw, t, flusher):
                assert 0 <= row < nbh and 0 <= j * GROUP < nbw
                assert (row, j & 1) not in staged_now
                np.testing.assert_array_equal(
                    stage[row, j & 1, :n],
                    row * nbw + GROUP * j + np.arange(n))
                written[row, GROUP * j:GROUP * j + n] += 1
        stage[rows[live], (bj[live] // GROUP) & 1, bj[live] % GROUP] = \
            rows[live] * nbw + bj[live]
    np.testing.assert_array_equal(written, 1)


# --- K4: one thread's passes, the reference row, the exchange buffer ---------


def register_idct(x, d):
    """K4's two passes on float32 blocks [..., 8, 8]: the thread of column k
    forms T[i][k] = sum_j D[j][i] X[j][k], the thread of row i forms Z[i][l]
    = sum_k T[i][k] D[k][l], each from acc = 0 by acc = acc + d * x with
    every product and sum rounded to float32, j and k ascending."""
    x, d = x.astype(np.float32), d.astype(np.float32)
    t = np.zeros_like(x)
    for i in range(8):
        acc = np.zeros(x.shape[:-2] + (8,), dtype=np.float32)
        for j in range(8):
            acc = acc + d[j, i] * x[..., j, :]
        t[..., i, :] = acc
    z = np.zeros_like(x)
    for l in range(8):
        acc = np.zeros(x.shape[:-2] + (8,), dtype=np.float32)
        for k in range(8):
            acc = acc + t[..., :, k] * d[k, l]
        z[..., :, l] = acc
    return z


@pytest.mark.parametrize("kind", ["coded", "dense", "extreme"])
def test_register_passes_equal_idct2_blocks(rng, kind):
    if kind == "coded":              # sparse dequantised coefficients
        x = rng.integers(-40, 41, (500, 8, 8)) * (rng.random((500, 8, 8)) < .1)
        x = x * rng.integers(1, 100, (8, 8))
    elif kind == "dense":
        x = rng.integers(-2000, 2001, (500, 8, 8))
    else:
        x = rng.choice([-32767.0 * 255, 32767.0 * 255, 0.0], (500, 8, 8))
    x = x.astype(np.float32)
    d = dct.dct_matrix_np(8).astype(np.float32)
    want = dct.idct2_blocks(torch.from_numpy(x)).numpy()
    got = register_idct(x, d)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def load_row8(words, byte_at):
    """K4's `load_row8`: the 8 bytes from `byte_at` on, out of aligned
    32-bit words; the third word is read only where the bytes reach it."""
    s = byte_at & 3
    w = byte_at >> 2
    a, b = int(words[w]), int(words[w + 1])
    c = int(words[w + 2]) if s else 0
    return _funnel_r(a, b, 8 * s), _funnel_r(b, c, 8 * s)


@pytest.mark.parametrize("offset", range(8))
def test_shifted_words_give_the_row_at_every_byte_offset(rng, offset):
    """Rows of 24 bytes; a source block may start at any byte up to W - 8,
    and the last start must not read past the row."""
    row = rng.integers(0, 256, 24, dtype=np.uint8)
    words = row.view(np.uint32)
    for start in range(offset, 24 - 8 + 1, 8):
        lo, hi = load_row8(words, start)       # IndexError = read past the row
        got = [_byte(lo, k) for k in range(4)] + [_byte(hi, k) for k in range(4)]
        assert got == row[start:start + 8].tolist()


STRIP, K_STRIDE = 16, 8 * 16 + 4


def _exchange_at(b, row, k):
    return k * K_STRIDE + row * STRIP + b


@pytest.mark.parametrize("side", ["rows write or read", "columns read or write"])
def test_exchange_buffer_has_no_bank_conflict(side):
    """The 32 lanes of every warp, in every one of its accesses, fall on 32
    different banks: as (block, row) threads, tid = row * 16 + block, with k
    fixed an instruction; as (block, column) threads, tid = block * 8 + k,
    with the row fixed. And no two values share a word."""
    cells = {_exchange_at(b, r, k) for b in range(STRIP) for r in range(8)
             for k in range(8)}
    assert len(cells) == STRIP * 64 and max(cells) < 8 * K_STRIDE
    for warp in range(4):
        tids = np.arange(32 * warp, 32 * warp + 32)
        for fixed in range(8):
            if side.startswith("rows"):
                at = _exchange_at(tids % STRIP, tids // STRIP, fixed)
            else:
                at = _exchange_at(tids // 8, fixed, tids % 8)
            assert len(set((at % 32).tolist())) == 32


# --- K3: the RCT, one thread's passes, the quotient, the packed store ---------


def register_rct(resid):
    """K3's RCT on float32 residuals [..., 3, 8, 8] (B, G, R planes), each
    product and sum rounded to float32 in the kernel's order."""
    c = np.float32
    rb, rg, rr = (resid[..., i, :, :].astype(np.float32) for i in range(3))
    yy = (c(0.299) * rr + c(0.587) * rg) + c(0.114) * rb
    return np.stack([yy, (rr - yy) * c(0.713), (rb - yy) * c(0.564)], -3)


def register_dct(x, d):
    """K3's two passes on float32 blocks [..., 8, 8]: the thread of column k
    forms T[i][k] = sum_j D[i][j] X[j][k], the thread of row i forms Z[i][l]
    = sum_k T[i][k] D[l][k], each from acc = 0 by acc = acc + d * x with
    every product and sum rounded to float32, j and k ascending."""
    x, d = x.astype(np.float32), d.astype(np.float32)
    t = np.zeros_like(x)
    for i in range(8):
        acc = np.zeros(x.shape[:-2] + (8,), dtype=np.float32)
        for j in range(8):
            acc = acc + d[i, j] * x[..., j, :]
        t[..., i, :] = acc
    z = np.zeros_like(x)
    for l in range(8):
        acc = np.zeros(x.shape[:-2] + (8,), dtype=np.float32)
        for k in range(8):
            acc = acc + t[..., :, k] * d[l, k]
        z[..., :, l] = acc
    return z


def pack_int16_pairs(v):
    """Eight int32 [..., 8] -> four uint32 words [..., 4], the low 16 bits of
    each, the even one in the low half: what K3 stores."""
    u = v.astype(np.int64) & 0xffff
    return (u[..., 0::2] | (u[..., 1::2] << 16)).astype(np.uint32)


def _residual_blocks(kind, rng, n=400):
    if kind == "residual":           # what a good prediction leaves
        return rng.integers(-12, 13, (n, 3, 8, 8))
    if kind == "dense":
        return rng.integers(-255, 256, (n, 3, 8, 8))
    # the largest residual on every channel: whole blocks and checkerboards
    sign = rng.choice([-1, 1], (n, 1, 8, 8))
    sign[: n // 4] = rng.choice([-1, 1], (n // 4, 1, 1, 1))
    return np.broadcast_to(255 * sign, (n, 3, 8, 8)).copy()


@pytest.mark.parametrize("kind", ["residual", "dense", "extreme"])
def test_encode_register_passes_equal_dct2_blocks(rng, kind):
    resid = _residual_blocks(kind, rng)
    ycc = register_rct(resid)
    assert ycc.dtype == np.float32
    want_ycc = inter_cuda.signed_bgr_to_ycc(
        torch.from_numpy(resid).to(torch.float32))
    np.testing.assert_array_equal(ycc, want_ycc.numpy())
    got = register_dct(ycc, dct.dct_matrix_np(8).astype(np.float32))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, dct.dct2_blocks(want_ycc).numpy())


@pytest.mark.parametrize("qf", [1.0, 50.0, 99.0])
@pytest.mark.parametrize("kind", ["residual", "dense", "extreme"])
def test_encode_chain_in_thread_ownership_equals_the_plain_coding(rng, kind,
                                                                  qf):
    """RCT, passes, true division, round half to even and the packed store
    against `dct_compress_residual_signed` on the same blocks; quality 1
    gives tables of 255 throughout, quality 99 tables of 1 and 2."""
    resid = _residual_blocks(kind, rng, 200)
    qy, qc = (t.astype(np.float32) for t in quant.quant_tables_np(qf))
    if qf == 1.0:
        assert qy.max() == 255 and qc.max() == 255
    if qf == 99.0:
        assert qy.min() == 1 and qc.min() == 1
    z = register_dct(register_rct(resid), dct.dct_matrix_np(8))
    q = np.rint(z / np.stack([qy, qc, qc])).astype(np.int32)
    words = pack_int16_pairs(q)                      # [n, 3, 8 rows, 4 words]
    got = words.view(np.int16).reshape(q.shape)
    planes = torch.from_numpy(resid).permute(1, 0, 2, 3).reshape(3, -1, 8)
    want = inter_cuda.dct_compress_residual_signed(planes, qf)
    np.testing.assert_array_equal(
        got, want.reshape(3, -1, 8, 8).permute(1, 0, 2, 3).numpy())


def test_packed_pairs_keep_the_low_sixteen_bits_of_every_value():
    """The packed store equals a cast to int16 (which truncates, never
    saturates) for every int32 the conversion can return in +-70 000, at
    each of the eight places of a row."""
    v = np.arange(-70_000, 70_001, dtype=np.int32)
    v = np.concatenate([v, [-2**31, 2**31 - 1]]).astype(np.int32)
    v = np.resize(v, (v.size // 8 + 1) * 8)
    for roll in range(8):
        row = np.roll(v, roll).reshape(-1, 8)
        np.testing.assert_array_equal(
            pack_int16_pairs(row).view(np.int16).reshape(row.shape),
            row.astype(np.int16))


# --- K1: the fast form's addresses and the wrapper's choice of form ------------


def _place_origin(o, extent, bs):
    if o < 0:
        o += extent
    return min(max(o, 0), extent - bs)


def _load_shifted(words, w, s, nw):
    """`load_shifted<NW>`: NW words from s bytes into aligned word w; the
    word after them is read only where the bytes reach into it. A read past
    the tensor is an IndexError."""
    assert w >= 0
    v = [int(words[w + i]) for i in range(nw)] + [int(words[w + nw]) if s
                                                  else 0]
    return [_funnel_r(v[i], v[i + 1], 8 * s) for i in range(nw)]


def fast_compensate(mv, refs, bs):
    """K1's fast form, thread by thread: a thread owns 16 output bytes of a
    block row, places its 16 / bs blocks once, and for every row and channel
    writes one 16-byte word cut out of aligned source words. `refs` is the
    whole tensor as one buffer: nothing past it can be read."""
    g_n, f_n, nbh, nbw, _ = mv.shape
    _, c_n, h, w = refs.shape
    words = np.ascontiguousarray(refs).reshape(-1).view(np.uint32)
    plane = h * w
    out = np.zeros((g_n, f_n, c_n, h, w), dtype=np.uint8)
    n_blocks, n_words = 16 // bs, bs // 4
    for g in range(g_n):
        for f in range(f_n):
            for bi in range(nbh):
                for xq in range(w // 16):
                    src = []
                    for b in range(n_blocks):
                        bj = xq * n_blocks + b
                        dx, dy = (int(v) for v in mv[g, f, bi, bj])
                        i0 = _place_origin(bi * bs + dy, h, bs)
                        j0 = _place_origin(bj * bs + dx, w, bs)
                        at = g * c_n * plane + i0 * w + j0
                        src.append((at >> 2, at & 3))
                    for c in range(c_n):
                        for r in range(bs):
                            row = []
                            for word, s in src:
                                row += _load_shifted(
                                    words, word + (c * plane + r * w) // 4, s,
                                    n_words)
                            out[g, f, c, bi * bs + r, 16 * xq:16 * xq + 16] = \
                                np.array(row, dtype=np.uint32).view(np.uint8)
    return out


def _compensate_edge_vectors(rng, g, f, h, w, bs):
    """Source origins at every byte shift next to each edge (the last row
    and the last columns of the tensor among them), far outside, and at the
    int32 extremes."""
    nbh, nbw = h // bs, w // bs
    rows = (0, 1, h - bs - 1, h - bs, h - bs + 1, -1, -h - 3, 3 * h)
    cols = (0, 1, 2, 3, w - bs - 3, w - bs - 2, w - bs - 1, w - bs,
            w - bs + 1, -1, -bs, -w - 3, 3 * w)
    cases = [(oj, oi) for oi in rows for oj in cols]
    n = rng.permutation(g * f * nbh * nbw).reshape(g, f, nbh, nbw)
    o = np.array(cases, dtype=np.int64)[n % len(cases)]
    o[..., 0] -= np.arange(nbw) * bs
    o[..., 1] -= np.arange(nbh)[:, None] * bs
    o.reshape(-1, 2)[::11] = rng.choice(
        [-2**31, 2**31 - 1, -2**31 + 5, 2**31 - 9], (o.reshape(-1, 2)[::11]
                                                      .shape))
    return o.astype(np.int32)


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("bs,h,w", [(4, 8, 16), (4, 12, 48), (8, 16, 16),
                                    (8, 24, 48), (16, 16, 16), (16, 32, 48)])
def test_fast_compensation_words_equal_the_plain_gather(rng, bs, h, w, c):
    g, f = 2, 8
    refs = rng.integers(0, 256, (g, c, h, w), dtype=np.uint8)
    for mv in (_compensate_edge_vectors(rng, g, f, h, w, bs),
               rng.integers(-3 * w, 3 * w + 1, (g, f, h // bs, w // bs, 2))
               .astype(np.int32)):
        want = motion.motion_compensate_plain(
            torch.from_numpy(mv), torch.from_numpy(refs), bs=bs)
        got = fast_compensate(mv, refs, bs)   # IndexError = read past the tensor
        np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("bs", [4, 8, 16])
def test_fast_compensation_reads_the_last_row_at_every_byte_shift(rng, bs):
    """Every block of the only frame reads the last rows of the tensor's last
    plane, its source starting 0 to bs bytes before the last possible start:
    the shifts 1, 2, 3 reach into the tensor's last word and not past it."""
    h, w = bs, 32
    refs = rng.integers(0, 256, (1, 2, h, w), dtype=np.uint8)
    for back in range(bs + 1):
        mv = np.zeros((1, 1, 1, w // bs, 2), dtype=np.int32)
        mv[..., 0] = (w - bs - back) - np.arange(w // bs) * bs
        got = fast_compensate(mv, refs, bs)
        want = np.tile(refs[:, None, :, :, w - bs - back:w - back],
                       (1, 1, 1, 1, w // bs))
        np.testing.assert_array_equal(got, want)
    with pytest.raises(IndexError):       # the emulation does catch an overrun
        _load_shifted(refs.reshape(-1).view(np.uint32), refs.size // 4 - 1, 1,
                      1)


FAST, GENERAL = motion_cuda.FORM_FAST, motion_cuda.FORM_GENERAL


@pytest.mark.parametrize("bs,w,refs_ptr,out_ptr,want", [
    (8, 1280, 0x7000_0000, 0x7100_0000, FAST),     # reference mode, B luma
    (4, 640, 0x7000_0000, 0x7100_0000, FAST),      # 4:2:0 B chroma
    (16, 1280, 0x7000_0000, 0x7100_0000, FAST),
    (4, 16, 0x7000_0004, 0x7100_0010, FAST),
    (8, 48, 0x7000_0000, 0x7100_0000, FAST),
    (8, 1296, 0x7000_0000, 0x7100_0000, FAST),
    (2, 1280, 0x7000_0000, 0x7100_0000, GENERAL),  # block sizes
    (6, 1296, 0x7000_0000, 0x7100_0000, GENERAL),
    (32, 1280, 0x7000_0000, 0x7100_0000, GENERAL),
    (8, 40, 0x7000_0000, 0x7100_0000, GENERAL),    # rows no multiple of 16
    (4, 36, 0x7000_0000, 0x7100_0000, GENERAL),
    (8, 1288, 0x7000_0000, 0x7100_0000, GENERAL),
    (8, 1280, 0x7000_0001, 0x7100_0000, GENERAL),  # refs off a word
    (8, 1280, 0x7000_0002, 0x7100_0000, GENERAL),
    (8, 1280, 0x7000_0003, 0x7100_0000, GENERAL),
    (8, 1280, 0x7000_0000, 0x7100_0004, GENERAL),  # out off 16 bytes
    (8, 1280, 0x7000_0000, 0x7100_0008, GENERAL),
    (16, 1280, 0x7000_0000, 0x7100_0001, GENERAL),
])
def test_compensate_form_by_block_size_width_and_alignment(bs, w, refs_ptr,
                                                           out_ptr, want):
    assert motion_cuda.compensate_form(bs, w, refs_ptr, out_ptr) == want


@pytest.mark.parametrize("form,gf,h,w,bs,fits", [
    (FAST, 24, 720, 1280, 8, True),
    (FAST, 70_000, 720, 1280, 8, True),        # frames are not on grid z
    (GENERAL, 70_000, 720, 1280, 8, False),
    (GENERAL, 65_535, 720, 1280, 8, True),
    (GENERAL, 2, 65_536, 16, 8, False),        # pixel rows on grid y
    (FAST, 2, 65_536, 16, 8, True),
    (FAST, 1, 32_768, 65_536, 8, False),       # int32 offsets in a plane
    (GENERAL, 1, 32_768, 65_536, 8, False),
    (FAST, 2**31, 16, 4096, 4, False),         # more CTAs than grid x has
])
def test_compensate_grid_limits(form, gf, h, w, bs, fits):
    assert motion_cuda.compensate_grid_fits(form, gf, h, w, bs) is fits


# --- the bare-plane K3/K4 and K7: the strip on one or two planes ---------------


def _tie_blocks(rng, q00, n=300):
    """Small integer residual blocks whose sum is 4 Q00 (2m + 1): the DC
    term sum / 8 / Q00 lands on m + 1/2."""
    m = rng.integers(-2, 2, n)
    target = 4 * q00 * (2 * m + 1)
    x = rng.integers(-2, 3, (n, 64))
    x -= x.sum(1, keepdims=True) // 64
    base, rem = np.divmod(target - x.sum(1), 64)
    x += base[:, None] + (np.arange(64)[None, :] < rem[:, None])
    return x.reshape(n, 8, 8)


def _plane_blocks(kind, rng, q, n=300):
    if kind == "ties":
        return _tie_blocks(rng, int(q[0, 0]), n)
    if kind == "dense":
        x = rng.integers(-255, 256, (n, 8, 8))
        x[: n // 4] = 255 * rng.choice([-1, 1], (n // 4, 8, 8))
        return x
    return None


@pytest.mark.parametrize("qf", [1.0, 50.0, 99.0])
@pytest.mark.parametrize("table", ["luma", "chroma"])
@pytest.mark.parametrize("kind", ["ties", "dense", "extreme"])
def test_bare_plane_chain_in_thread_ownership_equals_the_plain_coding(
        rng, kind, table, qf):
    """The encode: float(cur - pred), the passes, the true division, round
    half to even and the packed int16 store, against `code_planes`; the
    decode: coef * Q, the transposed passes, round half to even, + pred and
    the clip, against `decode_planes`. "ties": residuals whose DC quotient
    is an exact .5 (asserted to occur), "dense": +-255, "extreme":
    coefficients at +-32767 (decode only)."""
    q = quant.quant_tables_np(qf)[table == "chroma"].astype(np.float32)
    d = dct.dct_matrix_np(8).astype(np.float32)
    resid = _plane_blocks(kind, rng, q)
    if resid is None:
        coef = rng.choice([-32767, 32767, 0, 1, -1], (300, 8, 8))
    else:
        z = register_dct(resid.astype(np.float32), d)
        quot = z / q
        assert quot.dtype == np.float32
        if kind == "ties":
            assert (np.abs(quot - np.floor(quot)) == 0.5).sum() >= 100
        words = pack_int16_pairs(np.rint(quot).astype(np.int32))
        coef = words.view(np.int16).reshape(resid.shape)
        want = inter_cuda.code_planes(
            torch.from_numpy(resid).reshape(-1, 8), torch.from_numpy(q))
        np.testing.assert_array_equal(coef, want.reshape(-1, 8, 8).numpy())
    coef = coef.astype(np.int16)
    x = coef.astype(np.float32) * q
    got = np.rint(register_idct(x, d)).astype(np.int64)
    want = inter_cuda.decode_planes(
        torch.from_numpy(coef).reshape(-1, 8), torch.from_numpy(q))
    np.testing.assert_array_equal(got, want.reshape(-1, 8, 8).numpy())
    pred = rng.integers(0, 256, coef.shape)
    np.testing.assert_array_equal(
        np.minimum(np.maximum(pred + got, 0), 255),
        (torch.from_numpy(pred) + want.reshape(-1, 8, 8)).clamp(0, 255)
        .numpy())


def strip_reference_rows(mv, refs, cell):
    """`predicted_rows` of csrc/inter_plane.cu, thread by thread: the thread
    of (block, row) reads its block's vector as one 8-byte word (cells of 8)
    or the two vectors under its row as one 16-byte word (cells of 4),
    places each source origin once, and cuts its 8 reference bytes of each
    plane out of aligned 32-bit words: one `load_row8`, or two
    `_load_shifted` runs of 4 bytes at their own shifts. `refs` and `mv`
    are read as whole buffers: a read past either is an IndexError.
    Returns the predicted planes [G, F, C, H, W]."""
    g_n, f_n, nmh, nmw, _ = mv.shape
    _, c_n, h, w = refs.shape
    words = np.ascontiguousarray(refs).reshape(-1).view(np.uint32)
    vec = np.ascontiguousarray(mv).reshape(-1)
    plane = h * w
    out = np.zeros((g_n, f_n, c_n, h, w), dtype=np.uint8)

    def read(at, n):                 # one aligned word of n int32
        assert at % n == 0
        return [int(vec[at + i]) for i in range(n)]

    for g in range(g_n):
        for f in range(f_n):
            gf = g * f_n + f
            for bi in range(h // 8):
                for bj in range(w // 8):
                    for row in range(8):
                        base = g * c_n * plane
                        if cell == 8:
                            dx, dy = read(((gf * nmh + bi) * nmw + bj) * 2, 2)
                            at = base + (_place_origin(bi * 8 + dy, h, 8)
                                         + row) * w \
                                + _place_origin(bj * 8 + dx, w, 8)
                            runs = [load_row8(words, at + c * plane)
                                    for c in range(c_n)]
                        else:
                            mi, r = 2 * bi + row // 4, row % 4
                            dxa, dya, dxb, dyb = read(
                                ((gf * nmh + mi) * nmw + 2 * bj) * 2, 4)
                            at = [base + (_place_origin(mi * 4 + dy, h, 4) + r)
                                  * w + _place_origin(8 * bj + o + dx, w, 4)
                                  for o, dx, dy in ((0, dxa, dya),
                                                    (4, dxb, dyb))]
                            runs = [[_load_shifted(words, (a + c * plane) >> 2,
                                                   a & 3, 1)[0] for a in at]
                                    for c in range(c_n)]
                        for c, (lo, hi) in enumerate(runs):
                            out[g, f, c, bi * 8 + row, bj * 8:bj * 8 + 8] = \
                                np.array([lo, hi], np.uint32).view(np.uint8)
    return out


@pytest.mark.parametrize("cell,c", [(8, 1), (4, 2)])
@pytest.mark.parametrize("h,w", [(8, 16), (16, 48), (24, 136)])
def test_strip_reference_rows_equal_the_plain_gather(rng, cell, c, h, w):
    g, f = 2, 3
    refs = rng.integers(0, 256, (g, c, h, w), dtype=np.uint8)
    # origins at every byte shift next to the last column and row, before
    # every edge, far outside, at the int32 extremes; and random vectors
    for mv in (_compensate_edge_vectors(rng, g, f, h, w, cell),
               rng.integers(-3 * w, 3 * w + 1,
                            (g, f, h // cell, w // cell, 2)).astype(np.int32)):
        want = motion.motion_compensate_gops(
            torch.from_numpy(mv), torch.from_numpy(refs), bs=cell,
            backend="plain")
        np.testing.assert_array_equal(strip_reference_rows(mv, refs, cell),
                                      want.numpy())


@pytest.mark.parametrize("cell,c", [(8, 1), (4, 2)])
def test_strip_reference_rows_read_the_last_bytes_at_every_shift(rng, cell, c):
    """Every cell of the only frame reads the last row of the last plane,
    its source starting 0 to 8 bytes before the last possible start: the
    shifts 1, 2, 3 reach into the tensor's last word and not past it."""
    h, w = 8, 32
    refs = rng.integers(0, 256, (1, c, h, w), dtype=np.uint8)
    for back in range(9):
        mv = np.zeros((1, 1, h // cell, w // cell, 2), dtype=np.int32)
        mv[..., 0] = (w - cell - back) - np.arange(w // cell) * cell
        mv[..., 1] = (h - cell) - np.arange(h // cell)[:, None] * cell
        got = strip_reference_rows(mv, refs, cell)
        want = np.tile(refs[:, None, :, h - cell:, w - cell - back:w - back],
                       (1, 1, 1, h // cell, w // cell))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nc", [1, 2, 3])
def test_exchange_planes_keep_the_bank_pattern(nc):
    """NC planes of the exchange buffer, kPlaneWords = 8 * (16 * 8 + 4)
    floats apart (4.2, 8.4 and 12.7 KB): a plane starts on a multiple of 32
    words, so every plane's accesses fall on the banks of the first plane's,
    which `test_exchange_buffer_has_no_bank_conflict` holds free of
    conflicts, and no two values of any plane share a word."""
    plane_words = 8 * K_STRIDE
    assert plane_words % 32 == 0
    assert nc * plane_words * 4 == (4224, 8448, 12672)[nc - 1]
    cells = {c * plane_words + _exchange_at(b, r, k) for c in range(nc)
             for b in range(STRIP) for r in range(8) for k in range(8)}
    assert len(cells) == nc * STRIP * 64 and max(cells) < nc * plane_words
    tids = np.arange(32)
    for c in range(nc):
        for fixed in range(8):
            for at in (_exchange_at(tids % STRIP, tids // STRIP, fixed),
                       _exchange_at(tids // 8, fixed, tids % 8)):
                banks = (c * plane_words + at) % 32
                np.testing.assert_array_equal(banks, at % 32)
                assert len(set(banks.tolist())) == 32


@pytest.mark.parametrize("counter", ["plane_encode", "plane_decode",
                                     "c420_encode", "c420_decode"])
def test_alignment_check_refuses_views_off_the_boundary(counter):
    """Each operand the strip kernels read or write in wide words: a view one
    byte (and half the alignment) off its boundary is refused, an aligned
    one taken."""
    buf = torch.zeros(256, dtype=torch.uint8)
    base = (-buf.data_ptr()) % 16                  # a 16-byte boundary
    want = {"mv": 16 if counter.startswith("c420") else 8, "refs": 4,
            "curs": 8, "coeffs": 16, "out": 8 if counter.endswith("decode")
            else 16}
    entries = inter_cuda._ALIGNMENTS[counter]
    assert [a for a, _ in entries] == ["mv", "curs" if counter.endswith(
        "encode") else "coeffs", "refs", "out"]
    for arg, align in entries:
        assert align == want[arg]
        inter_cuda._check_aligned(counter, arg, buf[base:], align)
        inter_cuda._check_aligned(counter, arg, buf[base + align:], align)
        for off in (1, align // 2):
            with pytest.raises(ValueError,
                               match=f"{arg} must start on a {align}-byte"):
                inter_cuda._check_aligned(counter, arg, buf[base + off:],
                                          align)


_LISTING = """
\tcode for sm_90a
\t\tFunction : _Z4kernA
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;     /* 0x00000a00ff017b82 */
                                                              /* 0x000fe20000000800 */
        /*0010*/              @!P0 BRA 0xd0 ;                 /* 0x00000000000c8947 */
        /*0020*/               @P0 IADD3 R3, R3, -UR7, RZ ;   /* 0x8000000703030c10 */
        /*0030*/                   FMUL R2, R2, UR4 ;         /* 0x0000000402027c20 */
        /*0040*/                   EXIT ;                     /* 0x000000000000794d */
        /*0050*/                   NOP;                       /* 0x0000000000007918 */
\t\tFunction : _Z4kernB
        /*0000*/                   STG.E.128 desc[UR4][R2.64], R4 ;  /* 0x0000000402007986 */
        /*0010*/                   NOP;                       /* 0x0000000000007918 */
"""


def test_sass_listing_counts_every_instruction_of_each_kernel():
    """`sass_report.count_listing`, which PERF.md's instruction counts come
    from: one count per instruction line, predicates and encodings not
    counted as opcodes, NOPs left out."""
    counts = count_listing(_LISTING)
    assert counts == {"_Z4kernA": {"LDC": 1, "BRA": 1, "IADD3": 1, "FMUL": 1,
                                   "EXIT": 1},
                      "_Z4kernB": {"STG.E.128": 1}}


def strip_kernel(mv, refs, data, qf, cell, decode):
    """`plane_encode_kernel` / `plane_decode_kernel` of csrc/inter_plane.cu,
    CTA by CTA, in numpy float32: each CTA of 128 threads takes 16 blocks
    of one block row and all planes; the row threads (tid = row * 16 +
    block) fill a NaN-initialised exchange buffer at `_exchange_at` with the
    residual or the dequantised row, the column threads (tid = block * 8 +
    k) read it, form T and write it back after all have read, the row
    threads form Z and quantise and pack, or round, add the predicted row
    and clip. Threads of blocks past the plane's last do nothing. The
    reference rows come from `strip_reference_rows`; the luma table for one
    plane, the chroma table for two."""
    g_n, f_n, nc, h, w = data.shape
    nbh, nbw = h // 8, w // 8
    d = dct.dct_matrix_np(8).astype(np.float32)
    q = quant.quant_tables_np(qf)[nc == 2].astype(np.float32)
    pred = strip_reference_rows(mv, refs, cell).astype(np.int32)
    out = np.zeros(data.shape, np.uint8 if decode else np.int16)
    tid = np.arange(STRIP * 8)
    blk, row, cb, kk = tid % STRIP, tid // STRIP, tid // 8, tid % 8

    def coef(a, b):                  # dct_at<kInverse>
        return d[b, a] if decode else d[a, b]

    for g in range(g_n):
        for f in range(f_n):
            for bi in range(nbh):
                for bj0 in range(0, nbw, STRIP):
                    xs = np.full((nc, 8 * K_STRIDE), np.nan, np.float32)
                    ra, ca = bj0 + blk < nbw, bj0 + cb < nbw
                    rb, rr = blk[ra], row[ra]
                    y, x0 = bi * 8 + rr, (bj0 + rb) * 8
                    for c in range(nc):
                        for k in range(8):
                            v = data[g, f, c, y, x0 + k]
                            xs[c, _exchange_at(rb, rr, k)] = (
                                v.astype(np.float32) * q[rr, k] if decode
                                else (v.astype(np.int32)
                                      - pred[g, f, c, y, x0 + k])
                                .astype(np.float32))
                    cols, ks = cb[ca], kk[ca]
                    for c in range(nc):
                        x = [xs[c, _exchange_at(cols, j, ks)] for j in range(8)]
                        tt = []
                        for i in range(8):
                            acc = np.zeros(cols.size, np.float32)
                            for j in range(8):
                                acc = acc + coef(i, j) * x[j]
                            tt.append(acc)
                        for i in range(8):
                            xs[c, _exchange_at(cols, i, ks)] = tt[i]
                    for c in range(nc):
                        x = [xs[c, _exchange_at(rb, rr, k)] for k in range(8)]
                        z = []
                        for l in range(8):
                            acc = np.zeros(rb.size, np.float32)
                            for k in range(8):
                                acc = acc + x[k] * coef(l, k)
                            z.append(acc)
                        z = np.stack(z, -1)                   # [threads, 8]
                        cols8 = x0[:, None] + np.arange(8)
                        if decode:
                            v = pred[g, f, c, y[:, None], cols8] + np.rint(z)
                            out[g, f, c, y[:, None], cols8] = np.clip(v, 0, 255)
                        else:
                            words = pack_int16_pairs(
                                np.rint(z / q[rr]).astype(np.int32))
                            out[g, f, c, y[:, None], cols8] = \
                                words.view(np.int16).reshape(z.shape)
    return out
