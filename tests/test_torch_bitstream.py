"""The host coders of vcs_h264_tpu_torch's `.vcs` container against the JAX
package's on the CPU: every range and exp-Golomb coder byte for byte (the
port's native library, its Python mirror and the JAX package's dispatcher),
the zigzag scan and quantisation, the native build, malformed files, the
writer's refusals, the legacy container versions 3 to 10 and the legacy
unsigned residual (`signed_residual=False`)."""

import os
import struct

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vcs_h264_tpu.config import CodecConfig as JaxConfig  # noqa: E402
from vcs_h264_tpu.io import bitstream as jbits  # noqa: E402
from vcs_h264_tpu.models.decoder import Decoder as JaxDecoder  # noqa: E402
from vcs_h264_tpu.models.encoder import Encoder as JaxEncoder  # noqa: E402
from vcs_h264_tpu.ops import quant as jquant  # noqa: E402

from vcs_h264_tpu_torch import CodecConfig  # noqa: E402
from vcs_h264_tpu_torch.interop import from_jax_video  # noqa: E402
from vcs_h264_tpu_torch.io import bitstream as bits  # noqa: E402
from vcs_h264_tpu_torch.models import Decoder, Encoder  # noqa: E402
from vcs_h264_tpu_torch.ops import _build, intra_cuda, quant  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")

# coder -> (dispatcher, its decoder, Python mirror, mirror's decoder, the
# arguments after the data / after (blob, n))
SIG_GEOM = (2, 3, 4, 4, 16)              # nf, nc, nbh, nbw, block_len
CODERS = {
    "rle": ("rle_encode", "rle_decode", "_py_encode", "_py_decode", ()),
    "rc": ("rc_encode", "rc_decode", "_py_rc_encode_i16",
           "_py_rc_decode_i16", ()),
    "banded16": ("rc_encode_i16_b", "rc_decode_i16_b", "_py_rc_encode_i16_b",
                 "_py_rc_decode_i16_b", (16,)),
    "banded64": ("rc_encode_i16_b", "rc_decode_i16_b", "_py_rc_encode_i16_b",
                 "_py_rc_decode_i16_b", (64,)),
    "cbf16": ("rc_encode_i16_cbf", "rc_decode_i16_cbf",
              "_py_rc_encode_i16_cbf", "_py_rc_decode_i16_cbf", (16,)),
    "cbf64": ("rc_encode_i16_cbf", "rc_decode_i16_cbf",
              "_py_rc_encode_i16_cbf", "_py_rc_decode_i16_cbf", (64,)),
    "sig": ("rc_encode_i16_sig", "rc_decode_i16_sig", "_py_rc_encode_i16_sig",
            "_py_rc_decode_i16_sig", SIG_GEOM),
    "mv": ("rc_encode_mv", "rc_decode_mv", "_py_rc_encode_mv",
           "_py_rc_decode_mv", ()),
}
N_VALUES = int(np.prod(SIG_GEOM))        # 1536: a whole number of blocks


def _data(kind: str, rng) -> np.ndarray:
    if kind == "zeros":
        return np.zeros(N_VALUES, np.int16)
    if kind == "extremes":
        d = rng.choice(np.array([-32767, 32767, -1, 1, 0], np.int16),
                       N_VALUES)
        d[rng.random(N_VALUES) < 0.5] = 0
        return d.astype(np.int16)
    d = rng.integers(-300, 301, N_VALUES).astype(np.int16)
    d[rng.random(N_VALUES) < 0.9] = 0                    # sparse
    return d


def _code_everywhere(enc, dec, py_enc, py_dec, args, data):
    """-> the bytes of the port's dispatcher (native), checked equal to the
    port's mirror and the JAX package's dispatcher, and both decoders
    checked to invert them."""
    blob = getattr(bits, enc)(data, *args)
    assert blob == getattr(bits, py_enc)(data, *args)
    assert blob == getattr(jbits, enc)(data, *args)
    for fn in (getattr(bits, dec), getattr(bits, py_dec)):
        np.testing.assert_array_equal(fn(blob, len(data), *args), data)
    return blob


def test_native_coder_is_loaded():
    assert bits.native_loaded()
    assert bits.load_native() is not None
    path = bits.native_library_path()
    assert path.parent == _build.BUILD and path.exists()


def test_native_build_writes_only_the_port_build_dir(tmp_path, monkeypatch):
    """The coder is built from the package's own source. A fresh build
    lands in the build directory under a temporary name first; the source's
    directory is left as it was. The source is a copy in a directory of the
    test's own, so that its listing holds still; the JAX package's
    `native/` may be written meanwhile by its `make` in another process, so
    there only the absence of the port's library names is checked."""
    import shutil
    assert bits.NATIVE_SRC == _build.CSRC / "bitstream.cpp"
    native = os.path.join(REPO, "native")
    src_dir = tmp_path / "csrc"
    src_dir.mkdir()
    shutil.copy(_build.CSRC / "bitstream.cpp", src_dir)
    monkeypatch.setattr(bits, "NATIVE_SRC", src_dir / "bitstream.cpp")

    def listing():
        return sorted((e.name, e.stat().st_mtime_ns)
                      for e in os.scandir(src_dir))

    before = listing()
    monkeypatch.setattr(bits._build, "BUILD", tmp_path / "build")
    out = bits.native_library_path()
    assert out.parent == tmp_path / "build"
    assert out.name.startswith("libvcsbits_")
    assert bits._build_native() == out
    assert out.exists() and sorted(p.name for p in out.parent.iterdir()) \
        == [out.name]
    assert listing() == before
    assert not [n for n in os.listdir(native) if n.startswith("libvcsbits_")]
    import ctypes
    lib = ctypes.CDLL(str(out))
    for name in bits.NATIVE_SIGNATURES:
        assert hasattr(lib, name), name


def test_failed_native_build_warns_and_falls_back(tmp_path, monkeypatch):
    """A source that does not compile: load_native warns with the
    compiler's message and returns None, so the mirror codes the bytes."""
    src = tmp_path / "broken.cpp"
    src.write_text("int broken = ;\n")
    monkeypatch.setattr(bits, "NATIVE_SRC", src)
    monkeypatch.setattr(bits._build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(bits, "_LIB", None)
    monkeypatch.setattr(bits, "_LIB_TRIED", False)
    with pytest.warns(RuntimeWarning, match="did not build or load.*broken"):
        assert bits.load_native() is None
    assert not bits.native_loaded()
    data = np.arange(-40, 40, dtype=np.int16)
    assert bits.rc_encode(data) == jbits._py_rc_encode_i16(data)


@pytest.mark.parametrize("kind", ["sparse", "extremes", "zeros"])
@pytest.mark.parametrize("coder", sorted(CODERS))
def test_coder_bytes_match_jax(coder, kind, rng):
    data = _data(kind, rng)
    if coder == "mv" and kind == "sparse":
        data = np.clip(data, -24, 24).astype(np.int16)      # vector range
    _code_everywhere(*CODERS[coder], data)


@pytest.mark.parametrize("nsym", [3, 9])
def test_mode_coders_match_jax(nsym, rng):
    """Mode maps: the v8 prev-symbol coder and the v11 (left, up) coder."""
    rows, cols = 6, 10
    modes = rng.integers(0, nsym, (4, rows, cols)).astype(np.uint8)
    modes[:, :2] = 0                                    # runs of one mode
    flat = modes.ravel()
    _code_everywhere("rc_encode_u8", "rc_decode_u8", "_py_rc_encode_u8",
                     "_py_rc_decode_u8", (nsym,), flat)
    _code_everywhere("rc_encode_modes2d", "rc_decode_modes2d",
                     "_py_rc_encode_modes2d", "_py_rc_decode_modes2d",
                     (rows, cols, nsym), flat)
    assert bits._encode_modes(modes, nsym) == jbits._encode_modes(modes, nsym)
    for version in (7, 8, 11):
        blob = (modes.astype(np.int8).tobytes() if version < 8 else
                bits.rc_encode_u8(flat, nsym) if version < 11 else
                bits._encode_modes(modes, nsym))
        got = bits._decode_modes(blob, modes.shape, nsym, version)
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, modes)
        np.testing.assert_array_equal(
            got, jbits._decode_modes(blob, modes.shape, nsym, version))


@pytest.mark.parametrize("version", [3, 8, 9, 10, 11])
def test_coefficient_planes_match_jax(version, rng):
    """Zigzag per block and the coefficient coder of each container era,
    on a [NF, C, H, W] stack."""
    res = rng.integers(-40, 41, (2, 3, 16, 24)).astype(np.int16)
    res[rng.random(res.shape) < 0.85] = 0
    enc, dec = bits._coeff_codecs(version, 8)
    jenc, _ = jbits._coeff_codecs(version, 8)
    blob = enc(res)
    assert blob == jenc(res)
    got = dec(blob, res.shape)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, res)


# plane stacks of the v11 coder, in blocks of bs: [H, W], [C, H, W],
# [NF, C, H, W] and luma [NP, 1, H, W]
RASTER_LAYOUTS = {
    "HW": lambda bs: (2 * bs, 3 * bs),
    "CHW": lambda bs: (3, bs, 2 * bs),
    "NFCHW": lambda bs: (2, 3, 2 * bs, bs),
    "luma": lambda bs: (3, 1, 2 * bs, 2 * bs),
}


def _planes(kind, shape, rng):
    if kind == "zeros":
        return np.zeros(shape, np.int16)
    if kind == "extremes":
        d = rng.choice(np.array([-32767, 32767, -1, 1, 0], np.int16), shape)
        d[rng.random(shape) < 0.5] = 0
        return d.astype(np.int16)
    d = rng.integers(-300, 301, shape).astype(np.int16)
    d[rng.random(shape) < 0.9] = 0
    return d


@pytest.mark.parametrize("route", ["native", "no native"])
@pytest.mark.parametrize("kind", ["sparse", "extremes", "zeros"])
@pytest.mark.parametrize("layout", RASTER_LAYOUTS)
@pytest.mark.parametrize("bs", [4, 8, 16])
def test_raster_sig_coder(bs, layout, kind, route, rng, monkeypatch):
    """The v11 coder on raster planes: the bytes of the zigzag-stream coder
    on the scanned planes, of its Python mirror and of the JAX package's v11
    coefficient coder; decoded back to the planes as int16. Without the
    native library the wrappers take the scan and the mirror, to the same
    bytes."""
    shape = RASTER_LAYOUTS[layout](bs)
    x = _planes(kind, shape, rng)
    nf, nc = bits._sig_geom(shape)
    geom = (nf, nc, shape[-2] // bs, shape[-1] // bs, bs * bs)
    scanned = bits._zigzag_plane(x, bs)
    want = bits.rc_encode_i16_sig(scanned, *geom)
    assert want == bits._py_rc_encode_i16_sig(scanned, *geom)
    assert want == jbits._coeff_codecs(11, bs)[0](x)
    if route == "no native":
        monkeypatch.setattr(bits, "load_native", lambda: None)
    blob = bits.rc_encode_i16_sig_raster(x, bs)
    assert blob == want
    got = bits.rc_decode_i16_sig_raster(blob, shape, bs)
    assert got.dtype == np.int16 and got.shape == shape
    assert got.flags.c_contiguous
    np.testing.assert_array_equal(got, x)


def _native_raster(name, *args):
    """A raster entry point of the native library called directly."""
    import ctypes
    ptr = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))  # noqa: E731
    lib = bits.load_native()
    data, n, nf, nc, h, w, bs, order = args
    buf = np.zeros(max(8 * n + 16, 1), np.uint8)
    if name == "encode":
        return lib.vcs_rc_encode_i16_sig_raster(
            ptr(data, ctypes.c_int16), n, nf, nc, h, w, bs,
            ptr(order, ctypes.c_int32), ptr(buf, ctypes.c_uint8), len(buf))
    out = np.zeros(max(n, 1), np.int16)
    return lib.vcs_rc_decode_i16_sig_raster(
        ptr(buf, ctypes.c_uint8), len(buf), ptr(out, ctypes.c_int16), n,
        nf, nc, h, w, bs, ptr(order, ctypes.c_int32))


# case -> (H, W, bs, the order table's change) of a geometry that does not
# fit, or the bytes cut off a valid blob
RASTER_MISFITS = {
    "rows": (20, 16, 8, None), "cols": (16, 12, 8, None),
    "bs 1": (4, 4, 1, None), "bs 128": (128, 128, 128, None),
    "order out of range": (16, 16, 8, 64), "order negative": (16, 16, 8, -1),
}
RASTER_CUTS = {"last byte off": lambda b: b[:-1],
               "two bytes off": lambda b: b[:-2],
               "half": lambda b: b[:len(b) // 2],
               "first 5 bytes": lambda b: b[:5], "empty": lambda b: b""}


@pytest.mark.parametrize("case", [*RASTER_MISFITS, *RASTER_CUTS])
def test_raster_sig_coder_refuses(case, rng, monkeypatch):
    """Planes that bs x bs blocks do not tile and order tables that do not
    index a block: the wrappers raise ValueError and the native entry points
    return -2. A blob cut short raises ValueError in the native decoder and
    the mirror: the encoder's flush leaves every byte its decoder reads."""
    if case in RASTER_MISFITS:
        h, w, bs, bad = RASTER_MISFITS[case]
        x = np.ones((2, h, w), np.int16)
        order = np.arange(bs * bs, dtype=np.int32)
        if bad is None:
            with pytest.raises(ValueError):
                bits.rc_encode_i16_sig_raster(x, bs)
            with pytest.raises(ValueError):
                bits.rc_decode_i16_sig_raster(b"\0" * 16, x.shape, bs)
        else:
            order[-1] = bad
        for name in ("encode", "decode"):
            assert _native_raster(name, x, x.size, 1, 2, h, w, bs,
                                  order) == -2
        return
    shape = (2, 3, 16, 24)
    x = _planes("sparse", shape, rng)
    blob = bits.rc_encode_i16_sig_raster(x, 8)
    short = RASTER_CUTS[case](blob)
    assert len(short) < len(blob)
    with pytest.raises(ValueError):
        bits.rc_decode_i16_sig_raster(short, shape, 8)
    monkeypatch.setattr(bits, "load_native", lambda: None)
    with pytest.raises(ValueError):
        bits.rc_decode_i16_sig_raster(short, shape, 8)


@pytest.mark.parametrize("bs", [4, 8, 16])
def test_zigzag_and_quantize_match_jax(bs, rng):
    np.testing.assert_array_equal(quant.zigzag_order_np(bs),
                                  jquant.zigzag_order_np(bs))
    blocks = rng.integers(-500, 500, (2, 3, bs, bs)).astype(np.float32)
    want = np.asarray(jquant.zigzag(jnp.asarray(blocks)))
    got = quant.zigzag(torch.from_numpy(blocks))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(quant.zigzag(blocks), want)
    np.testing.assert_array_equal(quant.unzigzag(got).numpy(), blocks)
    np.testing.assert_array_equal(quant.unzigzag(want), blocks)
    q = rng.integers(1, 100, (bs, bs)).astype(np.float32)
    for rounded in (False, True):
        want_q = np.asarray(jquant.quantize(jnp.asarray(blocks),
                                            jnp.asarray(q), rounded))
        got_q = quant.quantize(torch.from_numpy(blocks), torch.from_numpy(q),
                               rounded)
        np.testing.assert_array_equal(got_q.numpy(), want_q)
        np.testing.assert_array_equal(quant.quantize(blocks, q, rounded),
                                      want_q)
    np.testing.assert_array_equal(
        quant.dequantize(torch.from_numpy(blocks), torch.from_numpy(q))
        .numpy(), np.asarray(jquant.dequantize(jnp.asarray(blocks),
                                               jnp.asarray(q))))


# ---------------------------------------------------------------------------
# malformed input: truncation and lying length fields raise ValueError


def _tiny_vcs(tmp_path, rng):
    frames = [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
              for _ in range(4)]
    video = Encoder(CodecConfig(quant_mode="rounded"),
                    device="cpu").encode_frames(frames)
    path = str(tmp_path / "ok.vcs")
    bits.save_vcs(video, path, device="cpu")
    return path


def test_vcs_rejects_bad_magic(tmp_path):
    p = str(tmp_path / "bad.vcs")
    open(p, "wb").write(b"NOTAVCS0" + b"\x00" * 64)
    with pytest.raises(ValueError):
        bits.load_vcs(p, device="cpu")


def test_vcs_truncations_raise(tmp_path, rng):
    src = open(_tiny_vcs(tmp_path, rng), "rb").read()
    for cut in [4, 8, 30, 52, 60, len(src) // 2, len(src) - 3]:
        p = str(tmp_path / f"cut{cut}.vcs")
        open(p, "wb").write(src[:cut])
        with pytest.raises(ValueError):
            bits.load_vcs(p, device="cpu")


def test_vcs_lying_length_field_raises(tmp_path, rng):
    """Every aligned u32 of the first 256 bytes set huge: a ValueError (or
    a struct range error), or a load as before where the word was not a
    length; never a crash and never an unbounded allocation."""
    src = open(_tiny_vcs(tmp_path, rng), "rb").read()
    raised = 0
    for off in range(8, min(len(src) - 4, 256), 4):
        mod = bytearray(src)
        mod[off:off + 4] = struct.pack("<I", 0x7FFFFFFF)
        p = str(tmp_path / "lying.vcs")
        open(p, "wb").write(mod)
        try:
            bits.load_vcs(p, device="cpu")
        except (ValueError, OverflowError):
            raised += 1
    assert raised > 0


def test_vcs_implausible_dims_raise(tmp_path, rng):
    src = bytearray(open(_tiny_vcs(tmp_path, rng), "rb").read())
    src[12:16] = struct.pack("<I", 1 << 30)      # h = 2^30
    p = str(tmp_path / "dims.vcs")
    open(p, "wb").write(src)
    with pytest.raises(ValueError, match="implausible"):
        bits.load_vcs(p, device="cpu")


def test_vcs_refuses_reference_mode(tmp_path, rng):
    frames = [rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
              for _ in range(4)]
    video = Encoder(CodecConfig(), device="cpu").encode_frames(frames)
    with pytest.raises(ValueError, match="quant_mode='reference'"):
        bits.save_vcs(video, str(tmp_path / "ref.vcs"), device="cpu")
    assert not os.path.exists(tmp_path / "ref.vcs")


@pytest.mark.parametrize("name,own", [("save_vcs", ("device",)),
                                      ("load_vcs", ("device", "backend"))])
def test_signatures_are_the_jax_functions(name, own):
    """The JAX function's parameters first, in its order; the port's own
    keyword-only, the device defaulting to CUDA."""
    import inspect
    mine = list(inspect.signature(getattr(bits, name)).parameters.values())
    theirs = list(inspect.signature(getattr(jbits, name)).parameters)
    assert [p.name for p in mine] == theirs + list(own)
    assert all(p.kind == inspect.Parameter.KEYWORD_ONLY
               for p in mine[len(theirs):])
    assert mine[len(theirs)].default == "cuda"


def test_default_device_without_gpu_raises(tmp_path, rng):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for machines "
                    "without one")
    path = _tiny_vcs(tmp_path, rng)
    video = bits.load_vcs(path, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        bits.load_vcs(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        bits.save_vcs(video, str(tmp_path / "again.vcs"))


# ---------------------------------------------------------------------------
# the legacy containers and the legacy unsigned residual


@pytest.mark.parametrize("version", [3, 4, 5, 6, 7, 8, 9, 10])
def test_legacy_vcs_versions_load(version):
    """The fixtures written by each earlier container version (48x64, 10
    frames; v3/v4 lossless intra, v5 and v8-v10 lossy, v6/v7 4:2:0) load
    in the port and decode on the CPU to the frames stored beside them,
    within the JAX package's own bound (tests/test_bitstream.py)."""
    loaded = bits.load_vcs(os.path.join(FIXTURES, f"legacy_v{version}.vcs"),
                           device="cpu")
    assert loaded.num_frames == 10
    assert loaded.config.signed_residual == (version >= 4)
    got = Decoder(device="cpu").decode(loaded)
    assert len(got) == 10
    with np.load(os.path.join(FIXTURES,
                              f"legacy_v{version}_frames.npz")) as z:
        for i, frame in enumerate(got):
            diff = np.abs(frame.astype(np.int32) - z[f"f{i}"].astype(np.int32))
            assert diff.max() <= 1, f"frame {i}: max |diff| {diff.max()}"
            assert np.mean(diff != 0) < 5e-3, \
                f"frame {i}: {np.mean(diff != 0):.4f} of pixels differ"
    assert intra_cuda.LAUNCHES == {"intra_encode": 0, "intra_decode": 0}


def _legacy_clip(rng, n=10, h=32, w=48):
    base = rng.integers(0, 256, (h + 16, w + 16, 3)).astype(np.int64)
    frames = []
    for t in range(n):
        f = base[t % 3:t % 3 + h, t:t + w] + rng.integers(-3, 4, (h, w, 3))
        frames.append(np.clip(f, 0, 255).astype(np.uint8))
    return frames


def test_unsigned_residual_matches_jax(rng, tmp_path):
    """signed_residual=False (rounded coefficients of the wrap residual):
    the port's encoder against the JAX package's on one clip, vectors
    identical and coefficients identical or within 1 on fewer than 1e-3 of
    them; the decode of one stream within 1 on fewer than 1e-4 of samples.
    The port encodes, decodes and keeps it in .npz; only .vcs refuses it,
    with the JAX package's message."""
    kw = dict(quant_mode="rounded", signed_residual=False)
    frames = _legacy_clip(rng)
    port = Encoder(CodecConfig(**kw), device="cpu",
                   gop_batch=2).encode_frames(frames)
    jvid = JaxEncoder(JaxConfig(**kw), gop_batch=2).encode_frames(frames)
    n_diff = n_all = 0
    for a, b in zip(port.gops, jvid.gops):
        np.testing.assert_array_equal(a.i_frame.numpy(), np.asarray(b.i_frame))
        np.testing.assert_array_equal(a.mv.numpy(), np.asarray(b.mv))
        d = np.abs(a.residuals.numpy().astype(np.int32)
                   - np.asarray(b.residuals).astype(np.int32))
        assert d.max() <= 1
        n_diff += int((d != 0).sum())
        n_all += d.size
    share = n_diff / n_all
    print(f"coefficients that differ: {n_diff} of {n_all} ({share:.2e})")
    assert share < 1e-3

    want = JaxDecoder().decode(jvid)
    got = Decoder(device="cpu").decode(from_jax_video(jvid))
    diff = np.abs(np.stack(got).astype(np.int32) - np.stack(want))
    print(f"decoded samples that differ: {np.mean(diff != 0):.2e}")
    assert diff.max() <= 1 and np.mean(diff != 0) < 1e-4

    port.save_npz(str(tmp_path / "v3.npz"))
    with pytest.raises(ValueError, match="signed_residual=False") as port_err:
        bits.save_vcs(port, str(tmp_path / "v3.vcs"), device="cpu")
    with pytest.raises(ValueError) as jax_err:
        jbits.save_vcs(jvid, str(tmp_path / "v3j.vcs"))
    assert str(port_err.value) == str(jax_err.value)
