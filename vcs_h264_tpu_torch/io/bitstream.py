"""The `.vcs` container with its range-coded streams (counterpart of
`vcs_h264_tpu/io/bitstream.py`), byte for byte the JAX package's format:

  container = header | per-GOP sections
  per GOP:   header | I section (raw planes, lossless intra or lossy intra
             payload), a part per plane group | range-coded MVs |
             range-coded quantized coefficients (zigzag per block) per
             plane group | B section (vectors, modes, a part per group)
  plane groups: 4:4:4 the frame's planes; 4:2:0 luma, then chroma

The entropy coders are host code over numpy. The package's own C++ source,
`vcs_h264_tpu_torch/csrc/bitstream.cpp` (a copy of the JAX package's
`native/bitstream.cpp`, held to its bytes by the tests), is built here with
`g++` into `vcs_h264_tpu_torch/build/` under a name keyed by a hash of the
source and the flags, and loaded through ctypes; its pure-Python mirror,
copied from the JAX package unchanged, codes the same bytes when no compiler
is at hand. `native_loaded()` says which one is in use.

Writing and loading run the per-GOP entropy coding on a thread pool (the C
entry points release the GIL). The loader then decodes the I-frames of up
to GOP_CHUNK GOPs of one plane shape in one call: the lossy-intra payloads
and the lossless-intra residuals are stacked, uploaded to `device` and
decoded by K6 there (`ops/intra_cuda.py`; the plain wavefront on the CPU).
The writer re-encodes lossless-intra I-frames with the plain
`luma4x4_codec` on `device`, GOP_CHUNK GOPs a call, as the JAX package
re-encodes them. Streams come back in host memory, in the dtypes of
`EncodedVideo.load_npz`.

While a profiler records, `save_vcs` and `load_vcs` record the program's
spans (`utils/profiling.py`): the roots `save_vcs` (count `frames`) and
`load_vcs`, the stream's copy to host memory `save_vcs.pull`, every
range coder call `vcs.rc_encode` / `vcs.rc_decode` on whatever thread runs
it, every zigzag scan `vcs.zigzag`, and the loader's phase 3
`load_vcs.intra`; copies to host memory count `d2h_copies` and `d2h_bytes`
on the span open around them. The v11 coefficient coder scans the planes
inside the native coder, whose spans count `zigzag_fused`; `vcs.zigzag`
times the scans of older versions and of the Python mirror.

Versions 3 to 11 load; the writer emits 11. A version-3 stream carries
rounded coefficients of the wrapped (mod-256) residual and loads with
`signed_residual=False`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import os
import struct
import subprocess
import threading
import warnings
from typing import List, Optional

import numpy as np
import torch

from vcs_h264_tpu_torch.config import CodecConfig
from vcs_h264_tpu_torch.models import intra_codec
from vcs_h264_tpu_torch.models.encoder import resolve_device
from vcs_h264_tpu_torch.models.gop import (EncodedGOP, EncodedGOP420,
                                            EncodedVideo)
from vcs_h264_tpu_torch.ops import _build
from vcs_h264_tpu_torch.ops.motion import check_backend
from vcs_h264_tpu_torch.ops.quant import zigzag_order_np
from vcs_h264_tpu_torch.utils.profiling import (add_counts, carry,
                                                trace_annotation, traced)

_MAGIC = b"VCSH264T"
# v4 added per-GOP B-frame sections; v5 adds intra_qstep in the header and a
# per-GOP I-frame type byte (raw / lossless intra / lossy intra); v6 adds the
# 4:2:0 stream layout (header mode bit 8; per-GOP Y + quarter-res chroma
# sections); v7 adds B-frame sections to the 4:2:0 layout; v8 switches every
# entropy-coded stream to the adaptive range coder; v9 conditions the
# coefficient contexts on the zigzag band and gives MV streams their own
# contexts; v10 codes coefficients around a per-block coded-block flag; v11
# replaces them with a significance map on spatial, temporal and
# cross-channel contexts, and codes mode maps with (left, up) pair contexts.
# Older versions still load.
_VERSION = 11

# GOPs whose I planes go to the device in one call: the writer's
# lossless-intra re-encode (whose plain codec stacks nine int32 predictors a
# pixel, about 0.4 GB a 720p GOP) and the loader's intra decode. Bounds the
# device memory of both, whatever the length of the video.
GOP_CHUNK = 16

# ---------------------------------------------------------------------------
# the native coder: built from the package's csrc/bitstream.cpp with g++


NATIVE_SRC = _build.CSRC / "bitstream.cpp"
# the flags of the JAX package's native/Makefile
CXX_FLAGS = ("-O3", "-Wall", "-shared", "-fPIC")

_i16p = ctypes.POINTER(ctypes.c_int16)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64, _i32 = ctypes.c_int64, ctypes.c_int32
# C entry point -> argument types; every one returns an int64 (bytes
# written, values decoded, or < 0 on overflow or a malformed blob).
NATIVE_SIGNATURES = {
    "vcs_rle_encode_i16": (_i16p, _i64, _u8p, _i64),
    "vcs_rle_decode_i16": (_u8p, _i64, _i16p, _i64),
    "vcs_rc_encode_i16": (_i16p, _i64, _u8p, _i64),
    "vcs_rc_decode_i16": (_u8p, _i64, _i16p, _i64),
    "vcs_rc_encode_i16_b": (_i16p, _i64, _i32, _u8p, _i64),
    "vcs_rc_decode_i16_b": (_u8p, _i64, _i32, _i16p, _i64),
    "vcs_rc_encode_i16_cbf": (_i16p, _i64, _i32, _u8p, _i64),
    "vcs_rc_decode_i16_cbf": (_u8p, _i64, _i32, _i16p, _i64),
    "vcs_rc_encode_mv": (_i16p, _i64, _u8p, _i64),
    "vcs_rc_decode_mv": (_u8p, _i64, _i16p, _i64),
    "vcs_rc_encode_u8": (_u8p, _i64, _i32, _u8p, _i64),
    "vcs_rc_decode_u8": (_u8p, _i64, _u8p, _i64, _i32),
    # data, n, nf, nc, nbh, nbw, block_len, out, cap
    "vcs_rc_encode_i16_sig": (_i16p, _i64, _i32, _i32, _i32, _i32, _i32,
                              _u8p, _i64),
    # blob, len, out, n, nf, nc, nbh, nbw, block_len
    "vcs_rc_decode_i16_sig": (_u8p, _i64, _i16p, _i64, _i32, _i32, _i32,
                              _i32, _i32),
    # planes, n, nf, nc, h, w, bs, order, out, cap
    "vcs_rc_encode_i16_sig_raster": (_i16p, _i64, _i32, _i32, _i32, _i32,
                                     _i32, _i32p, _u8p, _i64),
    # blob, len, out, n, nf, nc, h, w, bs, order
    "vcs_rc_decode_i16_sig_raster": (_u8p, _i64, _i16p, _i64, _i32, _i32,
                                     _i32, _i32, _i32, _i32p),
    # data, n, rows, cols, nsym, out, cap
    "vcs_rc_encode_modes2d": (_u8p, _i64, _i32, _i32, _i32, _u8p, _i64),
    # blob, len, out, n, rows, cols, nsym
    "vcs_rc_decode_modes2d": (_u8p, _i64, _u8p, _i64, _i32, _i32, _i32),
}

_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False
_LIB_LOCK = threading.Lock()


def native_library_path():
    return _build.library_file("libvcsbits", CXX_FLAGS, [NATIVE_SRC])


def _build_native():
    """The coder's library, built with g++ where it is not yet."""
    return _build.cached_library(
        "libvcsbits", CXX_FLAGS, [NATIVE_SRC],
        lambda out: subprocess.run(
            ["g++", *CXX_FLAGS, "-o", str(out), str(NATIVE_SRC)],
            check=True, capture_output=True))


def load_native() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the C++ coder; None if unavailable, and
    then the Python mirror codes the same bytes."""
    global _LIB, _LIB_TRIED
    with _LIB_LOCK:
        if _LIB is not None or _LIB_TRIED:
            return _LIB
        _LIB_TRIED = True
        try:
            lib = ctypes.CDLL(str(_build_native()))
            for name, argtypes in NATIVE_SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int64
            _LIB = lib
        except (OSError, subprocess.SubprocessError, AttributeError) as e:
            # no compiler, a failed build, a stale library
            err = getattr(e, "stderr", None)
            warnings.warn(
                f"the .vcs range coder ({NATIVE_SRC}) did not build or load: "
                f"{(err.decode(errors='replace').strip() if err else e)}; "
                "the Python mirror codes the same bytes, far slower",
                RuntimeWarning, stacklevel=2)
            _LIB = None
        return _LIB


def native_loaded() -> bool:
    """True when the streams are coded by the C++ library, False when by
    the Python mirror."""
    return load_native() is not None


# ---- pure-python fallback (bit-identical format) ---------------------------


class _BitWriter:
    def __init__(self):
        self.bits: List[int] = []

    def ue(self, v: int):
        x = v + 1
        nbits = x.bit_length() - 1
        self.bits.extend([0] * nbits)
        for i in range(nbits, -1, -1):
            self.bits.append((x >> i) & 1)

    def se(self, v: int):
        self.ue(-2 * v if v <= 0 else 2 * v - 1)

    def tobytes(self) -> bytes:
        bits = self.bits
        out = bytearray((len(bits) + 7) // 8)
        for i, b in enumerate(bits):
            if b:
                out[i >> 3] |= 0x80 >> (i & 7)
        return bytes(out)


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _bit(self) -> int:
        i = self.pos
        self.pos += 1
        return (self.data[i >> 3] >> (7 - (i & 7))) & 1

    def ue(self) -> int:
        zeros = 0
        while self._bit() == 0:
            zeros += 1
        x = 1
        for _ in range(zeros):
            x = (x << 1) | self._bit()
        return x - 1

    def se(self) -> int:
        m = self.ue()
        return (m + 1) // 2 if m & 1 else -(m // 2)


def _py_encode(data: np.ndarray) -> bytes:
    w = _BitWriter()
    n = len(data)
    i = 0
    if n == 0:
        w.ue(0)
        return w.tobytes()
    while i < n:
        run = 0
        while i + run < n and data[i + run] == 0:
            run += 1
        if i + run >= n:
            w.ue(run)
            break
        w.ue(run)
        w.se(int(data[i + run]))
        i += run + 1
        if i >= n:
            w.ue(0)
    return w.tobytes()


def _py_decode(blob: bytes, n: int) -> np.ndarray:
    r = _BitReader(blob)
    out = np.zeros(n, np.int16)
    i = 0
    try:
        while i < n:
            run = r.ue()
            i += min(run, n - i)
            if i >= n:
                break
            out[i] = r.se()
            i += 1
    except IndexError:
        raise ValueError("bitstream decode error: truncated blob") from None
    return out


# ---------------------------------------------------------------------------
# v8 adaptive range coder — bit-identical Python mirror of the C++ in
# csrc/bitstream.cpp (namespace rc). 12-bit probabilities, >>5 adaptation,
# LZMA-style carry-less renormalization; truncated-unary binarization with
# per-bin contexts and exp-Golomb0 bypass tails. See the C++ header comment
# for the design rationale (plain exp-Golomb spent ~9 bits/nonzero; raw int8
# mode maps were 36% of a production container).

_RC_TOP = 1 << 24
_RC_PROB_BITS = 12
_RC_PROB_INIT = 1 << (_RC_PROB_BITS - 1)
_RC_RATE = 5
_RC_RUN_CAP = 16
_RC_LEV_CAP = 16


class _RcEncoder:
    def __init__(self):
        self.out = bytearray()
        self.low = 0
        self.range = 0xFFFFFFFF
        self.cache = 0
        self.cache_size = 1

    def _shift_low(self):
        # exact mirror of the C++: emit on carry-or-settled byte, then
        # low = (uint32)low << 8
        if (self.low & 0xFFFFFFFF) < 0xFF000000 or self.low >> 32:
            carry = self.low >> 32
            temp = self.cache
            while True:
                self.out.append((temp + carry) & 0xFF)
                temp = 0xFF
                self.cache_size -= 1
                if not self.cache_size:
                    break
            self.cache = (self.low >> 24) & 0xFF
        self.cache_size += 1
        # C++ does low = (uint32)low << 8 — a uint32 shift that drops the
        # top byte (it lives in `cache` now); mirror the truncation exactly
        self.low = (self.low & 0xFFFFFF) << 8

    def bit(self, probs, idx, b):
        split = (self.range >> _RC_PROB_BITS) * probs[idx]
        if not b:
            self.range = split
            probs[idx] += ((1 << _RC_PROB_BITS) - probs[idx]) >> _RC_RATE
        else:
            self.low += split
            self.range -= split
            probs[idx] -= probs[idx] >> _RC_RATE
        while self.range < _RC_TOP:
            self._shift_low()
            self.range = (self.range << 8) & 0xFFFFFFFF

    def bypass(self, b):
        self.range >>= 1
        if b:
            self.low += self.range
        while self.range < _RC_TOP:
            self._shift_low()
            self.range = (self.range << 8) & 0xFFFFFFFF

    def bypass_eg0(self, v):
        x = v + 1
        nbits = x.bit_length() - 1
        for _ in range(nbits):
            self.bypass(0)
        for i in range(nbits, -1, -1):
            self.bypass((x >> i) & 1)

    def tu(self, probs, cap, v):
        stop = v if v < cap else cap
        for j in range(stop):
            self.bit(probs, j, 1)
        if v < cap:
            self.bit(probs, v, 0)
        else:
            self.bypass_eg0(v - cap)

    def flush(self) -> bytes:
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)


class _RcDecoder:
    def __init__(self, blob: bytes):
        self.buf = blob
        self.pos = 0
        self.past_end = 0               # reads beyond the blob, as zeros
        self.range = 0xFFFFFFFF
        self.code = 0
        self._next()                    # leading cache byte (always 0)
        for _ in range(4):
            self.code = ((self.code << 8) | self._next()) & 0xFFFFFFFF

    def _next(self) -> int:
        if self.pos < len(self.buf):
            b = self.buf[self.pos]
            self.pos += 1
            return b
        self.past_end += 1
        return 0

    def bit(self, probs, idx) -> int:
        split = (self.range >> _RC_PROB_BITS) * probs[idx]
        if self.code < split:
            b = 0
            self.range = split
            probs[idx] += ((1 << _RC_PROB_BITS) - probs[idx]) >> _RC_RATE
        else:
            b = 1
            self.code -= split
            self.range -= split
            probs[idx] -= probs[idx] >> _RC_RATE
        while self.range < _RC_TOP:
            self.range = (self.range << 8) & 0xFFFFFFFF
            self.code = ((self.code << 8) | self._next()) & 0xFFFFFFFF
        return b

    def bypass(self) -> int:
        self.range >>= 1
        b = 1 if self.code >= self.range else 0
        if b:
            self.code -= self.range
        while self.range < _RC_TOP:
            self.range = (self.range << 8) & 0xFFFFFFFF
            self.code = ((self.code << 8) | self._next()) & 0xFFFFFFFF
        return b

    def bypass_eg0(self) -> int:
        zeros = 0
        while self.bypass() == 0:
            zeros += 1
            if zeros > 40:
                raise ValueError("bitstream decode error: bad EG0 tail")
        x = 1
        for _ in range(zeros):
            x = (x << 1) | self.bypass()
        return x - 1

    def tu(self, probs, cap) -> int:
        j = 0
        while j < cap and self.bit(probs, j):
            j += 1
        if j < cap:
            return j
        return cap + self.bypass_eg0()


def _py_rc_encode_i16(data: np.ndarray) -> bytes:
    e = _RcEncoder()
    run_bins = [_RC_PROB_INIT] * _RC_RUN_CAP
    lev_bins = [_RC_PROB_INIT] * _RC_LEV_CAP
    sign = [_RC_PROB_INIT]
    n = len(data)
    i = 0
    while i < n:
        run = 0
        while i + run < n and data[i + run] == 0:
            run += 1
        e.tu(run_bins, _RC_RUN_CAP, run)
        i += run
        if i >= n:
            break
        v = int(data[i])
        i += 1
        e.bit(sign, 0, 1 if v < 0 else 0)
        e.tu(lev_bins, _RC_LEV_CAP, abs(v) - 1)
    return e.flush()


def _py_rc_decode_i16(blob: bytes, n: int) -> np.ndarray:
    d = _RcDecoder(blob)
    run_bins = [_RC_PROB_INIT] * _RC_RUN_CAP
    lev_bins = [_RC_PROB_INIT] * _RC_LEV_CAP
    sign = [_RC_PROB_INIT]
    out = np.zeros(n, np.int16)
    i = 0
    while i < n:
        run = d.tu(run_bins, _RC_RUN_CAP)
        i += min(run, n - i)
        if i >= n:
            break
        neg = d.bit(sign, 0)
        m = d.tu(lev_bins, _RC_LEV_CAP) + 1
        out[i] = -m if neg else m
        i += 1
    return out


# ---- v9: zigzag-band-conditioned coefficient contexts + MV coder ----------
# Bit-identical mirrors of csrc/bitstream.cpp vcs_rc_*_i16_b / vcs_rc_*_mv.
# Rationale in the C++ header: the v8 single-context token model ignores
# that run/level statistics differ sharply by zigzag band, and wastes its
# run contexts on the near-binary MV streams.

_RC_BANDS = 4
_RC_MV_CAP = 8


def _rc_band(pos: int, block_len: int) -> int:
    if block_len <= 0:
        return 0
    p = pos % block_len
    if p == 0:
        return 0
    if p < 4:
        return 1
    if p < block_len // 4:
        return 2
    return 3


def _py_rc_encode_i16_b(data: np.ndarray, block_len: int) -> bytes:
    e = _RcEncoder()
    run_bins = [[_RC_PROB_INIT] * _RC_RUN_CAP for _ in range(_RC_BANDS)]
    lev_bins = [[_RC_PROB_INIT] * _RC_LEV_CAP for _ in range(_RC_BANDS)]
    sign = [[_RC_PROB_INIT] for _ in range(_RC_BANDS)]
    n = len(data)
    i = 0
    while i < n:
        run = 0
        while i + run < n and data[i + run] == 0:
            run += 1
        e.tu(run_bins[_rc_band(i, block_len)], _RC_RUN_CAP, run)
        i += run
        if i >= n:
            break
        b = _rc_band(i, block_len)
        v = int(data[i])
        i += 1
        e.bit(sign[b], 0, 1 if v < 0 else 0)
        e.tu(lev_bins[b], _RC_LEV_CAP, abs(v) - 1)
    return e.flush()


def _py_rc_decode_i16_b(blob: bytes, n: int, block_len: int) -> np.ndarray:
    d = _RcDecoder(blob)
    run_bins = [[_RC_PROB_INIT] * _RC_RUN_CAP for _ in range(_RC_BANDS)]
    lev_bins = [[_RC_PROB_INIT] * _RC_LEV_CAP for _ in range(_RC_BANDS)]
    sign = [[_RC_PROB_INIT] for _ in range(_RC_BANDS)]
    out = np.zeros(n, np.int16)
    i = 0
    while i < n:
        run = d.tu(run_bins[_rc_band(i, block_len)], _RC_RUN_CAP)
        i += min(run, n - i)
        if i >= n:
            break
        b = _rc_band(i, block_len)
        neg = d.bit(sign[b], 0)
        m = d.tu(lev_bins[b], _RC_LEV_CAP) + 1
        out[i] = -m if neg else m
        i += 1
    return out


def _py_rc_encode_i16_cbf(data: np.ndarray, block_len: int) -> bytes:
    """v10 mirror: per-block CBF (ctx: previous block's CBF) + in-block
    runs/levels with band contexts + per-level end-of-block flag."""
    if len(data) % block_len != 0:
        # explicit raise (not assert) to match the native coder's error
        # contract under python -O
        raise ValueError(
            f"stream length {len(data)} is not a multiple of block_len "
            f"{block_len}")
    e = _RcEncoder()
    run_bins = [[_RC_PROB_INIT] * _RC_RUN_CAP for _ in range(_RC_BANDS)]
    lev_bins = [[_RC_PROB_INIT] * _RC_LEV_CAP for _ in range(_RC_BANDS)]
    sign = [[_RC_PROB_INIT] for _ in range(_RC_BANDS)]
    eob = [[_RC_PROB_INIT] for _ in range(_RC_BANDS)]
    cbf_p = [_RC_PROB_INIT, _RC_PROB_INIT]
    prev_cbf = 0
    for blk in range(0, len(data), block_len):
        d = data[blk:blk + block_len]
        nz = np.flatnonzero(d)
        cbf = 1 if len(nz) else 0
        e.bit(cbf_p, prev_cbf, cbf)
        prev_cbf = cbf
        if not cbf:
            continue
        pos = 0
        for idx, p_ in enumerate(nz):
            e.tu(run_bins[_rc_band(pos, block_len)], _RC_RUN_CAP,
                 int(p_) - pos)
            b = _rc_band(int(p_), block_len)
            v = int(d[p_])
            e.bit(sign[b], 0, 1 if v < 0 else 0)
            e.tu(lev_bins[b], _RC_LEV_CAP, abs(v) - 1)
            e.bit(eob[b], 0, 1 if idx == len(nz) - 1 else 0)
            pos = int(p_) + 1
    return e.flush()


def _py_rc_decode_i16_cbf(blob: bytes, n: int, block_len: int) -> np.ndarray:
    if n % block_len != 0:
        raise ValueError(
            f"stream length {n} is not a multiple of block_len {block_len}")
    d = _RcDecoder(blob)
    run_bins = [[_RC_PROB_INIT] * _RC_RUN_CAP for _ in range(_RC_BANDS)]
    lev_bins = [[_RC_PROB_INIT] * _RC_LEV_CAP for _ in range(_RC_BANDS)]
    sign = [[_RC_PROB_INIT] for _ in range(_RC_BANDS)]
    eob = [[_RC_PROB_INIT] for _ in range(_RC_BANDS)]
    cbf_p = [_RC_PROB_INIT, _RC_PROB_INIT]
    out = np.zeros(n, np.int16)
    prev_cbf = 0
    for blk in range(0, n, block_len):
        cbf = d.bit(cbf_p, prev_cbf)
        prev_cbf = cbf
        if not cbf:
            continue
        pos = 0
        while True:
            pos += d.tu(run_bins[_rc_band(pos, block_len)], _RC_RUN_CAP)
            if pos >= block_len:
                raise ValueError("bitstream decode error: run off block")
            b = _rc_band(pos, block_len)
            neg = d.bit(sign[b], 0)
            m = d.tu(lev_bins[b], _RC_LEV_CAP) + 1
            out[blk + pos] = -m if neg else m
            is_eob = d.bit(eob[b], 0)
            pos += 1
            if is_eob:
                break
            if pos >= block_len:
                raise ValueError("bitstream decode error: missing EOB")
    return out


def _py_rc_encode_mv(data: np.ndarray) -> bytes:
    e = _RcEncoder()
    zero_p = [_RC_PROB_INIT] * 4
    sign_p = [_RC_PROB_INIT] * 2
    mag = [[_RC_PROB_INIT] * _RC_MV_CAP for _ in range(2)]
    prev_nz = [0, 0]
    for i, v in enumerate(np.asarray(data, np.int16).ravel()):
        v = int(v)
        c = i & 1
        e.bit(zero_p, c * 2 + prev_nz[c], 1 if v else 0)
        if v:
            e.bit(sign_p, c, 1 if v < 0 else 0)
            e.tu(mag[c], _RC_MV_CAP, abs(v) - 1)
        prev_nz[c] = 1 if v else 0
    return e.flush()


def _py_rc_decode_mv(blob: bytes, n: int) -> np.ndarray:
    d = _RcDecoder(blob)
    zero_p = [_RC_PROB_INIT] * 4
    sign_p = [_RC_PROB_INIT] * 2
    mag = [[_RC_PROB_INIT] * _RC_MV_CAP for _ in range(2)]
    prev_nz = [0, 0]
    out = np.zeros(n, np.int16)
    for i in range(n):
        c = i & 1
        nz = d.bit(zero_p, c * 2 + prev_nz[c])
        if nz:
            neg = d.bit(sign_p, c)
            m = d.tu(mag[c], _RC_MV_CAP) + 1
            out[i] = -m if neg else m
        prev_nz[c] = nz
    return out


def _py_rc_encode_u8(data: np.ndarray, nsym: int) -> bytes:
    e = _RcEncoder()
    nb = nsym - 1
    bins = [[_RC_PROB_INIT] * nb for _ in range(nsym)]
    prev = 0
    for v in np.asarray(data, np.uint8).ravel():
        v = int(v)
        if v >= nsym:
            raise ValueError(f"symbol {v} out of range for nsym={nsym}")
        b = bins[prev]
        for j in range(v):
            e.bit(b, j, 1)
        if v < nb:
            e.bit(b, v, 0)
        prev = v
    return e.flush()


def _py_rc_decode_u8(blob: bytes, n: int, nsym: int) -> np.ndarray:
    d = _RcDecoder(blob)
    nb = nsym - 1
    bins = [[_RC_PROB_INIT] * nb for _ in range(nsym)]
    out = np.empty(n, np.uint8)
    prev = 0
    for i in range(n):
        b = bins[prev]
        j = 0
        while j < nb and d.bit(b, j):
            j += 1
        out[i] = j
        prev = j
    return out


def _sig_posb(p: int) -> int:
    return p if p < 16 else 16


def _py_rc_encode_i16_sig(data: np.ndarray, nf: int, nc: int, nbh: int,
                          nbw: int, block_len: int) -> bytes:
    """v11 mirror: significance-map coefficient coder — CBF with
    (left, up, temporal, luma co-located) contexts, per-position sig flags
    with (position bucket, temporal sig, previous sig) contexts, band+gt1
    level contexts, explicit last flag. See csrc/bitstream.cpp v11."""
    data = np.asarray(data, np.int16).ravel()
    bpp = nbh * nbw
    bpf = bpp * nc
    nblk = bpf * nf
    bl = block_len
    if len(data) != nblk * bl:
        raise ValueError("sig stream length does not match the geometry")
    e = _RcEncoder()
    cbf_bins = [_RC_PROB_INIT] * 24
    sig_bins = [_RC_PROB_INIT] * (17 * 6)
    last_bins = [_RC_PROB_INIT] * 17
    sign_bins = [_RC_PROB_INIT] * _RC_BANDS
    lev_bins = [[_RC_PROB_INIT] * _RC_LEV_CAP for _ in range(_RC_BANDS * 2)]
    sig_prev = np.zeros((bpf, bl), np.uint8)
    cbfs = np.zeros(nblk, np.uint8)
    for bi in range(nblk):
        blk = data[bi * bl:(bi + 1) * bl]
        nzpos = np.nonzero(blk)[0]
        cbf = 1 if len(nzpos) else 0
        fi, rem = divmod(bi, bpf)
        ch, pi = divmod(rem, bpp)
        col, row = pi % nbw, pi // nbw
        l = int(cbfs[bi - 1]) if col else 0
        u = int(cbfs[bi - nbw]) if row else 0
        tm = int(cbfs[bi - bpf]) if fi else 0
        ych = int(cbfs[bi - ch * bpp]) if ch else 2
        e.bit(cbf_bins, ((l * 2 + u) * 2 + tm) * 3 + ych, cbf)
        cbfs[bi] = cbf
        sc = np.zeros(bl, np.uint8)
        if cbf:
            last = int(nzpos[-1])
            gt1 = 0
            prevsig = 1
            for p in range(last + 1):
                v = int(blk[p])
                sig = 1 if v else 0
                tctx = int(sig_prev[rem, p]) if fi else 2
                if p < bl - 1:
                    e.bit(sig_bins, (_sig_posb(p) * 3 + tctx) * 2 + prevsig,
                          sig)
                prevsig = sig
                if sig:
                    sc[p] = 1
                    b = _rc_band(p, bl)
                    e.bit(sign_bins, b, 1 if v < 0 else 0)
                    e.tu(lev_bins[b * 2 + gt1], _RC_LEV_CAP, abs(v) - 1)
                    if abs(v) > 1:
                        gt1 = 1
                    if p < bl - 1:
                        e.bit(last_bins, _sig_posb(p), 1 if p == last else 0)
        sig_prev[rem] = sc
    return e.flush()


def _py_rc_decode_i16_sig(blob: bytes, n: int, nf: int, nc: int, nbh: int,
                          nbw: int, block_len: int) -> np.ndarray:
    bpp = nbh * nbw
    bpf = bpp * nc
    nblk = bpf * nf
    bl = block_len
    if n != nblk * bl:
        raise ValueError("sig stream length does not match the geometry")
    d = _RcDecoder(blob)
    cbf_bins = [_RC_PROB_INIT] * 24
    sig_bins = [_RC_PROB_INIT] * (17 * 6)
    last_bins = [_RC_PROB_INIT] * 17
    sign_bins = [_RC_PROB_INIT] * _RC_BANDS
    lev_bins = [[_RC_PROB_INIT] * _RC_LEV_CAP for _ in range(_RC_BANDS * 2)]
    sig_prev = np.zeros((bpf, bl), np.uint8)
    cbfs = np.zeros(nblk, np.uint8)
    out = np.zeros(n, np.int16)
    for bi in range(nblk):
        fi, rem = divmod(bi, bpf)
        ch, pi = divmod(rem, bpp)
        col, row = pi % nbw, pi // nbw
        l = int(cbfs[bi - 1]) if col else 0
        u = int(cbfs[bi - nbw]) if row else 0
        tm = int(cbfs[bi - bpf]) if fi else 0
        ych = int(cbfs[bi - ch * bpp]) if ch else 2
        cbf = d.bit(cbf_bins, ((l * 2 + u) * 2 + tm) * 3 + ych)
        cbfs[bi] = cbf
        sc = np.zeros(bl, np.uint8)
        if cbf:
            gt1 = 0
            prevsig = 1
            for p in range(bl):
                tctx = int(sig_prev[rem, p]) if fi else 2
                sig = (d.bit(sig_bins, (_sig_posb(p) * 3 + tctx) * 2
                             + prevsig) if p < bl - 1 else 1)
                prevsig = sig
                if not sig:
                    continue
                sc[p] = 1
                b = _rc_band(p, bl)
                neg = d.bit(sign_bins, b)
                v = d.tu(lev_bins[b * 2 + gt1], _RC_LEV_CAP) + 1
                out[bi * bl + p] = -v if neg else v
                if v > 1:
                    gt1 = 1
                if p == bl - 1 or d.bit(last_bins, _sig_posb(p)):
                    break
        sig_prev[rem] = sc
    if d.past_end:
        # the encoder's flush leaves every byte its decoder reads
        raise ValueError("sig stream truncated")
    return out


def _py_rc_encode_modes2d(data: np.ndarray, rows: int, cols: int,
                          nsym: int) -> bytes:
    """v11 mirror: mode maps with (left, up)-pair truncated-unary contexts
    (unavailable neighbors substitute the available one / 0)."""
    data = np.asarray(data, np.uint8).ravel()
    if rows <= 0 or cols <= 0 or len(data) % (rows * cols):
        raise ValueError("mode stream length is not a multiple of the plane")
    e = _RcEncoder()
    nb = nsym - 1
    bins = [[_RC_PROB_INIT] * nb for _ in range(nsym * nsym)]
    for i, v in enumerate(data):
        v = int(v)
        if v >= nsym:
            raise ValueError(f"symbol {v} out of range for nsym={nsym}")
        col = i % cols
        row = (i // cols) % rows
        left = int(data[i - 1]) if col else -1
        up = int(data[i - cols]) if row else -1
        l = left if left >= 0 else (up if up >= 0 else 0)
        u = up if up >= 0 else l
        b = bins[l * nsym + u]
        for j in range(v):
            e.bit(b, j, 1)
        if v < nb:
            e.bit(b, v, 0)
    return e.flush()


def _py_rc_decode_modes2d(blob: bytes, n: int, rows: int, cols: int,
                          nsym: int) -> np.ndarray:
    if rows <= 0 or cols <= 0 or n % (rows * cols):
        raise ValueError("mode stream length is not a multiple of the plane")
    d = _RcDecoder(blob)
    nb = nsym - 1
    bins = [[_RC_PROB_INIT] * nb for _ in range(nsym * nsym)]
    out = np.empty(n, np.uint8)
    for i in range(n):
        col = i % cols
        row = (i // cols) % rows
        left = int(out[i - 1]) if col else -1
        up = int(out[i - cols]) if row else -1
        l = left if left >= 0 else (up if up >= 0 else 0)
        u = up if up >= 0 else l
        b = bins[l * nsym + u]
        j = 0
        while j < nb and d.bit(b, j):
            j += 1
        out[i] = j
    return out


@traced("vcs.rc_encode")
def rc_encode(data: np.ndarray) -> bytes:
    """int16 array -> range-coded bytes (v8 streams)."""
    data = np.ascontiguousarray(data, dtype=np.int16).ravel()
    lib = load_native()
    if lib is None or not hasattr(lib, "vcs_rc_encode_i16"):
        return _py_rc_encode_i16(data)
    cap = 8 * len(data) + 16
    out = np.empty(cap, np.uint8)
    nbytes = lib.vcs_rc_encode_i16(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if nbytes < 0:
        raise ValueError("bitstream encode overflow")
    return out[:nbytes].tobytes()


@traced("vcs.rc_decode")
def rc_decode(blob: bytes, n: int) -> np.ndarray:
    """range-coded bytes -> int16 array of length n."""
    lib = load_native()
    if lib is None or not hasattr(lib, "vcs_rc_decode_i16"):
        return _py_rc_decode_i16(blob, n)
    inp = np.frombuffer(blob, np.uint8)
    out = np.empty(n, np.int16)
    got = lib.vcs_rc_decode_i16(
        inp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(inp),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), n)
    if got != n:
        raise ValueError(f"bitstream decode error: {got} != {n}")
    return out


@traced("vcs.rc_encode")
def rc_encode_u8(data: np.ndarray, nsym: int) -> bytes:
    """uint8 symbol array (values < nsym) -> range-coded bytes (mode maps:
    prev-symbol-conditioned truncated-unary contexts)."""
    data = np.ascontiguousarray(data, dtype=np.uint8).ravel()
    lib = load_native()
    if lib is None or not hasattr(lib, "vcs_rc_encode_u8"):
        return _py_rc_encode_u8(data, nsym)
    cap = 2 * len(data) + 16
    out = np.empty(cap, np.uint8)
    nbytes = lib.vcs_rc_encode_u8(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
        nsym, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if nbytes < 0:
        raise ValueError("bitstream encode error")
    return out[:nbytes].tobytes()


@traced("vcs.rc_decode")
def rc_decode_u8(blob: bytes, n: int, nsym: int) -> np.ndarray:
    lib = load_native()
    if lib is None or not hasattr(lib, "vcs_rc_decode_u8"):
        return _py_rc_decode_u8(blob, n, nsym)
    inp = np.frombuffer(blob, np.uint8)
    out = np.empty(n, np.uint8)
    got = lib.vcs_rc_decode_u8(
        inp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(inp),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, nsym)
    if got != n:
        raise ValueError(f"bitstream decode error: {got} != {n}")
    return out


@traced("vcs.rc_encode")
def rc_encode_i16_b(data: np.ndarray, block_len: int) -> bytes:
    """int16 zigzag-block stream -> range-coded bytes with zigzag-band-
    conditioned run/sign/level contexts (v9 coefficient streams)."""
    data = np.ascontiguousarray(data, dtype=np.int16).ravel()
    lib = load_native()
    if lib is None or not hasattr(lib, "vcs_rc_encode_i16_b"):
        return _py_rc_encode_i16_b(data, block_len)
    cap = 8 * len(data) + 16
    out = np.empty(cap, np.uint8)
    nbytes = lib.vcs_rc_encode_i16_b(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), len(data),
        block_len, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if nbytes < 0:
        raise ValueError("bitstream encode overflow")
    return out[:nbytes].tobytes()


@traced("vcs.rc_decode")
def rc_decode_i16_b(blob: bytes, n: int, block_len: int) -> np.ndarray:
    lib = load_native()
    if lib is None or not hasattr(lib, "vcs_rc_decode_i16_b"):
        return _py_rc_decode_i16_b(blob, n, block_len)
    inp = np.frombuffer(blob, np.uint8)
    out = np.empty(n, np.int16)
    got = lib.vcs_rc_decode_i16_b(
        inp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(inp),
        block_len, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), n)
    if got != n:
        raise ValueError(f"bitstream decode error: {got} != {n}")
    return out


@traced("vcs.rc_encode")
def rc_encode_i16_cbf(data: np.ndarray, block_len: int) -> bytes:
    """int16 zigzag-block stream -> range-coded bytes with per-block CBF +
    in-block run/level/EOB tokens (v10 coefficient streams; measured -37%
    vs the v8 coder on QF50 statistics, tools/exp_entropy.py)."""
    data = np.ascontiguousarray(data, dtype=np.int16).ravel()
    lib = load_native()
    if lib is None or not hasattr(lib, "vcs_rc_encode_i16_cbf"):
        return _py_rc_encode_i16_cbf(data, block_len)
    cap = 8 * len(data) + 16
    out = np.empty(cap, np.uint8)
    nbytes = lib.vcs_rc_encode_i16_cbf(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), len(data),
        block_len, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if nbytes < 0:
        raise ValueError("bitstream encode error")
    return out[:nbytes].tobytes()


@traced("vcs.rc_decode")
def rc_decode_i16_cbf(blob: bytes, n: int, block_len: int) -> np.ndarray:
    lib = load_native()
    if lib is None or not hasattr(lib, "vcs_rc_decode_i16_cbf"):
        return _py_rc_decode_i16_cbf(blob, n, block_len)
    inp = np.frombuffer(blob, np.uint8)
    out = np.empty(n, np.int16)
    got = lib.vcs_rc_decode_i16_cbf(
        inp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(inp),
        block_len, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), n)
    if got != n:
        raise ValueError(f"bitstream decode error: {got} != {n}")
    return out


@traced("vcs.rc_encode")
def rc_encode_mv(data: np.ndarray) -> bytes:
    """Interleaved (dx, dy) int16 stream -> range-coded bytes (v9: per-
    component zero-flag/sign/magnitude contexts)."""
    data = np.ascontiguousarray(data, dtype=np.int16).ravel()
    lib = load_native()
    if lib is None or not hasattr(lib, "vcs_rc_encode_mv"):
        return _py_rc_encode_mv(data)
    cap = 8 * len(data) + 16
    out = np.empty(cap, np.uint8)
    nbytes = lib.vcs_rc_encode_mv(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if nbytes < 0:
        raise ValueError("bitstream encode overflow")
    return out[:nbytes].tobytes()


@traced("vcs.rc_decode")
def rc_decode_mv(blob: bytes, n: int) -> np.ndarray:
    lib = load_native()
    if lib is None or not hasattr(lib, "vcs_rc_decode_mv"):
        return _py_rc_decode_mv(blob, n)
    inp = np.frombuffer(blob, np.uint8)
    out = np.empty(n, np.int16)
    got = lib.vcs_rc_decode_mv(
        inp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(inp),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), n)
    if got != n:
        raise ValueError(f"bitstream decode error: {got} != {n}")
    return out


@traced("vcs.rc_encode")
def rc_encode_i16_sig(data: np.ndarray, nf: int, nc: int, nbh: int,
                      nbw: int, block_len: int) -> bytes:
    """int16 zigzag-block stream [..frames x channels x nbh x nbw blocks..]
    -> range-coded bytes via the v11 significance-map coder (spatial +
    temporal + cross-channel contexts; measured -13.9%/-11.5% vs the v10
    CBF coder on the R-D videos' QF50 P-coefficient streams)."""
    data = np.ascontiguousarray(data, dtype=np.int16).ravel()
    lib = load_native()
    if lib is None or not hasattr(lib, "vcs_rc_encode_i16_sig"):
        return _py_rc_encode_i16_sig(data, nf, nc, nbh, nbw, block_len)
    cap = 8 * len(data) + 16
    out = np.empty(cap, np.uint8)
    nbytes = lib.vcs_rc_encode_i16_sig(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), len(data),
        nf, nc, nbh, nbw, block_len,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if nbytes < 0:
        raise ValueError("bitstream encode error")
    return out[:nbytes].tobytes()


@traced("vcs.rc_decode")
def rc_decode_i16_sig(blob: bytes, n: int, nf: int, nc: int, nbh: int,
                      nbw: int, block_len: int) -> np.ndarray:
    lib = load_native()
    if lib is None or not hasattr(lib, "vcs_rc_decode_i16_sig"):
        return _py_rc_decode_i16_sig(blob, n, nf, nc, nbh, nbw, block_len)
    inp = np.frombuffer(blob, np.uint8)
    out = np.empty(n, np.int16)
    got = lib.vcs_rc_decode_i16_sig(
        inp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(inp),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), n,
        nf, nc, nbh, nbw, block_len)
    if got != n:
        raise ValueError(f"bitstream decode error: {got} != {n}")
    return out


def _raster_geom(shape, bs: int):
    """(nf, nc, H, W) of coefficient planes [..., H, W] in bs x bs blocks;
    ValueError where the blocks do not tile the planes."""
    if len(shape) < 2 or not 2 <= bs <= 64:
        raise ValueError(f"no bs={bs} block planes of shape {tuple(shape)}")
    h, w = shape[-2:]
    if h <= 0 or w <= 0 or h % bs or w % bs:
        raise ValueError(f"planes {h}x{w} are not tiled by {bs}x{bs} blocks")
    return (*_sig_geom(shape), h, w)


def rc_encode_i16_sig_raster(planes: np.ndarray, bs: int) -> bytes:
    """int16 coefficient planes [..., H, W] -> the bytes of
    `rc_encode_i16_sig` over their zigzag scan per bs x bs block. The native
    coder scans each block inside its block loop, so no scanned copy is
    made; without it, `_zigzag_plane` and the mirror code them."""
    planes = np.ascontiguousarray(planes, dtype=np.int16)
    nf, nc, h, w = _raster_geom(planes.shape, bs)
    lib = load_native()
    if lib is None:
        return rc_encode_i16_sig(_zigzag_plane(planes, bs), nf, nc,
                                 h // bs, w // bs, bs * bs)
    return _native_encode_raster(lib, planes, nf, nc, h, w, bs)


def rc_decode_i16_sig_raster(blob: bytes, shape, bs: int) -> np.ndarray:
    """Bytes of `rc_encode_i16_sig_raster` -> the int16 planes of `shape`.
    The native decoder stores each level at its place in the planes;
    without it, the mirror and `_unzigzag_plane` decode them."""
    shape = tuple(int(d) for d in shape)
    nf, nc, h, w = _raster_geom(shape, bs)
    lib = load_native()
    if lib is None:
        flat = rc_decode_i16_sig(blob, int(np.prod(shape)), nf, nc,
                                 h // bs, w // bs, bs * bs)
        return _unzigzag_plane(flat, shape, bs)
    return _native_decode_raster(lib, blob, shape, nf, nc, h, w, bs)


def _order_ptr(bs: int):
    return zigzag_order_np(bs).ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


@traced("vcs.rc_encode")
def _native_encode_raster(lib, planes, nf, nc, h, w, bs) -> bytes:
    add_counts(zigzag_fused=1)
    cap = 8 * planes.size + 16
    out = np.empty(cap, np.uint8)
    nbytes = lib.vcs_rc_encode_i16_sig_raster(
        planes.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), planes.size,
        nf, nc, h, w, bs, _order_ptr(bs),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if nbytes < 0:
        raise ValueError("bitstream encode error")
    return out[:nbytes].tobytes()


@traced("vcs.rc_decode")
def _native_decode_raster(lib, blob, shape, nf, nc, h, w, bs) -> np.ndarray:
    add_counts(zigzag_fused=1)
    inp = np.frombuffer(blob, np.uint8)
    out = np.empty(shape, np.int16)
    got = lib.vcs_rc_decode_i16_sig_raster(
        inp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(inp),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), out.size,
        nf, nc, h, w, bs, _order_ptr(bs))
    if got != out.size:
        raise ValueError(f"bitstream decode error: {got} != {out.size}")
    return out


@traced("vcs.rc_encode")
def rc_encode_modes2d(data: np.ndarray, rows: int, cols: int,
                      nsym: int) -> bytes:
    """uint8 mode planes [..., rows, cols] -> range-coded bytes with
    (left, up)-pair contexts (v11 mode streams; +2.3% vs the prev-symbol
    v10 contexts — an H.264-style MPM-flag variant measured worse)."""
    data = np.ascontiguousarray(data, dtype=np.uint8).ravel()
    lib = load_native()
    if lib is None or not hasattr(lib, "vcs_rc_encode_modes2d"):
        return _py_rc_encode_modes2d(data, rows, cols, nsym)
    cap = 2 * len(data) + 16
    out = np.empty(cap, np.uint8)
    nbytes = lib.vcs_rc_encode_modes2d(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
        rows, cols, nsym,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if nbytes < 0:
        raise ValueError("bitstream encode error")
    return out[:nbytes].tobytes()


@traced("vcs.rc_decode")
def rc_decode_modes2d(blob: bytes, n: int, rows: int, cols: int,
                      nsym: int) -> np.ndarray:
    lib = load_native()
    if lib is None or not hasattr(lib, "vcs_rc_decode_modes2d"):
        return _py_rc_decode_modes2d(blob, n, rows, cols, nsym)
    inp = np.frombuffer(blob, np.uint8)
    out = np.empty(n, np.uint8)
    got = lib.vcs_rc_decode_modes2d(
        inp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(inp),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n,
        rows, cols, nsym)
    if got != n:
        raise ValueError(f"bitstream decode error: {got} != {n}")
    return out


def rle_encode(data: np.ndarray) -> bytes:
    """int16 array -> entropy-coded bytes."""
    data = np.ascontiguousarray(data, dtype=np.int16).ravel()
    lib = load_native()
    if lib is None:
        return _py_encode(data)
    cap = 8 * len(data) + 16
    out = np.empty(cap, np.uint8)
    nbytes = lib.vcs_rle_encode_i16(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if nbytes < 0:
        raise ValueError("bitstream encode overflow")
    return out[:nbytes].tobytes()


def rle_decode(blob: bytes, n: int) -> np.ndarray:
    """entropy-coded bytes -> int16 array of length n."""
    lib = load_native()
    if lib is None:
        return _py_decode(blob, n)
    inp = np.frombuffer(blob, np.uint8)
    out = np.empty(n, np.int16)
    got = lib.vcs_rle_decode_i16(
        inp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(inp),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), n)
    if got != n:
        raise ValueError(f"bitstream decode error: {got} != {n}")
    return out


# ---------------------------------------------------------------------------
# .vcs container


@traced("vcs.zigzag")
def _zigzag_plane(coeffs: np.ndarray, bs: int) -> np.ndarray:
    """[..., H, W] int16 -> flat zigzag-per-block int16."""
    *lead, h, w = coeffs.shape
    order = zigzag_order_np(bs)
    x = coeffs.reshape(*lead, h // bs, bs, w // bs, bs)
    x = np.moveaxis(x, -3, -2).reshape(*lead, h // bs, w // bs, bs * bs)
    return x[..., order].ravel()


@traced("vcs.zigzag")
def _unzigzag_plane(flat: np.ndarray, shape, bs: int) -> np.ndarray:
    *lead, h, w = shape
    order = zigzag_order_np(bs)
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order), dtype=order.dtype)
    x = flat.reshape(*lead, h // bs, w // bs, bs * bs)[..., inv]
    x = x.reshape(*lead, h // bs, w // bs, bs, bs)
    x = np.moveaxis(x, -2, -3)
    return x.reshape(*lead, h, w)


def _stream_codecs(version: int):
    """(encode_i16, decode_i16) for a container version: v8+ streams are
    range-coded, older ones plain exp-Golomb. Writers always emit
    _VERSION."""
    if version >= 8:
        return rc_encode, rc_decode
    return rle_encode, rle_decode


def _sig_geom(shape):
    """(nf, nc) factoring of the leading dims of a coefficient array
    [..., H, W] for the v11 sig coder: [NF, C, H, W] -> (NF, C);
    [C, H, W] -> (1, C); [H, W] -> (1, 1)."""
    lead = shape[:-2]
    nc = lead[-1] if lead else 1
    nf = int(np.prod(lead[:-1])) if len(lead) > 1 else 1
    return nf, nc


def _coeff_codecs(version: int, bs: int):
    """(encode, decode) for blockwise coefficient ARRAYS: encode takes the
    [..., H, W] int16 array, decode takes (blob, shape) and returns the
    unzigzagged int16 array. v11 significance-map coder (needs the stream
    geometry for its spatial/temporal contexts; it scans the planes in
    place), v10 CBF tokens, v9 band-conditioned contexts, v8 single-context
    range coder, older exp-Golomb."""
    if version >= 11:
        return (lambda res16: rc_encode_i16_sig_raster(res16, bs),
                lambda blob, shape: rc_decode_i16_sig_raster(blob, shape, bs))

    bl = bs * bs
    if version >= 9:
        enc_f = ((lambda d: rc_encode_i16_cbf(d, bl)) if version >= 10
                 else (lambda d: rc_encode_i16_b(d, bl)))
        dec_f = ((lambda b, n: rc_decode_i16_cbf(b, n, bl)) if version >= 10
                 else (lambda b, n: rc_decode_i16_b(b, n, bl)))
    else:
        enc_f, dec_f = _stream_codecs(version)

    def enc(res16):
        return enc_f(_zigzag_plane(res16, bs))

    def dec(blob, shape):
        flat = dec_f(blob, int(np.prod(shape)))
        return _unzigzag_plane(flat, shape, bs).astype(np.int16)
    return enc, dec


def _mv_codecs(version: int):
    """(encode, decode) for MV streams: v9+ dedicated MV contexts. A v11
    median-of-neighbors residual predictor was built and measured WORSE
    than these contexts on the R-D videos (-12 to -20%: the zero-flag model
    already captures the dominant static blocks, and prediction turns zero
    MVs next to moving regions into nonzero residuals) — recorded in
    tools/exp_entropy.py; v11 keeps the v9 coder."""
    if version >= 9:
        return rc_encode_mv, rc_decode_mv
    return _stream_codecs(version)


def _encode_modes(modes: np.ndarray, nsym: int) -> bytes:
    """Mode-map stream writer (always _VERSION): (left, up)-pair contexts
    over the [..., rows, cols] planes."""
    modes = np.asarray(modes, np.uint8)
    rows, cols = modes.shape[-2:]
    return rc_encode_modes2d(modes.ravel(), rows, cols, nsym)


def _decode_modes(blob: bytes, shape, nsym: int,
                  version: int) -> np.ndarray:
    """Mode-map stream: v11 (left, up)-pair contexts, v8+ prev-symbol
    range-coded, older raw int8 bytes. Returns the reshaped plane stack."""
    n = int(np.prod(shape))
    if version >= 11:
        rows, cols = shape[-2:]
        out = rc_decode_modes2d(blob, n, rows, cols, nsym).astype(np.int8)
    elif version >= 8:
        out = rc_decode_u8(blob, n, nsym).astype(np.int8)
    else:
        out = np.frombuffer(blob, np.int8)
    return out.reshape(shape)


def _write_intra_section(fh, planes, modes, escape, lossy: bool) -> None:
    """One intra section of a [C, H, W] plane stack: the lossy payload's
    quantized coefficients (zigzag4 sig-coded) or the lossless residual
    (range-coded), then the mode maps with (left, up) contexts and the
    range-coded escape flags."""
    if lossy:
        enc_q, _ = _coeff_codecs(_VERSION, 4)
        first = enc_q(np.asarray(planes, np.int16))
    else:
        first = rc_encode(np.asarray(planes).ravel())
    modes_b = _encode_modes(modes, 9)
    esc = rc_encode(np.asarray(escape).astype(np.int16).ravel())
    fh.write(struct.pack("<QQQ", len(first), len(modes_b), len(esc)))
    fh.write(first); fh.write(modes_b); fh.write(esc)


def _scan_intra_section(fh):
    """Raw blobs of one intra section (no entropy decode)."""
    ql, ml, el = struct.unpack("<QQQ", fh.read(24))
    return fh.read(ql), fh.read(ml), fh.read(el)


def _decode_intra_section(blobs, shape, version, lossy: bool):
    """Entropy-decode a scanned intra section for a [C, H, W] stack ->
    (quantized coefficients or residual int16, modes int8, escape bool)."""
    _, dec = _stream_codecs(version)
    c, ih, iw = shape
    first, m_blob, e_blob = blobs
    if lossy:
        _, dec_q = _coeff_codecs(version, 4)
        planes = dec_q(first, shape)
    else:
        planes = dec(first, c * ih * iw).reshape(shape)
    modes = _decode_modes(m_blob, (c, ih // 4, iw // 4), 9, version)
    esc = dec(e_blob, c * (ih // 4) * (iw // 4))
    return planes, modes, esc.reshape(c, ih // 4, iw // 4).astype(bool)


def _write_blob(fh, blob: bytes) -> None:
    fh.write(struct.pack("<Q", len(blob)))
    fh.write(blob)


def _read_blob(fh) -> bytes:
    (n,) = struct.unpack("<Q", fh.read(8))
    return fh.read(n)


@dataclasses.dataclass(frozen=True)
class _Group:
    """One plane group of a GOP section, by the record's fields that hold
    it: the I planes, the P and the B residuals and the three lossy-intra
    payload fields; `channels` planes (None: the GOP header's count) at
    1/`sub` of the frame's sides. A `bare` group is one plane that the
    record holds without its channel axis."""
    i: str
    res: str
    bres: str
    payload: tuple
    channels: Optional[int]
    sub: int = 1
    bare: bool = False


@dataclasses.dataclass(frozen=True)
class _Layout:
    """A stream layout's GOP section: the record it fills, the GOP header's
    struct, the plane groups in file order, and the versions from which the
    I-section type byte and the B section are in the file."""
    record: type
    header: str
    groups: tuple
    itype_from: int
    b_from: int


# 4:4:4: a header (C, H, W) and the I-frame's C planes as one group
_LAYOUT_444 = _Layout(EncodedGOP, "<III", (
    _Group("i_frame", "residuals", "b_residuals", EncodedGOP.PAYLOAD,
           None),), itype_from=5, b_from=4)
# 4:2:0: a header (H, W), the luma plane, then the two half-size chroma planes
_LAYOUT_420 = _Layout(EncodedGOP420, "<II", (
    _Group("i_y", "res_y", "bres_y", EncodedGOP420.PAYLOAD[:3], 1,
           bare=True),
    _Group("i_c", "res_c", "bres_c", EncodedGOP420.PAYLOAD[3:], 2, sub=2)),
    itype_from=0, b_from=7)


def _layout(cfg: CodecConfig) -> _Layout:
    return _LAYOUT_420 if cfg.chroma_420 else _LAYOUT_444


def _lossy(gop, layout: _Layout, cfg: CodecConfig) -> bool:
    """Whether a GOP's I section is its lossy-intra payload."""
    return bool(getattr(gop, layout.groups[0].payload[0]) is not None
                and cfg.intra_qstep)


def _parallel_gop_builds(recs, build) -> list:
    """Decode scanned per-GOP section records concurrently (the read-side
    dual of _parallel_gop_sections): the range decoder's C entry points
    release the GIL, so a thread pool overlaps the entropy decode of
    independent GOP sections. Returns built GOPs in order."""
    from concurrent.futures import ThreadPoolExecutor
    if len(recs) <= 1:
        return [build(r) for r in recs]
    workers = min(8, os.cpu_count() or 1, len(recs))
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(carry(build), recs))


def _parallel_gop_sections(gops, write_one) -> list:
    """Entropy-code per-GOP sections concurrently: the range coder's C
    entry points release the GIL, so a thread pool overlaps the host-side
    coding of independent GOPs (and, in the streaming encode path, the
    device->host pulls of their still-resident arrays). Returns the encoded
    section bytes in GOP order."""
    import io as _io
    from concurrent.futures import ThreadPoolExecutor

    def one(gop):
        buf = _io.BytesIO()
        write_one(buf, gop)
        return buf.getvalue()

    if len(gops) <= 1:
        return [one(g) for g in gops]
    workers = min(8, os.cpu_count() or 1, len(gops))
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(carry(one), gops))


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor brought to host memory, counted (`d2h_copies`, `d2h_bytes`)
    on the span open around the call. It is counted on any device, so that
    a run on the CPU, which copies nothing, holds the count a card's run
    makes; an empty tensor, which a card does not copy, is not counted."""
    if t.numel():
        add_counts(d2h_copies=1, d2h_bytes=t.nbytes)
    return t.detach().cpu().numpy()


def _host_numpy(gop):
    """A GOP of tensors -> the same record holding numpy arrays, brought to
    host memory once (an encoder leaves its GOPs on the device)."""
    return gop._map(_to_host)


def _lossless_prep(gops, cfg: CodecConfig, layout: _Layout, device) -> list:
    """Per GOP, its lossless-intra sections (residual int16, modes int8,
    escape bool), one per plane group, or None where its I section is not
    lossless. The I planes of all such GOPs are re-encoded group by group
    by `encode_intra_frame` on `device` (the plain, fully parallel
    `luma4x4_codec`), GOP_CHUNK GOPs a call."""
    out = [[] if cfg.intra_i and not _lossy(g, layout, cfg) else None
           for g in gops]
    idx = [i for i, o in enumerate(out) if o is not None]
    if not idx:
        return out
    for group in layout.groups:
        # [C, H, W] a GOP, a bare plane as a view with C = 1
        planes = [getattr(gops[i], group.i) for i in idx]
        planes = np.concatenate([p[None] for p in planes] if group.bare
                                else planes)
        n = len(planes) // len(idx)
        for s in range(0, len(idx), GOP_CHUNK):
            coded = [_to_host(x) for x in intra_codec.encode_intra_frame(
                torch.from_numpy(np.ascontiguousarray(
                    planes[s * n:(s + GOP_CHUNK) * n])).to(device))]
            for k, i in enumerate(idx[s:s + GOP_CHUNK]):
                out[i].append(tuple(x[k * n:k * n + n] for x in coded))
    return out


def _residual_blob(res, group: _Group, cfg: CodecConfig) -> bytes:
    """The blob of a group's residual stack, empty for none: its quantized
    coefficients through the coefficient coder (a bare group's [N, H, W]
    as N frames of one channel, so that the sig coder's temporal contexts
    see frames), or without a DCT its wrap residuals, bytes recentred to
    int16 around 0 for short codes (the values cluster at 0 and 255)."""
    if res is None:
        return b""
    res = np.asarray(res)
    if not cfg.with_dct:
        res16 = res.astype(np.int16)
        res16 = np.where(res16 > 127, res16 - 256, res16).astype(np.int16)
        return rc_encode(res16.ravel())
    res16 = res if res.dtype == np.int16 else np.round(res).astype(np.int16)
    enc_co, _ = _coeff_codecs(_VERSION, cfg.block_size)
    return enc_co(res16[:, None] if group.bare else res16)


def _write_gop(fh, gop, lossless, cfg: CodecConfig, layout: _Layout) -> None:
    """One GOP section of host arrays; `lossless` holds a lossless-intra
    section per plane group when the I section is lossless."""
    groups = layout.groups
    fh.write(struct.pack(layout.header, *np.shape(getattr(gop, groups[0].i))))
    # I section type: 2 = the lossy-intra payload (bit-stable: the payload
    # from encode time, NOT a re-encode of the recon), 1 = lossless intra,
    # 0 = raw planes
    if _lossy(gop, layout, cfg):
        fh.write(struct.pack("<B", 2))
        for group in groups:
            _write_intra_section(fh, *(getattr(gop, k) for k in group.payload),
                                 lossy=True)
    elif cfg.intra_i:
        fh.write(struct.pack("<B", 1))
        for section in lossless:
            _write_intra_section(fh, *section, lossy=False)
    else:
        fh.write(struct.pack("<B", 0))
        for group in groups:
            fh.write(np.asarray(getattr(gop, group.i), np.uint8).tobytes())
    fh.write(struct.pack("<I", gop.mv.shape[0]))
    _write_blob(fh, rc_encode_mv(np.asarray(gop.mv, np.int16).ravel()))
    for group in groups:
        _write_blob(fh, _residual_blob(getattr(gop, group.res), group, cfg))
    # ---- B section -----------------------------------------------------
    n_b = 0 if gop.b_mv is None else gop.b_mv.shape[0]
    fh.write(struct.pack("<I", n_b))
    if n_b:
        bmv_blob = rc_encode_mv(np.asarray(gop.b_mv, np.int16).ravel())
        mode_b = _encode_modes(gop.b_mode, 3)
        fh.write(struct.pack("<QQ", len(bmv_blob), len(mode_b)))
        fh.write(bmv_blob); fh.write(mode_b)
        for group in groups:
            _write_blob(fh, _residual_blob(getattr(gop, group.bres), group,
                                           cfg))


@traced("save_vcs")
def save_vcs(video: EncodedVideo, path: str, *, device="cuda") -> None:
    """Serialize an EncodedVideo (quant_mode='rounded' for real compression).

    A `quant_mode='reference'` stream carries *float* DCT coefficients of
    WRAPPED (mod-256) residuals; `.vcs` has no float section and its integer
    mode decodes signed residuals, so such a stream cannot round-trip
    through the container. Refused with a pointer at `.npz`, which
    serializes the float stream exactly. `device` ("cuda" by default)
    re-encodes lossless-intra I-frames."""
    cfg = video.config
    if cfg.with_dct and cfg.quant_mode == "reference":
        raise ValueError(
            ".vcs stores integer coefficients of signed residuals; a "
            "quant_mode='reference' stream (float DCT of wrap residuals) "
            "cannot round-trip through it. Save to .npz instead, or encode "
            "with a production config (quant_mode='rounded').")
    if not cfg.signed_residual:
        raise ValueError(
            "signed_residual=False is the legacy container-v3 decode "
            "semantics (wrap residuals); the current writer only emits "
            "signed-RCT streams. Re-encode with a default production "
            "config to write a new container.")
    device = resolve_device(device)
    add_counts(frames=video.num_frames)
    layout = _layout(cfg)
    with trace_annotation("save_vcs.pull"):
        gops = [_host_numpy(g) for g in video.gops]
    with open(path, "wb") as fh:
        fh.write(_MAGIC)
        mode = (2 if cfg.with_dct else (1 if cfg.with_residual else 0))
        if cfg.intra_i:
            mode |= 4
        if cfg.chroma_420:
            mode |= 8
        fh.write(struct.pack(
            "<IIIdIIdII", _VERSION, video.height, video.width, video.fps,
            video.num_frames, cfg.block_size, cfg.quality_factor,
            len(video.gops), mode))
        pat = ",".join(cfg.gop_pattern).encode()
        fh.write(struct.pack("<I", len(pat)))
        fh.write(pat)
        fh.write(struct.pack("<I", cfg.intra_qstep))
        lossless = _lossless_prep(gops, cfg, layout, device)
        for sec in _parallel_gop_sections(
                list(zip(gops, lossless)),
                lambda b, g: _write_gop(b, *g, cfg, layout)):
            fh.write(sec)


class _CheckedReader:
    """File wrapper that validates every read length against the remaining
    file size, so lying length fields in a malformed .vcs raise ValueError
    instead of allocating unbounded memory or silently truncating."""

    def __init__(self, fh):
        self._fh = fh
        self._size = os.fstat(fh.fileno()).st_size

    def read(self, n: int) -> bytes:
        if n < 0:
            raise ValueError(".vcs: negative read")
        left = self._size - self._fh.tell()
        if n > left:
            raise ValueError(
                f".vcs truncated or lying length field: need {n} bytes, "
                f"{left} left")
        data = self._fh.read(n)
        if len(data) != n:
            raise ValueError(".vcs truncated")
        return data


def _scan_gop(fh, layout: _Layout, version: int, intra_i: bool) -> dict:
    """Phase 1 of the loader for one GOP section: its struct fields and raw
    blobs, no entropy decode (every length is explicit, so the scan is
    cheap)."""
    head = struct.unpack(layout.header,
                         fh.read(struct.calcsize(layout.header)))
    *c, h, w = head
    if not (all(1 <= n <= 4 for n in c) and 1 <= h <= 16384
            and 1 <= w <= 16384):
        raise ValueError(f".vcs: implausible GOP header {head}")
    r = dict(head=head, shapes=[(g.channels or c[0], h // g.sub, w // g.sub)
                                for g in layout.groups])
    if version >= layout.itype_from:
        (r["itype"],) = struct.unpack("<B", fh.read(1))
    else:
        r["itype"] = 1 if intra_i else 0
    r["i"] = [_scan_intra_section(fh) if r["itype"] in (1, 2)
              else fh.read(math.prod(shape)) for shape in r["shapes"]]
    (r["n_p"],) = struct.unpack("<I", fh.read(4))
    r["mv"] = _read_blob(fh)
    r["res"] = [_read_blob(fh) for _ in layout.groups]
    r["n_b"], r["bres"] = 0, [None] * len(layout.groups)
    if version >= layout.b_from:
        (r["n_b"],) = struct.unpack("<I", fh.read(4))
        if r["n_b"]:
            bl, ml = struct.unpack("<QQ", fh.read(16))
            r["b_mv"], r["b_mode"] = fh.read(bl), fh.read(ml)
            r["bres"] = [_read_blob(fh) for _ in layout.groups]
    return r


def _build_gop(r, layout: _Layout, cfg: CodecConfig, version: int):
    """Phase 2 of the loader for one scanned GOP: its entropy decode into
    the layout's record of numpy arrays. The I planes of an intra section
    wait for phase 3, in the payload fields or, lossless, in `iless`."""
    bs = cfg.block_size
    _, dec = _stream_codecs(version)
    _, dec_co = _coeff_codecs(version, bs)
    _, dec_mv = _mv_codecs(version)
    n_p, n_b, itype = r["n_p"], r["n_b"], r["itype"]
    nbh, nbw = r["head"][-2] // bs, r["head"][-1] // bs

    def residuals(blob, n_f, shape, group):
        if not blob:
            return None
        c, ih, iw = shape
        if not cfg.with_dct:
            flat = dec(blob, n_f * c * ih * iw).astype(np.int32)
            return (flat & 255).astype(np.uint8).reshape(n_f, c, ih, iw)
        res = dec_co(blob, (n_f, c, ih, iw))
        return res.reshape(n_f, ih, iw) if group.bare else res

    f, iless = {}, []
    for group, shape, sec, res, bres in zip(layout.groups, r["shapes"],
                                            r["i"], r["res"], r["bres"]):
        if itype == 2:
            f.update(zip(group.payload, _decode_intra_section(
                sec, shape, version, lossy=True)))
        elif itype == 1:
            iless.append(_decode_intra_section(sec, shape, version,
                                               lossy=False))
        else:
            f[group.i] = np.frombuffer(sec, np.uint8).reshape(
                shape[1:] if group.bare else shape)
        f[group.res] = residuals(res, n_p, shape, group)
        f[group.bres] = residuals(bres, n_b, shape, group)
    f["mv"] = dec_mv(r["mv"], n_p * nbh * nbw * 2).reshape(
        n_p, nbh, nbw, 2).astype(np.int32)
    if n_b:
        f["b_mv"] = dec_mv(r["b_mv"], n_b * 2 * nbh * nbw * 2).reshape(
            n_b, 2, nbh, nbw, 2).astype(np.int32)
        f["b_mode"] = _decode_modes(r["b_mode"], (n_b, nbh, nbw), 3, version)
    gop = layout.record(**{k.name: f.get(k.name)
                           for k in dataclasses.fields(layout.record)})
    gop.iless = iless
    return gop


def _gop_groups(gops, recs) -> list:
    """The intra-coded GOPs, grouped by section type and plane shape, in
    batches of up to GOP_CHUNK GOPs: (section type, GOPs) pairs."""
    groups = {}
    for g, r in zip(gops, recs):
        if r["itype"] in (1, 2):
            groups.setdefault((r["itype"], r["head"]), []).append(g)
    return [(itype, members[s:s + GOP_CHUNK])
            for (itype, _), members in groups.items()
            for s in range(0, len(members), GOP_CHUNK)]


def _decode_lossless(sections, device, backend) -> torch.Tensor:
    """Lossless-intra sections (residual, modes, escape) of [C, H, W] each
    -> uint8 [B, C, H, W] on `device`, all B * C planes decoded in one
    call."""
    b, (c, h, w) = len(sections), sections[0][0].shape
    res, modes, esc = (torch.from_numpy(np.concatenate(x)).to(device)
                       for x in zip(*sections))
    out = intra_codec.decode_intra_frame(
        intra_codec.IntraFrame(res, modes, esc), backend)
    return out.to(torch.uint8).reshape(b, c, h, w)


def _intra_decode(gops, recs, layout: _Layout, qstep: int, device,
                  backend) -> None:
    """Phase 3 of the loader: the I planes of every intra-coded GOP, decoded
    per plane shape in batches of GOP_CHUNK GOPs on `device`, one call per
    plane group (K6 on a GPU: a batch takes one launch at 4:4:4, one for
    its luma and one for its chroma planes at 4:2:0)."""
    for itype, members in _gop_groups(gops, recs):
        if itype == 2:
            pays = [intra_codec.IntraFrameLossy(*(
                torch.from_numpy(np.stack([getattr(g, f) for g in members]))
                .to(device) for f in group.payload))
                for group in layout.groups]
            outs = [intra_codec.decode_intra_frames_lossy_batch(
                pay, qstep, backend) for pay in pays]
        else:
            outs = [_decode_lossless([g.iless[k] for g in members], device,
                                     backend)
                    for k in range(len(layout.groups))]
        for group, out in zip(layout.groups, outs):
            for g, planes in zip(members, _to_host(out)):
                setattr(g, group.i, planes[0] if group.bare else planes)


def _load_gops(fh, cfg: CodecConfig, n_gops: int, version: int, device,
               backend) -> list:
    """The GOP sections of a stream, in three phases: a sequential scan,
    the entropy decode per GOP on a thread pool (the C decoder releases the
    GIL), then the I planes of all GOPs, batched per plane shape."""
    layout = _layout(cfg)
    recs = [_scan_gop(fh, layout, version, cfg.intra_i)
            for _ in range(n_gops)]
    gops = _parallel_gop_builds(
        recs, lambda r: _build_gop(r, layout, cfg, version))
    with trace_annotation("load_vcs.intra"):
        _intra_decode(gops, recs, layout, cfg.intra_qstep, device, backend)
    return gops


def _tensor(v: np.ndarray) -> torch.Tensor:
    v = np.ascontiguousarray(v)
    return torch.from_numpy(v if v.flags.writeable else v.copy())


def _tensors(gop):
    """A built GOP of numpy arrays -> the port's record of CPU tensors."""
    return gop._map(_tensor)


@traced("load_vcs")
def load_vcs(path: str, *, device="cuda",
             backend: str = "auto") -> EncodedVideo:
    """Load a `.vcs` file of version 3 to 11, written by either package.
    The I-frames of intra sections are decoded on `device` ("cuda" by
    default; `backend` as for the Decoder); the stream comes back in host
    memory. A malformed file raises ValueError."""
    device = resolve_device(device)
    check_backend(backend)
    with open(path, "rb") as raw_fh:
        fh = _CheckedReader(raw_fh)
        if fh.read(8) != _MAGIC:
            raise ValueError("not a .vcs file")
        (version, h, w, fps, num_frames, bs, qf, n_gops,
         mode) = struct.unpack("<IIIdIIdII", fh.read(44))
        if not (3 <= version <= _VERSION):
            raise ValueError(f"unsupported version {version}")
        if not (1 <= h <= 16384 and 1 <= w <= 16384):
            raise ValueError(f".vcs: implausible dimensions {h}x{w}")
        if not (2 <= bs <= 64):
            raise ValueError(f".vcs: implausible block size {bs}")
        if num_frames > 10_000_000 or n_gops > 1_000_000:
            raise ValueError(".vcs: implausible frame/GOP count")
        (pat_len,) = struct.unpack("<I", fh.read(4))
        if pat_len > 4096:
            raise ValueError(".vcs: implausible GOP pattern length")
        pattern = tuple(fh.read(pat_len).decode().split(","))
        intra_i = bool(mode & 4)
        chroma_420 = bool(mode & 8)
        mode &= 3
        intra_qstep = 0
        if version >= 5:
            (intra_qstep,) = struct.unpack("<I", fh.read(4))
        cfg = CodecConfig(block_size=bs, gop_pattern=pattern,
                          quality_factor=qf,
                          with_dct=(mode == 2), with_residual=(mode >= 1),
                          quant_mode="rounded" if mode == 2 else "reference",
                          intra_i=intra_i, intra_qstep=intra_qstep,
                          chroma_420=chroma_420,
                          # v3 streams carry rounded coefficients of the
                          # WRAPPED (mod-256) residual through the uint8
                          # BGR->YCrCb roundtrip; the signed-RCT residual
                          # transform arrived with v4
                          signed_residual=(version >= 4))
        gops = _load_gops(fh, cfg, n_gops, version, device, backend)
    return EncodedVideo(config=cfg, height=h, width=w, fps=fps,
                        num_frames=num_frames,
                        gops=[_tensors(g) for g in gops])
