"""A plain reader of the `.vcs` container (version 11), for judging the
served program's files: the header, every GOP section's layout, and the
range-coded fields of the GOPs asked for.

The range decoders are a frozen copy of the program's pure-Python coder
mirrors (12-bit adaptive probabilities, carry-less renormalisation,
truncated-unary binarisation with exp-Golomb-0 bypass tails; the v11
significance-map coefficient coder, the MV coder, the (left, up) mode-map
coder and the run/level coder of the escape flags). Sections of GOPs that
are not asked for are skipped by their length fields, so that every byte
of the file is accounted for without decoding it.

Only the layouts the benchmark serves are read: lossy-intra I-frames
(section type 2) with DCT residuals, full resolution or 4:2:0.
"""

from __future__ import annotations

import struct

import numpy as np


MAGIC = b"VCSH264T"
VERSION = 11

_TOP = 1 << 24
_PROB_BITS = 12
_PROB_INIT = 1 << (_PROB_BITS - 1)
_RATE = 5
_RUN_CAP = 16
_LEV_CAP = 16
_BANDS = 4
_MV_CAP = 8


class _Decoder:
    def __init__(self, blob: bytes):
        self.buf = blob
        self.pos = 0
        self.range = 0xFFFFFFFF
        self.code = 0
        self._next()
        for _ in range(4):
            self.code = ((self.code << 8) | self._next()) & 0xFFFFFFFF

    def _next(self) -> int:
        if self.pos < len(self.buf):
            b = self.buf[self.pos]
            self.pos += 1
            return b
        return 0

    def bit(self, probs, idx) -> int:
        split = (self.range >> _PROB_BITS) * probs[idx]
        if self.code < split:
            b = 0
            self.range = split
            probs[idx] += ((1 << _PROB_BITS) - probs[idx]) >> _RATE
        else:
            b = 1
            self.code -= split
            self.range -= split
            probs[idx] -= probs[idx] >> _RATE
        while self.range < _TOP:
            self.range = (self.range << 8) & 0xFFFFFFFF
            self.code = ((self.code << 8) | self._next()) & 0xFFFFFFFF
        return b

    def bypass(self) -> int:
        self.range >>= 1
        b = 1 if self.code >= self.range else 0
        if b:
            self.code -= self.range
        while self.range < _TOP:
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


def decode_runs(blob: bytes, n: int) -> np.ndarray:
    """Run/level stream (the escape flags) -> int16 [n]."""
    d = _Decoder(blob)
    run_bins = [_PROB_INIT] * _RUN_CAP
    lev_bins = [_PROB_INIT] * _LEV_CAP
    sign = [_PROB_INIT]
    out = np.zeros(n, np.int16)
    i = 0
    while i < n:
        run = d.tu(run_bins, _RUN_CAP)
        i += min(run, n - i)
        if i >= n:
            break
        neg = d.bit(sign, 0)
        m = d.tu(lev_bins, _LEV_CAP) + 1
        out[i] = -m if neg else m
        i += 1
    return out


def decode_mv(blob: bytes, n: int) -> np.ndarray:
    """MV stream -> int16 [n], dx and dy interleaved."""
    d = _Decoder(blob)
    zero_p = [_PROB_INIT] * 4
    sign_p = [_PROB_INIT] * 2
    mag = [[_PROB_INIT] * _MV_CAP for _ in range(2)]
    prev_nz = [0, 0]
    out = np.zeros(n, np.int16)
    for i in range(n):
        c = i & 1
        nz = d.bit(zero_p, c * 2 + prev_nz[c])
        if nz:
            neg = d.bit(sign_p, c)
            m = d.tu(mag[c], _MV_CAP) + 1
            out[i] = -m if neg else m
        prev_nz[c] = nz
    return out


def decode_modes(blob: bytes, n: int, rows: int, cols: int,
                 nsym: int) -> np.ndarray:
    """Mode maps with (left, up)-pair contexts -> uint8 [n]."""
    d = _Decoder(blob)
    nb = nsym - 1
    bins = [[_PROB_INIT] * nb for _ in range(nsym * nsym)]
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


def _band(p: int, block_len: int) -> int:
    p = p % block_len
    if p == 0:
        return 0
    if p < 4:
        return 1
    if p < block_len // 4:
        return 2
    return 3


def decode_sig(blob: bytes, nf: int, nc: int, nbh: int, nbw: int,
               bl: int) -> np.ndarray:
    """The v11 significance-map coefficient stream -> int16 zigzag-per-block
    values [nf * nc * nbh * nbw * bl]."""
    bpp = nbh * nbw
    bpf = bpp * nc
    nblk = bpf * nf
    d = _Decoder(blob)
    cbf_bins = [_PROB_INIT] * 24
    sig_bins = [_PROB_INIT] * (17 * 6)
    last_bins = [_PROB_INIT] * 17
    sign_bins = [_PROB_INIT] * _BANDS
    lev_bins = [[_PROB_INIT] * _LEV_CAP for _ in range(_BANDS * 2)]
    # Python containers, not numpy ones: indexing a numpy array from Python
    # costs several times as much
    sig_prev = [bytearray(bl) for _ in range(bpf)]
    cbfs = bytearray(nblk)
    out = np.zeros(nblk * bl, np.int16)
    for bi in range(nblk):
        fi, rem = divmod(bi, bpf)
        ch, pi = divmod(rem, bpp)
        col, row = pi % nbw, pi // nbw
        l = cbfs[bi - 1] if col else 0
        u = cbfs[bi - nbw] if row else 0
        tm = cbfs[bi - bpf] if fi else 0
        ych = cbfs[bi - ch * bpp] if ch else 2
        cbf = d.bit(cbf_bins, ((l * 2 + u) * 2 + tm) * 3 + ych)
        cbfs[bi] = cbf
        sc = bytearray(bl)
        if cbf:
            prev_row = sig_prev[rem]
            gt1 = 0
            prevsig = 1
            for p in range(bl):
                tctx = prev_row[p] if fi else 2
                sig = (d.bit(sig_bins, (min(p, 16) * 3 + tctx) * 2 + prevsig)
                       if p < bl - 1 else 1)
                prevsig = sig
                if not sig:
                    continue
                sc[p] = 1
                b = _band(p, bl)
                neg = d.bit(sign_bins, b)
                v = d.tu(lev_bins[b * 2 + gt1], _LEV_CAP) + 1
                out[bi * bl + p] = -v if neg else v
                if v > 1:
                    gt1 = 1
                if p == bl - 1 or d.bit(last_bins, min(p, 16)):
                    break
        sig_prev[rem] = sc
    return out


def zigzag_order_np(n: int) -> np.ndarray:
    """Flat indices of an n x n block in zigzag scan order (even
    anti-diagonals run from bottom-left to top-right)."""
    idx = []
    for s in range(2 * n - 1):
        diag = [(i, s - i) for i in range(max(0, s - n + 1), min(n, s + 1))]
        if s % 2 == 0:
            diag = diag[::-1]
        idx.extend(i * n + j for i, j in diag)
    return np.array(idx, dtype=np.int32)


def decode_coeffs(blob: bytes, shape, bs: int) -> np.ndarray:
    """A coefficient section of planes [nf, nc, H, W] (zigzag per block of
    bs x bs) -> int16 array of `shape`."""
    nf, nc, h, w = shape
    flat = decode_sig(blob, nf, nc, h // bs, w // bs, bs * bs)
    order = zigzag_order_np(bs)
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order), dtype=order.dtype)
    x = flat.reshape(nf, nc, h // bs, w // bs, bs * bs)[..., inv]
    x = x.reshape(nf, nc, h // bs, w // bs, bs, bs)
    return np.moveaxis(x, -2, -3).reshape(shape)


class _File:
    """The file's bytes with a cursor; reading past the end raises."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise ValueError(f".vcs: {n} bytes wanted at {self.pos}, "
                             f"{len(self.data)} in the file")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))

    def blob(self) -> bytes:
        (n,) = self.unpack("<Q")
        return self.take(n)


def _intra_payload(f: _File, c: int, h: int, w: int, decode: bool):
    ql, ml, el = f.unpack("<QQQ")
    qb, mb, eb = f.take(ql), f.take(ml), f.take(el)
    if not decode:
        return {}
    nm = c * (h // 4) * (w // 4)
    return dict(
        qcoef=decode_coeffs(qb, (1, c, h, w), 4)[0],
        modes=decode_modes(mb, nm, h // 4, w // 4, 9).astype(np.int8)
        .reshape(c, h // 4, w // 4),
        escape=decode_runs(eb, nm).reshape(c, h // 4, w // 4).astype(bool))


def _coeff_section(f: _File, shape, bs: int, decode: bool):
    blob = f.blob()
    return decode_coeffs(blob, shape, bs) if decode and blob else None


def read(data: bytes, want=()):
    """-> (header dict, {gop index: fields} for the GOPs in `want`, bytes
    the walk accounted for). Raises ValueError on a file whose layout this
    reader does not take or whose length fields overrun it."""
    f = _File(data)
    if f.take(8) != MAGIC:
        raise ValueError("not a .vcs file")
    (version, h, w, fps, num_frames, bs, qf, n_gops,
     mode) = f.unpack("<IIIdIIdII")
    (pat_len,) = f.unpack("<I")
    pattern = tuple(f.take(pat_len).decode().split(","))
    (qstep,) = f.unpack("<I")
    header = dict(version=version, height=h, width=w, fps=fps,
                  num_frames=num_frames, block_size=bs, quality_factor=qf,
                  n_gops=n_gops, mode=mode, gop_pattern=pattern,
                  intra_qstep=qstep)
    if version != VERSION or mode & 3 != 2 or not mode & 4:
        raise ValueError(f".vcs layout not read here: version {version}, "
                         f"mode {mode}")
    c420 = bool(mode & 8)
    nbh, nbw = h // bs, w // bs
    gops = {}
    for g in range(n_gops):
        dec = g in want
        out = {}
        if c420:
            gh, gw = f.unpack("<II")
            (itype,) = f.unpack("<B")
            if itype != 2 or (gh, gw) != (h, w):
                raise ValueError(f"GOP {g}: I section {itype} at {gh}x{gw}")
            for suffix, (c, ph, pw) in (("y", (1, h, w)),
                                        ("c", (2, h // 2, w // 2))):
                pay = _intra_payload(f, c, ph, pw, dec)
                if dec:
                    out.update({f"iq_{suffix}": pay["qcoef"],
                                f"im_{suffix}": pay["modes"],
                                f"ie_{suffix}": pay["escape"]})
        else:
            c, gh, gw = f.unpack("<III")
            (itype,) = f.unpack("<B")
            if itype != 2 or (c, gh, gw) != (3, h, w):
                raise ValueError(f"GOP {g}: I section {itype} at "
                                 f"{(c, gh, gw)}")
            pay = _intra_payload(f, 3, h, w, dec)
            if dec:
                out.update(i_qcoef=pay["qcoef"], i_modes=pay["modes"],
                           i_escape=pay["escape"])
        (n_p,) = f.unpack("<I")
        mvb = f.blob()
        if dec:
            out["mv"] = decode_mv(mvb, n_p * nbh * nbw * 2).reshape(
                n_p, nbh, nbw, 2).astype(np.int32)
        if c420:
            out["res_y"] = _coeff_section(f, (n_p, 1, h, w), bs, dec)
            out["res_c"] = _coeff_section(f, (n_p, 2, h // 2, w // 2), bs,
                                          dec)
            if dec:
                out["res_y"] = out["res_y"][:, 0]
        else:
            out["residuals"] = _coeff_section(f, (n_p, 3, h, w), bs, dec)
        (n_b,) = f.unpack("<I")
        if n_b:
            bl, ml = f.unpack("<QQ")
            bmv, bmode = f.take(bl), f.take(ml)
            if dec:
                out["b_mv"] = decode_mv(bmv, n_b * 2 * nbh * nbw * 2).reshape(
                    n_b, 2, nbh, nbw, 2).astype(np.int32)
                out["b_mode"] = decode_modes(bmode, n_b * nbh * nbw, nbh, nbw,
                                             3).astype(np.int8).reshape(
                    n_b, nbh, nbw)
            if c420:
                out["bres_y"] = _coeff_section(f, (n_b, 1, h, w), bs, dec)
                out["bres_c"] = _coeff_section(f, (n_b, 2, h // 2, w // 2),
                                               bs, dec)
                if dec:
                    out["bres_y"] = out["bres_y"][:, 0]
            else:
                out["b_residuals"] = _coeff_section(f, (n_b, 3, h, w), bs,
                                                    dec)
        if dec:
            gops[g] = {k: v for k, v in out.items() if v is not None}
    return header, gops, f.pos


def gop_fields(job) -> dict:
    """(file bytes, GOP index) -> that GOP's fields; for a process pool."""
    data, g = job
    return read(data, {g})[1][g]
