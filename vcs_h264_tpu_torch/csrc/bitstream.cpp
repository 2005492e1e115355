// Native bitstream codec for vcs_h264_tpu.
//
// The reference has no entropy coding or on-disk bitstream at all — encoded
// frames live as Python objects (InterframeCompression/frame.py:1-8). This
// library provides the missing layer: zero-run + signed exp-Golomb coding of
// quantized DCT coefficients and motion vectors, the format used by
// io/bitstream.py for the .vcs container (a pure-Python fallback with the
// identical format lives there too).
//
// Codes (H.264-style):
//   ue(v):  exp-Golomb unsigned   1 -> "1"; v>0 -> [zeros]=floor(log2(v+1)),
//           binary of v+1
//   se(v):  signed mapping v -> (v<=0 ? -2v : 2v-1) then ue
//   stream: tokens (zero_run:ue, value:se) per nonzero; a trailing
//           (remaining_run:ue) flushes the tail; bit-packed MSB-first.
//
// Build: g++ -O3 -shared -fPIC -o libvcsbits.so bitstream.cpp

#include <cstdint>
#include <cstring>

namespace {

struct BitWriter {
    uint8_t* buf;
    int64_t cap;
    int64_t byte_pos = 0;
    int bit_pos = 0;   // next bit within buf[byte_pos], MSB first
    bool overflow = false;

    void put_bit(int b) {
        if (byte_pos >= cap) { overflow = true; return; }
        if (bit_pos == 0) buf[byte_pos] = 0;
        if (b) buf[byte_pos] |= (uint8_t)(0x80u >> bit_pos);
        if (++bit_pos == 8) { bit_pos = 0; ++byte_pos; }
    }

    void put_ue(uint32_t v) {
        uint64_t x = (uint64_t)v + 1;
        int nbits = 0;
        for (uint64_t t = x; t > 1; t >>= 1) ++nbits;
        for (int i = 0; i < nbits; ++i) put_bit(0);
        for (int i = nbits; i >= 0; --i) put_bit((x >> i) & 1);
    }

    void put_se(int32_t v) {
        uint32_t m = v <= 0 ? (uint32_t)(-2 * (int64_t)v)
                            : (uint32_t)(2 * (int64_t)v - 1);
        put_ue(m);
    }

    int64_t flush() {
        if (overflow) return -1;
        return byte_pos + (bit_pos ? 1 : 0);
    }
};

struct BitReader {
    const uint8_t* buf;
    int64_t nbytes;
    int64_t byte_pos = 0;
    int bit_pos = 0;
    bool error = false;

    int get_bit() {
        if (byte_pos >= nbytes) { error = true; return 0; }
        int b = (buf[byte_pos] >> (7 - bit_pos)) & 1;
        if (++bit_pos == 8) { bit_pos = 0; ++byte_pos; }
        return b;
    }

    uint32_t get_ue() {
        int zeros = 0;
        while (!error && get_bit() == 0) {
            if (++zeros > 40) { error = true; return 0; }
        }
        uint64_t x = 1;
        for (int i = 0; i < zeros; ++i) x = (x << 1) | (uint32_t)get_bit();
        return (uint32_t)(x - 1);
    }

    int32_t get_se() {
        uint32_t m = get_ue();
        return (m & 1) ? (int32_t)((m + 1) / 2) : -(int32_t)(m / 2);
    }
};

}  // namespace

extern "C" {

// Encode n int16 samples; returns bytes written, or -1 on overflow.
int64_t vcs_rle_encode_i16(const int16_t* data, int64_t n,
                           uint8_t* out, int64_t out_cap) {
    BitWriter w{out, out_cap};
    int64_t i = 0;
    while (i < n) {
        int64_t run = 0;
        while (i + run < n && data[i + run] == 0) ++run;
        if (i + run >= n) {            // tail of zeros
            w.put_ue((uint32_t)run);
            break;
        }
        w.put_ue((uint32_t)run);
        w.put_se(data[i + run]);
        i += run + 1;
        if (i >= n) w.put_ue(0);       // explicit empty tail
    }
    if (n == 0) w.put_ue(0);
    return w.flush();
}

// Decode exactly n_out samples; returns samples decoded, or -1 on error.
int64_t vcs_rle_decode_i16(const uint8_t* in, int64_t nbytes,
                           int16_t* out, int64_t n_out) {
    BitReader r{in, nbytes};
    int64_t i = 0;
    while (i < n_out) {
        uint32_t run = r.get_ue();
        if (r.error) return -1;
        for (uint32_t k = 0; k < run && i < n_out; ++k) out[i++] = 0;
        if (i >= n_out) break;
        int32_t v = r.get_se();
        if (r.error) return -1;
        out[i++] = (int16_t)v;
    }
    return i;
}

// Worst-case output bound for n samples (every sample nonzero + large).
int64_t vcs_rle_bound(int64_t n) { return 8 * n + 16; }

}  // extern "C"

// ---------------------------------------------------------------------------
// v8: adaptive binary range coder (LZMA-style) + context-modeled token codes.
//
// The plain exp-Golomb layer above spends ~9 bits per nonzero coefficient at
// QF50 although ~82% of nonzero levels are +-1 and runs are bimodal (DC-
// dense, AC-sparse); the raw int8 intra mode maps were 36% of a production
// container. This layer replaces both with a carry-less range coder
// (12-bit adaptive probabilities, >>5 adaptation) over truncated-unary
// binarizations with per-bin contexts, exp-Golomb bypass tails for
// outliers, and a dedicated multi-symbol path for mode maps. A bit-identical
// pure-Python implementation lives in io/bitstream.py (_py_rc_*).

namespace rc {

constexpr uint32_t kTop = 1u << 24;
constexpr int kProbBits = 12;
constexpr uint16_t kProbInit = 1 << (kProbBits - 1);
constexpr int kRate = 5;
// truncated-unary caps (remainder goes to the exp-Golomb0 bypass tail)
constexpr int kRunCap = 16;
constexpr int kLevCap = 16;

struct Encoder {
    uint8_t* buf;
    int64_t cap;
    int64_t pos = 0;
    uint64_t low = 0;
    uint32_t range = 0xFFFFFFFFu;
    uint8_t cache = 0;
    int64_t cache_size = 1;
    bool overflow = false;

    void put_byte(uint8_t b) {
        if (pos >= cap) { overflow = true; return; }
        buf[pos++] = b;
    }

    void shift_low() {
        if ((uint32_t)low < 0xFF000000u || (unsigned)(low >> 32) != 0) {
            uint8_t carry = (uint8_t)(low >> 32);
            uint8_t temp = cache;
            do { put_byte((uint8_t)(temp + carry)); temp = 0xFF; }
            while (--cache_size);
            cache = (uint8_t)(low >> 24);
        }
        ++cache_size;
        low = (uint32_t)low << 8;
    }

    void bit(uint16_t* p, int b) {
        uint32_t split = (range >> kProbBits) * (*p);
        if (!b) {
            range = split;
            *p = (uint16_t)(*p + (((1u << kProbBits) - *p) >> kRate));
        } else {
            low += split;
            range -= split;
            *p = (uint16_t)(*p - (*p >> kRate));
        }
        while (range < kTop) { shift_low(); range <<= 8; }
    }

    void bypass(int b) {
        range >>= 1;
        if (b) low += range;
        while (range < kTop) { shift_low(); range <<= 8; }
    }

    void bypass_eg0(uint32_t v) {       // exp-Golomb0 through bypass bits
        uint64_t x = (uint64_t)v + 1;
        int nbits = 0;
        for (uint64_t t = x; t > 1; t >>= 1) ++nbits;
        for (int i = 0; i < nbits; ++i) bypass(0);
        for (int i = nbits; i >= 0; --i) bypass((x >> i) & 1);
    }

    // truncated unary (1 = continue) with per-position contexts, EG0 tail
    void tu(uint16_t* bins, int cap_, uint32_t v) {
        int stop = v < (uint32_t)cap_ ? (int)v : cap_;
        for (int j = 0; j < stop; ++j) bit(&bins[j], 1);
        if (v < (uint32_t)cap_) bit(&bins[(int)v], 0);
        else bypass_eg0(v - cap_);
    }

    int64_t flush() {
        for (int i = 0; i < 5; ++i) shift_low();
        return overflow ? -1 : pos;
    }
};

struct Decoder {
    const uint8_t* buf;
    int64_t nbytes;
    int64_t pos = 0;
    uint32_t range = 0xFFFFFFFFu;
    uint32_t code = 0;
    bool error = false;

    int64_t past_end = 0;            // reads beyond the blob, as zeros

    uint8_t next() {
        if (pos < nbytes) return buf[pos++];
        ++past_end;
        return 0;
    }

    void init() {
        next();                          // leading cache byte (always 0)
        for (int i = 0; i < 4; ++i) code = (code << 8) | next();
    }

    int bit(uint16_t* p) {
        uint32_t split = (range >> kProbBits) * (*p);
        int b;
        if (code < split) {
            b = 0;
            range = split;
            *p = (uint16_t)(*p + (((1u << kProbBits) - *p) >> kRate));
        } else {
            b = 1;
            code -= split;
            range -= split;
            *p = (uint16_t)(*p - (*p >> kRate));
        }
        while (range < kTop) { range <<= 8; code = (code << 8) | next(); }
        return b;
    }

    int bypass() {
        range >>= 1;
        int b = code >= range;
        if (b) code -= range;
        while (range < kTop) { range <<= 8; code = (code << 8) | next(); }
        return b;
    }

    uint32_t bypass_eg0() {
        int zeros = 0;
        while (bypass() == 0) {
            if (++zeros > 40) { error = true; return 0; }
        }
        uint64_t x = 1;
        for (int i = 0; i < zeros; ++i) x = (x << 1) | (uint32_t)bypass();
        return (uint32_t)(x - 1);
    }

    uint32_t tu(uint16_t* bins, int cap_) {
        int j = 0;
        while (j < cap_ && bit(&bins[j])) ++j;
        if (j < cap_) return (uint32_t)j;
        return (uint32_t)cap_ + bypass_eg0();
    }
};

}  // namespace rc

extern "C" {

// Token-coded int16 stream: (zero_run, nonzero level) pairs, trailing run.
// Same token structure as vcs_rle_encode_i16 but range-coded with adaptive
// per-bin contexts; ~1.5-2x denser on quantized-coefficient statistics.
int64_t vcs_rc_encode_i16(const int16_t* data, int64_t n,
                          uint8_t* out, int64_t out_cap) {
    rc::Encoder e{out, out_cap};
    uint16_t run_bins[rc::kRunCap], lev_bins[rc::kLevCap];
    for (auto& p : run_bins) p = rc::kProbInit;
    for (auto& p : lev_bins) p = rc::kProbInit;
    uint16_t sign_p = rc::kProbInit;
    int64_t i = 0;
    while (i < n) {
        int64_t run = 0;
        while (i + run < n && data[i + run] == 0) ++run;
        e.tu(run_bins, rc::kRunCap, (uint32_t)run);
        i += run;
        if (i >= n) break;
        int32_t v = data[i++];
        e.bit(&sign_p, v < 0);
        uint32_t m = (uint32_t)(v < 0 ? -v : v) - 1;
        e.tu(lev_bins, rc::kLevCap, m);
    }
    return e.flush();
}

int64_t vcs_rc_decode_i16(const uint8_t* in, int64_t nbytes,
                          int16_t* out, int64_t n_out) {
    rc::Decoder d{in, nbytes};
    d.init();
    uint16_t run_bins[rc::kRunCap], lev_bins[rc::kLevCap];
    for (auto& p : run_bins) p = rc::kProbInit;
    for (auto& p : lev_bins) p = rc::kProbInit;
    uint16_t sign_p = rc::kProbInit;
    int64_t i = 0;
    while (i < n_out) {
        uint32_t run = d.tu(run_bins, rc::kRunCap);
        if (d.error) return -1;
        for (uint32_t k = 0; k < run && i < n_out; ++k) out[i++] = 0;
        if (i >= n_out) break;
        int neg = d.bit(&sign_p);
        uint32_t m = d.tu(lev_bins, rc::kLevCap);
        if (d.error) return -1;
        int32_t v = (int32_t)m + 1;
        out[i++] = (int16_t)(neg ? -v : v);
    }
    return i;
}

// Multi-symbol stream (intra mode maps, B modes): truncated unary over
// nsym - 1 adaptive bins, conditioned on the previous symbol (mode maps are
// strongly spatially correlated).
// ---------------------------------------------------------------------------
// v9: zigzag-band-conditioned coefficient contexts + dedicated MV coder.
//
// The v8 i16 coder used ONE context set for the whole stream although run/
// level statistics differ sharply by zigzag band (DC runs are short and
// levels large; high-band runs are long and levels almost always +-1).
// Streams are a flat sequence of `block_len`-coefficient zigzag blocks;
// band(p) of the in-block position conditions the run (at its start
// position), the sign and the level contexts. Bit-identical Python mirror:
// io/bitstream.py _py_rc_encode_i16_b / _py_rc_encode_mv.

namespace v9 {

constexpr int kBands = 4;

inline int band(int64_t pos, int32_t block_len) {
    if (block_len <= 0) return 0;
    int p = (int)(pos % block_len);
    if (p == 0) return 0;
    if (p < 4) return 1;
    if (p < block_len / 4) return 2;
    return 3;
}

constexpr int kMvCap = 8;

}  // namespace v9

int64_t vcs_rc_encode_i16_b(const int16_t* data, int64_t n,
                            int32_t block_len, uint8_t* out,
                            int64_t out_cap) {
    rc::Encoder e{out, out_cap};
    uint16_t run_bins[v9::kBands][rc::kRunCap];
    uint16_t lev_bins[v9::kBands][rc::kLevCap];
    uint16_t sign_p[v9::kBands];
    for (int b = 0; b < v9::kBands; ++b) {
        for (auto& p : run_bins[b]) p = rc::kProbInit;
        for (auto& p : lev_bins[b]) p = rc::kProbInit;
        sign_p[b] = rc::kProbInit;
    }
    int64_t i = 0;
    while (i < n) {
        int64_t run = 0;
        while (i + run < n && data[i + run] == 0) ++run;
        e.tu(run_bins[v9::band(i, block_len)], rc::kRunCap, (uint32_t)run);
        i += run;
        if (i >= n) break;
        int b = v9::band(i, block_len);
        int32_t v = data[i++];
        e.bit(&sign_p[b], v < 0);
        uint32_t m = (uint32_t)(v < 0 ? -v : v) - 1;
        e.tu(lev_bins[b], rc::kLevCap, m);
    }
    return e.flush();
}

int64_t vcs_rc_decode_i16_b(const uint8_t* in, int64_t nbytes,
                            int32_t block_len, int16_t* out,
                            int64_t n_out) {
    rc::Decoder d{in, nbytes};
    d.init();
    uint16_t run_bins[v9::kBands][rc::kRunCap];
    uint16_t lev_bins[v9::kBands][rc::kLevCap];
    uint16_t sign_p[v9::kBands];
    for (int b = 0; b < v9::kBands; ++b) {
        for (auto& p : run_bins[b]) p = rc::kProbInit;
        for (auto& p : lev_bins[b]) p = rc::kProbInit;
        sign_p[b] = rc::kProbInit;
    }
    int64_t i = 0;
    while (i < n_out) {
        uint32_t run = d.tu(run_bins[v9::band(i, block_len)], rc::kRunCap);
        if (d.error) return -1;
        for (uint32_t k = 0; k < run && i < n_out; ++k) out[i++] = 0;
        if (i >= n_out) break;
        int b = v9::band(i, block_len);
        int neg = d.bit(&sign_p[b]);
        uint32_t m = d.tu(lev_bins[b], rc::kLevCap);
        if (d.error) return -1;
        int32_t v = (int32_t)m + 1;
        out[i++] = (int16_t)(neg ? -v : v);
    }
    return i;
}

// v10: per-block coded-block-flag + in-block runs/levels + end-of-block
// flag. The v8/v9 token structure let zero runs cross block boundaries, so
// every inter-block gap paid a truncated-unary + exp-Golomb tail (~20 bits
// per gap on sparse streams); a CBF bit conditioned on the previous block's
// CBF costs ~0.1 bit per zero block instead, and an EOB flag after each
// level replaces the trailing run. Measured on real QF50 coefficient
// streams: -37% vs the v8 coder (tools/exp_entropy.py). Band contexts as
// in v9. Streams must be a whole number of block_len blocks.
int64_t vcs_rc_encode_i16_cbf(const int16_t* data, int64_t n,
                              int32_t block_len, uint8_t* out,
                              int64_t out_cap) {
    if (block_len <= 0 || n % block_len) return -2;
    rc::Encoder e{out, out_cap};
    uint16_t run_bins[v9::kBands][rc::kRunCap];
    uint16_t lev_bins[v9::kBands][rc::kLevCap];
    uint16_t sign_p[v9::kBands], eob_p[v9::kBands], cbf_p[2];
    for (int b = 0; b < v9::kBands; ++b) {
        for (auto& p : run_bins[b]) p = rc::kProbInit;
        for (auto& p : lev_bins[b]) p = rc::kProbInit;
        sign_p[b] = rc::kProbInit;
        eob_p[b] = rc::kProbInit;
    }
    cbf_p[0] = cbf_p[1] = rc::kProbInit;
    int prev_cbf = 0;
    for (int64_t blk = 0; blk < n; blk += block_len) {
        const int16_t* d = data + blk;
        int last_nz = -1;
        for (int p = 0; p < block_len; ++p)
            if (d[p] != 0) last_nz = p;
        int cbf = last_nz >= 0;
        e.bit(&cbf_p[prev_cbf], cbf);
        prev_cbf = cbf;
        if (!cbf) continue;
        int pos = 0;
        while (pos <= last_nz) {
            int run = 0;
            while (d[pos + run] == 0) ++run;
            e.tu(run_bins[v9::band(pos, block_len)], rc::kRunCap,
                 (uint32_t)run);
            pos += run;
            int b = v9::band(pos, block_len);
            int32_t v = d[pos];
            e.bit(&sign_p[b], v < 0);
            e.tu(lev_bins[b], rc::kLevCap,
                 (uint32_t)(v < 0 ? -v : v) - 1);
            e.bit(&eob_p[b], pos == last_nz);
            ++pos;
        }
    }
    return e.flush();
}

int64_t vcs_rc_decode_i16_cbf(const uint8_t* in, int64_t nbytes,
                              int32_t block_len, int16_t* out,
                              int64_t n_out) {
    if (block_len <= 0 || n_out % block_len) return -2;
    rc::Decoder d{in, nbytes};
    d.init();
    uint16_t run_bins[v9::kBands][rc::kRunCap];
    uint16_t lev_bins[v9::kBands][rc::kLevCap];
    uint16_t sign_p[v9::kBands], eob_p[v9::kBands], cbf_p[2];
    for (int b = 0; b < v9::kBands; ++b) {
        for (auto& p : run_bins[b]) p = rc::kProbInit;
        for (auto& p : lev_bins[b]) p = rc::kProbInit;
        sign_p[b] = rc::kProbInit;
        eob_p[b] = rc::kProbInit;
    }
    cbf_p[0] = cbf_p[1] = rc::kProbInit;
    for (int64_t i = 0; i < n_out; ++i) out[i] = 0;
    int prev_cbf = 0;
    for (int64_t blk = 0; blk < n_out; blk += block_len) {
        int cbf = d.bit(&cbf_p[prev_cbf]);
        prev_cbf = cbf;
        if (!cbf) continue;
        int pos = 0;
        for (;;) {
            uint32_t run = d.tu(run_bins[v9::band(pos, block_len)],
                                rc::kRunCap);
            if (d.error) return -1;
            pos += (int)run;
            if (pos >= block_len) return -1;
            int b = v9::band(pos, block_len);
            int neg = d.bit(&sign_p[b]);
            uint32_t m = d.tu(lev_bins[b], rc::kLevCap);
            if (d.error) return -1;
            int32_t v = (int32_t)m + 1;
            out[blk + pos] = (int16_t)(neg ? -v : v);
            int eob = d.bit(&eob_p[b]);
            ++pos;
            if (eob) break;
            if (pos >= block_len) return -1;
        }
    }
    return n_out;
}

// Motion-vector stream: interleaved (dx, dy) components. Contexts: a zero
// flag conditioned on (component, previous same-component value nonzero),
// per-component sign, per-component magnitude TU (cap 8, EG0 tail). MVs are
// mostly zero with small spatially-correlated values — the v8 run/level
// model wasted its run contexts on them.
int64_t vcs_rc_encode_mv(const int16_t* data, int64_t n, uint8_t* out,
                         int64_t out_cap) {
    rc::Encoder e{out, out_cap};
    uint16_t zero_p[4], sign_p[2], mag_bins[2][v9::kMvCap];
    for (auto& p : zero_p) p = rc::kProbInit;
    for (auto& p : sign_p) p = rc::kProbInit;
    for (int c = 0; c < 2; ++c)
        for (auto& p : mag_bins[c]) p = rc::kProbInit;
    int prev_nz[2] = {0, 0};
    for (int64_t i = 0; i < n; ++i) {
        int c = (int)(i & 1);
        int32_t v = data[i];
        int ctx = c * 2 + prev_nz[c];
        e.bit(&zero_p[ctx], v != 0);
        if (v != 0) {
            e.bit(&sign_p[c], v < 0);
            e.tu(mag_bins[c], v9::kMvCap, (uint32_t)(v < 0 ? -v : v) - 1);
        }
        prev_nz[c] = v != 0;
    }
    return e.flush();
}

int64_t vcs_rc_decode_mv(const uint8_t* in, int64_t nbytes, int16_t* out,
                         int64_t n_out) {
    rc::Decoder d{in, nbytes};
    d.init();
    uint16_t zero_p[4], sign_p[2], mag_bins[2][v9::kMvCap];
    for (auto& p : zero_p) p = rc::kProbInit;
    for (auto& p : sign_p) p = rc::kProbInit;
    for (int c = 0; c < 2; ++c)
        for (auto& p : mag_bins[c]) p = rc::kProbInit;
    int prev_nz[2] = {0, 0};
    for (int64_t i = 0; i < n_out; ++i) {
        int c = (int)(i & 1);
        int ctx = c * 2 + prev_nz[c];
        int nz = d.bit(&zero_p[ctx]);
        int32_t v = 0;
        if (nz) {
            int neg = d.bit(&sign_p[c]);
            uint32_t m = d.tu(mag_bins[c], v9::kMvCap);
            if (d.error) return -1;
            v = (int32_t)m + 1;
            if (neg) v = -v;
        }
        out[i] = (int16_t)v;
        prev_nz[c] = nz;
    }
    return n_out;
}

int64_t vcs_rc_encode_u8(const uint8_t* data, int64_t n, int32_t nsym,
                         uint8_t* out, int64_t out_cap) {
    if (nsym < 2 || nsym > 32) return -2;
    rc::Encoder e{out, out_cap};
    const int nb = nsym - 1;
    uint16_t bins[32][31];
    for (int c = 0; c < nsym; ++c)
        for (int j = 0; j < nb; ++j) bins[c][j] = rc::kProbInit;
    int prev = 0;
    for (int64_t i = 0; i < n; ++i) {
        int v = data[i];
        if (v >= nsym) return -2;
        uint16_t* b = bins[prev];
        for (int j = 0; j < v; ++j) e.bit(&b[j], 1);
        if (v < nb) e.bit(&b[v], 0);
        prev = v;
    }
    return e.flush();
}

int64_t vcs_rc_decode_u8(const uint8_t* in, int64_t nbytes,
                         uint8_t* out, int64_t n_out, int32_t nsym) {
    if (nsym < 2 || nsym > 32) return -2;
    rc::Decoder d{in, nbytes};
    d.init();
    const int nb = nsym - 1;
    uint16_t bins[32][31];
    for (int c = 0; c < nsym; ++c)
        for (int j = 0; j < nb; ++j) bins[c][j] = rc::kProbInit;
    int prev = 0;
    for (int64_t i = 0; i < n_out; ++i) {
        uint16_t* b = bins[prev];
        int j = 0;
        while (j < nb && d.bit(&b[j])) ++j;
        out[i] = (uint8_t)j;
        prev = j;
    }
    return n_out;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// v11: spatially- and temporally-conditioned coefficient + mode coding
// (VERDICT r4 Next #5; model shootout in tools/exp_entropy.py round 5).
//
// Coefficient streams move from run/level tokens to an H.264-CABAC-style
// significance map with contexts the v10 coder could not express:
//   * block CBF conditioned on (left, up, temporal co-located, and the
//     luma co-located block for chroma) CBFs — P-frame residual energy is
//     spatially and temporally persistent;
//   * per-position significance flags conditioned on (zigzag position
//     bucket, the co-located PREVIOUS frame's significance at that
//     position, the previous position's significance);
//   * levels keep the v9 band contexts plus a sticky any-level>1 state;
//   * an explicit last-coefficient flag replaces run+EOB tokens.
// Measured (entropy tally, 24f QF50): -13.9% / -11.5% vs the v10 CBF coder
// on the two R-D videos' P-coefficient streams. A median-predicted MV
// residual coder and an MPM-flag mode coder were ALSO built and measured
// WORSE than v10 (see tools/exp_entropy.py round-5 notes) — v11 keeps the
// v9 MV coder and uses a (left, up)-pair context for mode maps (+2.3%).
//
// Stream geometry: frames x channels x nbh x nbw blocks of block_len
// zigzag coefficients, raster order. Bit-identical Python mirror:
// io/bitstream.py _py_rc_encode_i16_sig / _py_rc_encode_modes2d.
//
// Two pairs of entry points code the same bytes. vcs_rc_*_i16_sig take the
// coefficients already in that stream order. vcs_rc_*_i16_sig_raster take
// the planes themselves, an int16 [nf, nc, H, W] stack of bs x bs blocks,
// and the block's scan order as a table of bs*bs int32 raster indices
// (io/bitstream.py passes ops/quant.py zigzag_order_np(bs)): the encoder
// skips a block of zeros and gathers any other through the table into a
// stack buffer, and the decoder stores each significant level straight at
// its raster place, so no scanned copy of the planes exists. Both pairs run one block body
// (SigCoder below) and one block order; the raster encoder's bytes equal
// vcs_rc_encode_i16_sig's on the scanned planes. A decoder that reads past
// the end of its blob, which the encoder's flush never makes it do, fails:
// the blob was cut short.

namespace v11 {

constexpr int kPosBuckets = 17;      // min(pos, 16)
constexpr int kMaxBlockLen = 4096;

inline int posb(int p) { return p < 16 ? p : 16; }

struct SigCtx {
    uint16_t cbf[24];                 // (l, u, tm, ych{0,1,2})
    uint16_t sig[kPosBuckets * 6];    // (posb, tctx{0,1,2}, prevsig)
    uint16_t last[kPosBuckets];
    uint16_t sign[v9::kBands];
    uint16_t lev[v9::kBands * 2][rc::kLevCap];   // (band, gt1)
    SigCtx() {
        for (auto& p : cbf) p = rc::kProbInit;
        for (auto& p : sig) p = rc::kProbInit;
        for (auto& p : last) p = rc::kProbInit;
        for (auto& p : sign) p = rc::kProbInit;
        for (auto& b : lev)
            for (auto& p : b) p = rc::kProbInit;
    }
};

// The coder's state over one stream: contexts, the CBFs of every block so
// far and the significance of the previous frame's co-located blocks.
struct SigCoder {
    int64_t bpp, bpf, nblk;           // blocks per plane, frame, stream
    int nbw, bl;
    SigCtx cx;
    uint8_t* sig_prev;
    uint8_t* sig_cur;
    uint8_t* cbfs;

    SigCoder(int32_t nf, int32_t nc, int32_t nbh, int32_t nbw_,
             int32_t block_len)
        : bpp((int64_t)nbh * nbw_), bpf(bpp * nc), nblk(bpf * nf),
          nbw(nbw_), bl(block_len),
          sig_prev(new uint8_t[bpf * block_len]()),
          sig_cur(new uint8_t[bpf * block_len]()),
          cbfs(new uint8_t[nblk]()) {}
    SigCoder(const SigCoder&) = delete;
    SigCoder& operator=(const SigCoder&) = delete;
    ~SigCoder() { delete[] sig_prev; delete[] sig_cur; delete[] cbfs; }

    // Block bi's frame, its place within the frame, and its CBF context.
    struct At { int64_t fi, rem, row, col; int cbf_ctx; };
    At at(int64_t bi) const {
        At a;
        a.fi = bi / bpf;
        a.rem = bi % bpf;
        int64_t ch = a.rem / bpp, pi = a.rem % bpp;
        a.col = pi % nbw;
        a.row = pi / nbw;
        int l = a.col ? cbfs[bi - 1] : 0;
        int u = a.row ? cbfs[bi - nbw] : 0;
        int tm = a.fi ? cbfs[bi - bpf] : 0;
        int ych = ch ? cbfs[bi - ch * bpp] : 2;
        a.cbf_ctx = ((l * 2 + u) * 2 + tm) * 3 + ych;
        return a;
    }

    // One block: blk holds its bl coefficients in scan order, last the
    // scan position of its last nonzero one (-1: none).
    void encode(rc::Encoder& e, int64_t bi, const At& a, const int16_t* blk,
                int last) {
        int cbf = last >= 0;
        e.bit(&cx.cbf[a.cbf_ctx], cbf);
        cbfs[bi] = (uint8_t)cbf;
        uint8_t* sp = sig_prev + a.rem * bl;
        uint8_t* sc = sig_cur + a.rem * bl;
        memset(sc, 0, bl);
        if (cbf) {
            int gt1 = 0, prevsig = 1;
            for (int p = 0; p <= last; ++p) {
                int v = blk[p];
                int sig = v != 0;
                int tctx = a.fi ? sp[p] : 2;
                if (p < bl - 1)
                    e.bit(&cx.sig[(posb(p) * 3 + tctx) * 2 + prevsig], sig);
                prevsig = sig;
                if (sig) {
                    sc[p] = 1;
                    int b = v9::band(p, bl);
                    e.bit(&cx.sign[b], v < 0);
                    uint32_t m = (uint32_t)(v < 0 ? -v : v) - 1;
                    e.tu(cx.lev[b * 2 + gt1], rc::kLevCap, m);
                    if (v > 1 || v < -1) gt1 = 1;
                    if (p < bl - 1)
                        e.bit(&cx.last[posb(p)], p == last);
                }
            }
        }
        memcpy(sp, sc, bl);
    }

    // One block into a zeroed blk: the level of scan position p goes to
    // blk[place[p]]. False on a malformed level code.
    bool decode(rc::Decoder& d, int64_t bi, const At& a, int16_t* blk,
                const int32_t* place) {
        int cbf = d.bit(&cx.cbf[a.cbf_ctx]);
        cbfs[bi] = (uint8_t)cbf;
        uint8_t* sp = sig_prev + a.rem * bl;
        uint8_t* sc = sig_cur + a.rem * bl;
        memset(sc, 0, bl);
        if (cbf) {
            int gt1 = 0, prevsig = 1;
            for (int p = 0; p < bl; ++p) {
                int tctx = a.fi ? sp[p] : 2;
                int sig = p < bl - 1
                    ? d.bit(&cx.sig[(posb(p) * 3 + tctx) * 2 + prevsig])
                    : 1;
                prevsig = sig;
                if (!sig) continue;
                sc[p] = 1;
                int b = v9::band(p, bl);
                int neg = d.bit(&cx.sign[b]);
                uint32_t m = d.tu(cx.lev[b * 2 + gt1], rc::kLevCap);
                if (d.error) return false;
                int32_t v = (int32_t)m + 1;
                blk[place[p]] = (int16_t)(neg ? -v : v);
                if (v > 1) gt1 = 1;
                if (p == bl - 1) break;
                if (d.bit(&cx.last[posb(p)])) break;
            }
        }
        memcpy(sp, sc, bl);
        return true;
    }
};

// The values of a stream of nf x nc x nbh x nbw blocks of block_len.
inline int64_t sig_values(int32_t nf, int32_t nc, int32_t nbh, int32_t nbw,
                          int32_t block_len) {
    return (int64_t)nbh * nbw * nc * nf * block_len;
}

inline int last_nonzero(const int16_t* blk, int bl) {
    for (int p = bl - 1; p >= 0; --p)
        if (blk[p]) return p;
    return -1;
}

// Raster planes [nf * nc, h, w] in blocks of bs x bs. False where the
// geometry does not tile or the order table is not of the block.
struct Raster {
    int64_t h, w;
    int bs, bl;
    int32_t place[kMaxBlockLen];      // scan position -> offset in a plane

    bool init(int32_t h_, int32_t w_, int32_t bs_, const int32_t* order) {
        if (bs_ < 2 || bs_ > 64 || h_ <= 0 || w_ <= 0 || h_ % bs_ ||
            w_ % bs_)
            return false;
        h = h_; w = w_; bs = bs_; bl = bs_ * bs_;
        for (int p = 0; p < bl; ++p) {
            if (order[p] < 0 || order[p] >= bl) return false;
            place[p] = (int32_t)((order[p] / bs) * w + order[p] % bs);
        }
        return true;
    }
};

// The raster pair's block loops, in the block order of the stream pair.
// BS is bs when it is a constant the loops unroll to (4, 8, 16), else 0.
template <int BS>
void encode_planes(SigCoder& s, rc::Encoder& e, const Raster& r,
                   const int16_t* data) {
    const int bs = BS ? BS : r.bs, bl = bs * bs;
    const int64_t w = r.w, nbh = r.h / bs, nbw = r.w / bs;
    int16_t blk[kMaxBlockLen];
    int64_t bi = 0;
    for (int64_t pl = 0; pl < s.nblk / s.bpp; ++pl)
        for (int64_t row = 0; row < nbh; ++row) {
            const int16_t* strip = data + (pl * r.h + row * bs) * w;
            for (int64_t col = 0; col < nbw; ++col, ++bi) {
                const int16_t* src = strip + col * bs;
                int any = 0;
                for (int y = 0; y < bs; ++y)
                    for (int x = 0; x < bs; ++x) any |= src[y * w + x];
                int last = -1;
                if (any) {
                    for (int p = 0; p < bl; ++p) blk[p] = src[r.place[p]];
                    last = last_nonzero(blk, bl);
                }
                s.encode(e, bi, s.at(bi), blk, last);
            }
        }
}

// Zeroes each strip of a block row just before its blocks are decoded
// into it, while it is in cache. False on a malformed level code.
template <int BS>
bool decode_planes(SigCoder& s, rc::Decoder& d, const Raster& r,
                   int16_t* out) {
    const int bs = BS ? BS : r.bs;
    const int64_t w = r.w, nbh = r.h / bs, nbw = r.w / bs;
    int64_t bi = 0;
    for (int64_t pl = 0; pl < s.nblk / s.bpp; ++pl)
        for (int64_t row = 0; row < nbh; ++row) {
            int16_t* strip = out + (pl * r.h + row * bs) * w;
            memset(strip, 0, (size_t)bs * w * sizeof(int16_t));
            for (int64_t col = 0; col < nbw; ++col, ++bi)
                if (!s.decode(d, bi, s.at(bi), strip + col * bs, r.place))
                    return false;
        }
    return true;
}

}  // namespace v11

extern "C" {

int64_t vcs_rc_encode_i16_sig(const int16_t* data, int64_t n,
                              int32_t nf, int32_t nc, int32_t nbh,
                              int32_t nbw, int32_t block_len,
                              uint8_t* out, int64_t out_cap) {
    if (nf <= 0 || nc <= 0 || nbh <= 0 || nbw <= 0 || block_len < 2 ||
        block_len > v11::kMaxBlockLen)
        return -2;
    if (n != v11::sig_values(nf, nc, nbh, nbw, block_len)) return -2;
    v11::SigCoder s(nf, nc, nbh, nbw, block_len);
    rc::Encoder e{out, out_cap};
    for (int64_t bi = 0; bi < s.nblk; ++bi) {
        const int16_t* blk = data + bi * block_len;
        s.encode(e, bi, s.at(bi), blk, v11::last_nonzero(blk, block_len));
    }
    return e.flush();
}

int64_t vcs_rc_decode_i16_sig(const uint8_t* in, int64_t nbytes,
                              int16_t* out, int64_t n_out,
                              int32_t nf, int32_t nc, int32_t nbh,
                              int32_t nbw, int32_t block_len) {
    if (nf <= 0 || nc <= 0 || nbh <= 0 || nbw <= 0 || block_len < 2 ||
        block_len > v11::kMaxBlockLen)
        return -2;
    if (n_out != v11::sig_values(nf, nc, nbh, nbw, block_len)) return -2;
    v11::SigCoder s(nf, nc, nbh, nbw, block_len);
    int32_t place[v11::kMaxBlockLen];
    for (int p = 0; p < block_len; ++p) place[p] = p;
    rc::Decoder d{in, nbytes};
    d.init();
    memset(out, 0, (size_t)n_out * sizeof(int16_t));
    for (int64_t bi = 0; bi < s.nblk; ++bi)
        if (!s.decode(d, bi, s.at(bi), out + bi * block_len, place))
            return -1;
    return d.past_end ? -1 : n_out;
}

// data: C-contiguous int16 planes [nf, nc, h, w]; order: bs*bs int32, the
// raster index within a block of each scan position.
int64_t vcs_rc_encode_i16_sig_raster(const int16_t* data, int64_t n,
                                     int32_t nf, int32_t nc, int32_t h,
                                     int32_t w, int32_t bs,
                                     const int32_t* order,
                                     uint8_t* out, int64_t out_cap) {
    v11::Raster r;
    if (nf <= 0 || nc <= 0 || !r.init(h, w, bs, order)) return -2;
    if (n != v11::sig_values(nf, nc, h / bs, w / bs, r.bl)) return -2;
    v11::SigCoder s(nf, nc, h / bs, w / bs, r.bl);
    rc::Encoder e{out, out_cap};
    switch (bs) {
        case 4: v11::encode_planes<4>(s, e, r, data); break;
        case 8: v11::encode_planes<8>(s, e, r, data); break;
        case 16: v11::encode_planes<16>(s, e, r, data); break;
        default: v11::encode_planes<0>(s, e, r, data);
    }
    return e.flush();
}

int64_t vcs_rc_decode_i16_sig_raster(const uint8_t* in, int64_t nbytes,
                                     int16_t* out, int64_t n_out,
                                     int32_t nf, int32_t nc, int32_t h,
                                     int32_t w, int32_t bs,
                                     const int32_t* order) {
    v11::Raster r;
    if (nf <= 0 || nc <= 0 || !r.init(h, w, bs, order)) return -2;
    if (n_out != v11::sig_values(nf, nc, h / bs, w / bs, r.bl)) return -2;
    v11::SigCoder s(nf, nc, h / bs, w / bs, r.bl);
    rc::Decoder d{in, nbytes};
    d.init();
    bool ok;
    switch (bs) {
        case 4: ok = v11::decode_planes<4>(s, d, r, out); break;
        case 8: ok = v11::decode_planes<8>(s, d, r, out); break;
        case 16: ok = v11::decode_planes<16>(s, d, r, out); break;
        default: ok = v11::decode_planes<0>(s, d, r, out);
    }
    return !ok || d.past_end ? -1 : n_out;
}

// Mode maps (v11): truncated unary conditioned on the (left, up) neighbor
// PAIR (unavailable neighbors substitute the available one / 0). +2.3% vs
// the prev-symbol-only v10 contexts on real intra mode maps; an H.264-style
// MPM-flag variant measured WORSE (tools/exp_entropy.py round-5 notes).
int64_t vcs_rc_encode_modes2d(const uint8_t* data, int64_t n,
                              int32_t rows, int32_t cols, int32_t nsym,
                              uint8_t* out, int64_t out_cap) {
    if (nsym < 2 || nsym > 32) return -2;
    if (rows <= 0 || cols <= 0 || n % ((int64_t)rows * cols)) return -2;
    rc::Encoder e{out, out_cap};
    const int nb = nsym - 1;
    uint16_t* bins = new uint16_t[(size_t)nsym * nsym * nb];
    for (int64_t i = 0; i < (int64_t)nsym * nsym * nb; ++i)
        bins[i] = rc::kProbInit;
    for (int64_t i = 0; i < n; ++i) {
        int v = data[i];
        if (v >= nsym) { delete[] bins; return -2; }
        int col = (int)(i % cols);
        int64_t row = (i / cols) % rows;
        int left = col ? data[i - 1] : -1;
        int up = row ? data[i - cols] : -1;
        int l = left >= 0 ? left : (up >= 0 ? up : 0);
        int u = up >= 0 ? up : l;
        uint16_t* b = bins + (size_t)(l * nsym + u) * nb;
        for (int j = 0; j < v; ++j) e.bit(&b[j], 1);
        if (v < nb) e.bit(&b[v], 0);
    }
    delete[] bins;
    return e.flush();
}

int64_t vcs_rc_decode_modes2d(const uint8_t* in, int64_t nbytes,
                              uint8_t* out, int64_t n_out,
                              int32_t rows, int32_t cols, int32_t nsym) {
    if (nsym < 2 || nsym > 32) return -2;
    if (rows <= 0 || cols <= 0 || n_out % ((int64_t)rows * cols)) return -2;
    rc::Decoder d{in, nbytes};
    d.init();
    const int nb = nsym - 1;
    uint16_t* bins = new uint16_t[(size_t)nsym * nsym * nb];
    for (int64_t i = 0; i < (int64_t)nsym * nsym * nb; ++i)
        bins[i] = rc::kProbInit;
    for (int64_t i = 0; i < n_out; ++i) {
        int col = (int)(i % cols);
        int64_t row = (i / cols) % rows;
        int left = col ? out[i - 1] : -1;
        int up = row ? out[i - cols] : -1;
        int l = left >= 0 ? left : (up >= 0 ? up : 0);
        int u = up >= 0 ? up : l;
        uint16_t* b = bins + (size_t)(l * nsym + u) * nb;
        int j = 0;
        while (j < nb && d.bit(&b[j])) ++j;
        out[i] = (uint8_t)j;
    }
    delete[] bins;
    return n_out;
}

}  // extern "C"
