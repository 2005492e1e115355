// K5 / K6: closed-loop lossy 4x4 intra encode and the wavefront intra decode.
//
// Replaces the TPU kernels in vcs_h264_tpu/ops/intra_pallas.py:
//   K5 encode: _enc_kernel (_enc_substep), launched by encode_lossy_planes;
//   K6 decode: _dec_kernel (_dec_substep), launched by decode_planes.
// The 0/1 selection-matrix matmul that forms the 9 predictors, the kron(Cf, Cf)
// transform matmuls, the skewed lane layout (_skew / _unskew), _KDIAG
// sub-steps, int8 recentering and the VMEM budget are TPU devices that change
// no result and are not carried over.
//
// What they compute, per plane, block by block in wavefront order (block
// (bi, bj) on anti-diagonal t = 2 bi + bj depends only on blocks of smaller
// t, and the blocks of one diagonal are independent):
//   neighbours from the reconstruction: u (bottom row of (bi-1, bj)), l
//   (right column of (bi, bj-1)), ul (corner of (bi-1, bj-1)), ur (bottom
//   row of (bi-1, bj+1)); positional availability, 128 fills, ur falls back
//   to u[3] (128 without u); the 9 H.264 predictors with the reference's
//   floor divisions and its uint8 wraps where the operands came from the
//   plane (ops/intra.py in either package spells them out);
//   encode: key = SAD * 16 + mode + 1 against the original block, first
//     minimum from the sentinel 16*255*16, so strict < and the lowest mode
//     wins a tie; no key below the sentinel = escape (zero prediction, mode
//     0); q = iround(Cf X Cf^T * 400G, 400 qstep), recon = clip(pred +
//     iround((2Ci)(q qstep)(2Ci)^T, 4), 0, 255), round half away from zero;
//   decode: the same prediction from the stored mode (zero for an escape or a
//     mode outside 0..8), plus the dequantized residual (qstep > 0) or the
//     exact residual (qstep == 0), clipped when asked.
// All arithmetic is int32, so the kernels are bit-identical to the plain
// PyTorch versions and to the JAX package. `>>` on a signed int is an
// arithmetic shift, i.e. the floor division `//` of the reference.
//
// What bounds them on an H100: the chain of T = 2 (nbh - 1) + nbw dependent
// diagonals (678 at 1280x720), not bytes or operations. Each plane reads its
// 1 byte per pixel once and writes 2 + 1 bytes per pixel (qcoef, recon) once,
// a few MB for a 24-plane batch. What a step costs is the integer instruction
// stream of one block, run by the few warps of the one SM that holds the
// plane, and the stores of its outputs: the threads of a warp sit in
// different block rows, so every store of a warp goes to 32 lines.
//
// K6 has a note of its own before its kernels.
//
// Design, both kernels: one CTA per plane and one thread per block row (a
// thread loops over rows when a plane has more rows than the CTA threads);
// at step t the thread of row bi codes block (bi, t - 2 bi), then the CTA
// meets at one __syncthreads(). The carry stays on chip in shared memory:
// per block row, a ring of the bottom rows of its last four blocks (the row
// below reads u, ur and the ul corner from it one to three steps later) and
// the right column of its last block (the row's own next block reads l).
//
// K5 is built to shorten that instruction stream (about 900 instructions a
// block, from about 1 400) and to take device memory off the step:
//   * pixels travel four to a 32-bit word: the original block is four words,
//     the carry one word per ring slot and one for the left column (5 words
//     a block row; K6's unclipped form keeps 20 ints), recon rows are stored
//     as words;
//   * the nine predictors are formed as scalars once (every value lies in
//     0..255) and packed into rows, shared sub-expressions between the modes
//     computed once, diagonal modes cut out of a packed sequence with
//     __funnelshift_r; a predictor's SAD is four vabsdiff4 with accumulate;
//   * the forward quantiser's 16 divisions by 800 qstep are one __umulhi and
//     a shift each, with a magic number the wrapper computes for the launch
//     (ops/intra_cuda.py:quant_magic), exact for every numerator the
//     transform can produce;
//   * the original pixels depend on nothing the chain computes, so a thread
//     loads those of its row's next block a step ahead, and no step waits
//     for device memory;
//   * a row thread stores nothing to device memory. It leaves a block's
//     outputs in shared memory, eight blocks of a row to a group, and two
//     more warps of the CTA, which code nothing, write each finished group
//     out whole: a pixel row's 32 bytes of recon and 64 of qcoef side by
//     side, a few sectors an instruction. Ten stores a block to lines of
//     their own had cost a third of the kernel's time.
// Those two points need a thread per block row, and the launcher
// (vcs_intra_encode) takes K5's form from its caller, who chooses it from the
// plane's height alone (ops/intra_cuda.py:encode_form):
//   * the staged form, up to kEncRowWarps row warps (256 block rows: 720p,
//     4:2:0 chroma at 1080p) and the flush warps, a thread may hold 204
//     registers: intra_encode_kernel, 1.05 us a step at 720p;
//   * the tall form, kTallRowWarps row warps and the flush warps, 352
//     threads and 184 registers (the body needs about 110), up to kTallRows
//     block rows, where a row's carry and staged outputs fill shared memory:
//     intra_encode_kernel_tall, the same body, for 1072, 1080 and 1088-row
//     luma planes, 1.31 us a step on one plane of 1072 x 1920 and 1.69 on
//     eight, against 1.98 and 2.12 in the direct form. At that width a step
//     costs more than at 720p even on one plane, and more again once four or
//     more planes run: three, four or six flush warps, and the original
//     pixels loaded two to four steps ahead, were each no faster;
//   * the direct form past kTallRows block rows (4K): intra_encode_kernel,
//     each thread loops over its rows, loads on the chain and stores a
//     block's outputs itself.
// A 24-plane batch still fills only 24 of the 132 SMs. Cutting a plane into
// slices of block rows over several CTAs, the carry handed down through
// device memory with a count per slice, gave identical results and no gain
// (the fences of the hand-over cost what the idle SMs gave), so it is not
// here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFill = 128;
constexpr int kSentinelKey = 16 * 255 * 16;
constexpr int kRowInts = 20;     // K6, int form: shared ints per block row, ring 4 x 4 and left column 4
constexpr int kEncRowWords = 5;  // K5: packed words per block row, ring 4 and left column 1
constexpr int kEncThreads = 320; // K5: most threads of a CTA; a thread may hold 204 registers
constexpr int kFlushWarps = 2;   // K5: warps of a CTA that write the staged outputs out
constexpr int kEncRowWarps = kEncThreads / 32 - kFlushWarps;     // K5, staged form: 256 block rows
constexpr int kTallRowWarps = 9;                                 // K5, tall form: row warps
constexpr int kTallThreads = 32 * (kTallRowWarps + kFlushWarps); // 352: 184 registers a thread
constexpr int kGroup = 8;        // K5: blocks of a row whose outputs are written out together
constexpr int kTileWords = 12 * kGroup + 4;      // K5: a staged group, see stage_block
constexpr int kStageWords = 2 * kTileWords + 1;  // K5: two groups a block row; odd, so rows spread over the banks
constexpr int kSmemMax = 232448;                 // dynamic shared memory a CTA may opt into
constexpr int kTallRows = kSmemMax / (4 * (kEncRowWords + kStageWords));  // 282 block rows
static_assert(kTallRows <= 32 * kTallRowWarps, "a tall plane's rows outnumber its row threads");

struct Neighbors {
  int u[4], l[4], ur[4], ul;
  bool a_u, a_l, a_ur;
};

__device__ __forceinline__ int w3(int x, bool wrap) {
  const int t = 3 * x;
  return wrap ? (t & 255) : t;
}

// a/4 + b/2 + c/4 and a/2 + b/2 with floor divisions
__device__ __forceinline__ int f3(int a, int b, int c) { return (a >> 2) + (b >> 1) + (c >> 2); }
__device__ __forceinline__ int f2(int a, int b) { return (a >> 1) + (b >> 1); }

__device__ __forceinline__ void set_rows(int p[16], int r0a, int r0b, int r0c, int r0d, int r1a,
                                         int r1b, int r1c, int r1d, int r2a, int r2b, int r2c,
                                         int r2d, int r3a, int r3b, int r3c, int r3d) {
  p[0] = r0a; p[1] = r0b; p[2] = r0c; p[3] = r0d;
  p[4] = r1a; p[5] = r1b; p[6] = r1c; p[7] = r1d;
  p[8] = r2a; p[9] = r2b; p[10] = r2c; p[11] = r2d;
  p[12] = r3a; p[13] = r3b; p[14] = r3c; p[15] = r3d;
}

// Prediction p[r * 4 + c] of `mode`; zeros for a mode outside 0..8.
__device__ __forceinline__ void predict(int mode, const Neighbors& n, int p[16]) {
  const int* u = n.u;
  const int* l = n.l;
  const int* ur = n.ur;
  const int ul = n.ul;
  switch (mode) {
    case 0:  // vertical
#pragma unroll
      for (int i = 0; i < 16; ++i) p[i] = u[i & 3];
      break;
    case 1:  // horizontal
#pragma unroll
      for (int i = 0; i < 16; ++i) p[i] = l[i >> 2];
      break;
    case 2: {  // dc: u + l wraps when both came from the plane
      int s = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int v = u[k] + l[k];
        s += (n.a_u && n.a_l) ? (v & 255) : v;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) p[i] = s >> 3;
      break;
    }
    case 3: {  // down-left over e = u, ur
      const int e[8] = {u[0], u[1], u[2], u[3], ur[0], ur[1], ur[2], ur[3]};
      int t[7];
#pragma unroll
      for (int s = 0; s < 6; ++s) t[s] = f3(e[s], e[s + 1], e[s + 2]);
      t[6] = (e[6] >> 2) + (w3(e[7], n.a_ur) >> 2);
#pragma unroll
      for (int i = 0; i < 16; ++i) p[i] = t[(i >> 2) + (i & 3)];
      break;
    }
    case 4: {  // down-right: d[c - r + 3]
      int d[7];
      d[6] = f3(u[1], u[2], u[3]);
      d[5] = f3(u[0], u[1], u[2]);
      d[4] = f3(ul, u[0], u[1]);
      d[3] = (ul >> 2) + (u[0] >> 1) + (l[0] >> 2);
      d[2] = (u[0] >> 2) + (l[0] >> 1) + (l[1] >> 2);
      d[1] = f3(l[0], l[1], l[2]);
      d[0] = f3(l[1], l[2], l[3]);
#pragma unroll
      for (int i = 0; i < 16; ++i) p[i] = d[(i & 3) - (i >> 2) + 3];
      break;
    }
    case 5: {  // vertical-right
      const int a0 = f2(ul, u[0]), a1 = f2(u[0], u[1]), a2 = f2(u[1], u[2]), a3 = f2(u[2], u[3]);
      const int b0 = (u[0] >> 2) + (ul >> 1) + (l[0] >> 2);
      const int b1 = f3(ul, u[0], u[1]), b2 = f3(u[0], u[1], u[2]), b3 = f3(u[1], u[2], u[3]);
      const int c0 = f3(ul, l[0], l[1]), d0 = f3(l[0], l[1], l[2]);
      set_rows(p, a0, a1, a2, a3, b0, b1, b2, b3, c0, a0, a1, a2, d0, b0, b1, b2);
      break;
    }
    case 6: {  // horizontal-down
      const int a0 = f2(ul, l[0]);
      const int a1 = (u[0] >> 2) + (ul >> 1) + (l[0] >> 2);
      const int a2 = f3(ul, u[0], u[1]), a3 = f3(u[0], u[1], u[2]);
      const int b0 = f2(l[0], l[1]), b1 = f3(ul, l[1], l[2]);
      const int c0 = f2(l[1], l[2]), c1 = f3(l[0], l[1], l[2]);
      const int d0 = f2(l[2], l[3]), d1 = f3(l[1], l[2], l[3]);
      set_rows(p, a0, a1, a2, a3, b0, b1, a0, a1, c0, c1, b0, b1, d0, d1, c0, c1);
      break;
    }
    case 7: {  // vertical-left
      const int a0 = f2(u[0], u[1]), a1 = f2(u[1], u[2]), a2 = f2(u[2], u[3]);
      const int a3 = f2(u[3], ur[0]), a4 = f2(ur[0], ur[1]);
      const int b0 = f3(u[0], u[1], u[2]), b1 = f3(u[1], u[2], u[3]), b2 = f3(u[2], u[3], ur[0]);
      const int b3 = f3(u[3], ur[0], ur[1]), b4 = f3(ur[0], ur[1], ur[2]);
      set_rows(p, a0, a1, a2, a3, b0, b1, b2, b3, a1, a2, a3, a4, b1, b2, b3, b4);
      break;
    }
    case 8: {  // horizontal-up: 3 l[3] wraps when l came from the plane
      const int a0 = f2(l[0], l[1]), a1 = f3(l[0], l[1], l[2]);
      const int a2 = f2(l[1], l[2]), a3 = f3(l[1], l[2], l[3]);
      const int b2 = f2(l[2], l[3]);
      const int b3 = (l[2] >> 2) + (w3(l[3], n.a_l) >> 2);
      const int c = l[3];
      set_rows(p, a0, a1, a2, a3, a2, a3, b2, b3, b2, b3, c, c, c, c, c, c);
      break;
    }
    default:
#pragma unroll
      for (int i = 0; i < 16; ++i) p[i] = 0;
  }
}

// v <- Cf v and v <- (2Ci) v for a 4-vector with stride s
__device__ __forceinline__ void cf4(int* v, int s) {
  const int a = v[0], b = v[s], c = v[2 * s], d = v[3 * s];
  v[0] = a + b + c + d;
  v[s] = 2 * a + b - c - 2 * d;
  v[2 * s] = a - b - c + d;
  v[3 * s] = a - 2 * b + 2 * c - d;
}

__device__ __forceinline__ void ci4x2(int* v, int s) {
  const int a = v[0], b = v[s], c = v[2 * s], d = v[3 * s];
  v[0] = 2 * a + 2 * b + 2 * c + d;
  v[s] = 2 * a + b - 2 * c - 2 * d;
  v[2 * s] = 2 * a - b - 2 * c + 2 * d;
  v[3 * s] = 2 * a - 2 * b + 2 * c - d;
}

// q (quantized coefficients, in place) -> reconstructed residual
__device__ __forceinline__ void dequant_inv(int q[16], int qstep) {
#pragma unroll
  for (int i = 0; i < 16; ++i) q[i] *= qstep;
#pragma unroll
  for (int k = 0; k < 4; ++k) ci4x2(q + k, 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) ci4x2(q + 4 * i, 1);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int m = q[i] < 0 ? -q[i] : q[i];
    const int v = (2 * m + 4) >> 3;
    q[i] = q[i] < 0 ? -v : v;
  }
}

// Neighbours of block (bi, bj) at step t from the shared carry: ring[row][slot]
// holds the bottom row of the row's block of step slot (mod 4), left[row] the
// right column of the row's last block.
__device__ __forceinline__ void load_neighbors(const int* ring, const int* left, int bi, int bj,
                                               int t, int nbw, Neighbors& n) {
  n.a_u = bi >= 1;
  n.a_l = bj >= 1;
  n.a_ur = n.a_u && bj < nbw - 1;
  const bool a_ul = n.a_u && n.a_l;
  const int* up = ring + (n.a_u ? bi - 1 : 0) * 16;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    n.u[k] = n.a_u ? up[((t - 2) & 3) * 4 + k] : kFill;
    n.l[k] = n.a_l ? left[bi * 4 + k] : kFill;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) n.ur[k] = n.a_ur ? up[((t - 1) & 3) * 4 + k] : n.u[3];
  n.ul = a_ul ? up[((t - 3) & 3) * 4 + 3] : kFill;
}

__device__ __forceinline__ void store_carry(int* ring, int* left, int bi, int t, const int rec[16]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ring[bi * 16 + (t & 3) * 4 + k] = rec[12 + k];
    left[bi * 4 + k] = rec[4 * k + 3];
  }
}

// ---- K5: the encode, on packed words -------------------------------------

struct Quantiser {
  int qstep;
  int half;         // 400 qstep, the rounding term of the forward quantiser
  uint32_t magic;   // floor(n / (800 qstep)) == __umulhi(n, magic) >> shift
  int shift;        //   for every numerator n the transform can produce
};

// four pixels of a row, byte c = column c
__device__ __forceinline__ uint32_t pk(int a, int b, int c, int d) {
  return static_cast<uint32_t>(a) | (static_cast<uint32_t>(b) << 8) |
         (static_cast<uint32_t>(c) << 16) | (static_cast<uint32_t>(d) << 24);
}
__device__ __forceinline__ uint32_t rep4(int v) { return static_cast<uint32_t>(v) * 0x01010101u; }
__device__ __forceinline__ int byte_of(uint32_t w, int k) { return static_cast<int>((w >> (8 * k)) & 255u); }

// acc + the sum of the four absolute byte differences of a and b
__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b, uint32_t acc) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(acc));
  return d;
}

// The nine predictors as packed rows p[mode][row], from packed neighbours:
// U, UR the rows above and above-right, L the column to the left (byte k =
// row k), ul the corner. Every predicted value lies in 0..255 (the weights
// of each sum add up to 1 after the floor divisions, the wraps only lower
// it), so a byte holds it. The formulas are those of predict().
__device__ __forceinline__ void predict_all(uint32_t U, uint32_t L, uint32_t UR, int ul, bool a_u,
                                            bool a_l, bool a_ur, uint32_t p[9][4]) {
  const int u0 = byte_of(U, 0), u1 = byte_of(U, 1), u2 = byte_of(U, 2), u3 = byte_of(U, 3);
  const int l0 = byte_of(L, 0), l1 = byte_of(L, 1), l2 = byte_of(L, 2), l3 = byte_of(L, 3);
  const int r0 = byte_of(UR, 0), r1 = byte_of(UR, 1), r2 = byte_of(UR, 2), r3 = byte_of(UR, 3);
  // 0 vertical, 1 horizontal
#pragma unroll
  for (int r = 0; r < 4; ++r) p[0][r] = U;
  p[1][0] = rep4(l0); p[1][1] = rep4(l1); p[1][2] = rep4(l2); p[1][3] = rep4(l3);
  {  // 2 dc: u + l wraps when both came from the plane
    const bool wrap = a_u && a_l;
    const int v0 = u0 + l0, v1 = u1 + l1, v2 = u2 + l2, v3 = u3 + l3;
    const int s = wrap ? (v0 & 255) + (v1 & 255) + (v2 & 255) + (v3 & 255) : v0 + v1 + v2 + v3;
    const uint32_t dc = rep4(s >> 3);
#pragma unroll
    for (int r = 0; r < 4; ++r) p[2][r] = dc;
  }
  {  // 3 down-left over e = u, ur: row r = t[r .. r + 3]
    const int t6 = (r2 >> 2) + (w3(r3, a_ur) >> 2);
    const uint32_t lo = pk(f3(u0, u1, u2), f3(u1, u2, u3), f3(u2, u3, r0), f3(u3, r0, r1));
    const uint32_t hi = pk(f3(r0, r1, r2), f3(r1, r2, r3), t6, 0);
    p[3][0] = lo;
#pragma unroll
    for (int r = 1; r < 4; ++r) p[3][r] = __funnelshift_r(lo, hi, 8 * r);
  }
  const int d0 = f3(l1, l2, l3), d1 = f3(l0, l1, l2);
  const int d2 = (u0 >> 2) + (l0 >> 1) + (l1 >> 2);
  const int d3 = (ul >> 2) + (u0 >> 1) + (l0 >> 2);
  const int d4 = f3(ul, u0, u1), d5 = f3(u0, u1, u2), d6 = f3(u1, u2, u3);
  const int ulu = (u0 >> 2) + (ul >> 1) + (l0 >> 2);   // b0 of mode 5, a1 of mode 6
  {  // 4 down-right: row r = d[3 - r .. 6 - r]
    const uint32_t lo = pk(d0, d1, d2, d3), hi = pk(d4, d5, d6, 0);
    p[4][3] = lo;
#pragma unroll
    for (int r = 0; r < 3; ++r) p[4][r] = __funnelshift_r(lo, hi, 8 * (3 - r));
  }
  {  // 5 vertical-right: a | b | c0 a0 a1 a2 | d0 b0 b1 b2
    const uint32_t a = pk(f2(ul, u0), f2(u0, u1), f2(u1, u2), f2(u2, u3));
    const uint32_t b = pk(ulu, d4, d5, d6);
    p[5][0] = a;
    p[5][1] = b;
    p[5][2] = (a << 8) | static_cast<uint32_t>(f3(ul, l0, l1));
    p[5][3] = (b << 8) | static_cast<uint32_t>(d1);
  }
  {  // 6 horizontal-down: a0 a1 a2 a3 | b0 b1 a0 a1 | c0 c1 b0 b1 | d0 d1 c0 c1
    const uint32_t r0w = pk(f2(ul, l0), ulu, d4, d5);
    const uint32_t r1w = (r0w << 16) | pk(f2(l0, l1), f3(ul, l1, l2), 0, 0);
    const uint32_t r2w = (r1w << 16) | pk(f2(l1, l2), d1, 0, 0);
    p[6][0] = r0w;
    p[6][1] = r1w;
    p[6][2] = r2w;
    p[6][3] = (r2w << 16) | pk(f2(l2, l3), d0, 0, 0);
  }
  {  // 7 vertical-left: a0..a3 | b0..b3 | a1..a4 | b1..b4
    const uint32_t a = pk(f2(u0, u1), f2(u1, u2), f2(u2, u3), f2(u3, r0));
    const uint32_t b = pk(d5, d6, f3(u2, u3, r0), f3(u3, r0, r1));
    p[7][0] = a;
    p[7][1] = b;
    p[7][2] = (a >> 8) | (static_cast<uint32_t>(f2(r0, r1)) << 24);
    p[7][3] = (b >> 8) | (static_cast<uint32_t>(f3(r0, r1, r2)) << 24);
  }
  {  // 8 horizontal-up: a0 a1 a2 a3 | a2 a3 b2 b3 | b2 b3 c c | c c c c;
     // 3 l[3] wraps when l came from the plane
    const int b2 = f2(l2, l3), b3 = (l2 >> 2) + (w3(l3, a_l) >> 2);
    const uint32_t r0w = pk(f2(l0, l1), d1, f2(l1, l2), d0);
    p[8][0] = r0w;
    p[8][1] = (r0w >> 16) | pk(0, 0, b2, b3);
    p[8][2] = pk(b2, b3, l3, l3);
    p[8][3] = rep4(l3);
  }
}

// sign(n) * ((2 |n| + half) // (2 half)) by multiplication
__device__ __forceinline__ int iround_quant(int n, const Quantiser& q) {
  const uint32_t m = static_cast<uint32_t>(n < 0 ? -n : n);
  const int v = static_cast<int>(__umulhi(2u * m + static_cast<uint32_t>(q.half), q.magic) >> q.shift);
  return n < 0 ? -v : v;
}

// Code block (bi, bj) of step t: o = the four original rows; neighbours from
// the packed carry (ring[row * 4 + slot] the bottom pixel row of the row's
// block of step slot mod 4, left[row] the right column of its last block);
// writes the block's carry and returns the quantized coefficients x, the
// packed reconstruction rows rec, and the mode with bit 7 set for an escape.
__device__ __forceinline__ int encode_block(const uint32_t o[4], uint32_t* ring, uint32_t* left,
                                            int bi, int bj, int t, int nbw, const Quantiser& q,
                                            int x[16], uint32_t rec[4]) {
  const bool a_u = bi >= 1, a_l = bj >= 1, a_ur = a_u && bj < nbw - 1;
  const uint32_t* up = ring + (a_u ? bi - 1 : 0) * 4;
  const uint32_t U = a_u ? up[(t - 2) & 3] : rep4(kFill);
  const uint32_t L = a_l ? left[bi] : rep4(kFill);
  const uint32_t UR = a_ur ? up[(t - 1) & 3] : rep4(byte_of(U, 3));
  const int ul = (a_u && a_l) ? byte_of(up[(t - 3) & 3], 3) : kFill;

  uint32_t p[9][4];
  predict_all(U, L, UR, ul, a_u, a_l, a_ur, p);
  int best = kSentinelKey;
  uint32_t bp[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int m = 0; m < 9; ++m) {
    uint32_t sad = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) sad = sad4(p[m][r], o[r], sad);
    const int key = static_cast<int>(sad) * 16 + m + 1;
    if (key < best) {
      best = key;
#pragma unroll
      for (int r = 0; r < 4; ++r) bp[r] = p[m][r];
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = byte_of(o[i >> 2], i & 3) - byte_of(bp[i >> 2], i & 3);
#pragma unroll
  for (int k = 0; k < 4; ++k) cf4(x + k, 4);      // columns: Cf X
#pragma unroll
  for (int i = 0; i < 4; ++i) cf4(x + 4 * i, 1);  // rows: (Cf X) Cf^T
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int g = ((i >> 2) & 1 ? 4 : 5) * ((i & 1) ? 4 : 5);  // 400 G
    x[i] = iround_quant(x[i] * g, q);
  }
  int r[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) r[i] = x[i];
  dequant_inv(r, q.qstep);
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    int v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = min(max(byte_of(bp[rr], c) + r[4 * rr + c], 0), 255);
    rec[rr] = pk(v[0], v[1], v[2], v[3]);
  }
  ring[bi * 4 + (t & 3)] = rec[3];
  left[bi] = pk(byte_of(rec[0], 3), byte_of(rec[1], 3), byte_of(rec[2], 3), byte_of(rec[3], 3));
  return best == kSentinelKey ? 128 : (best & 15) - 1;
}

__device__ __forceinline__ uint32_t pk16(int a, int b) {
  return (static_cast<uint32_t>(a) & 0xffffu) | (static_cast<uint32_t>(b) << 16);
}

// A block's outputs straight to device memory: ten stores a thread, each to
// a line of its own, since the threads of a warp sit in different block rows.
__device__ __forceinline__ void store_block(const int x[16], const uint32_t rec[4], int mode,
                                            int W, int16_t* __restrict__ qcoef_px,
                                            uint8_t* __restrict__ recon_px,
                                            int8_t* __restrict__ mode_b,
                                            uint8_t* __restrict__ escape_b) {
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    *reinterpret_cast<uint2*>(qcoef_px + static_cast<size_t>(rr) * W) =
        make_uint2(pk16(x[4 * rr], x[4 * rr + 1]), pk16(x[4 * rr + 2], x[4 * rr + 3]));
    *reinterpret_cast<uint32_t*>(recon_px + static_cast<size_t>(rr) * W) = rec[rr];
  }
  *mode_b = static_cast<int8_t>(mode & 15);
  *escape_b = static_cast<uint8_t>(mode >> 7);
}

// The outputs of kGroup consecutive blocks of one block row, staged in shared
// memory until a warp writes them out together: words [0, 32) recon as [pixel
// row][block], [32, 96) qcoef as [pixel row][block][2], then 8 mode bytes and
// 8 escape bytes.
__device__ __forceinline__ void stage_block(uint32_t* tile, int slot, const int x[16],
                                            const uint32_t rec[4], int mode) {
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    tile[rr * kGroup + slot] = rec[rr];
    tile[4 * kGroup + rr * 2 * kGroup + 2 * slot] = pk16(x[4 * rr], x[4 * rr + 1]);
    tile[4 * kGroup + rr * 2 * kGroup + 2 * slot + 1] = pk16(x[4 * rr + 2], x[4 * rr + 3]);
  }
  uint8_t* flags = reinterpret_cast<uint8_t*>(tile + 12 * kGroup);
  flags[slot] = static_cast<uint8_t>(mode & 15);
  flags[kGroup + slot] = static_cast<uint8_t>(mode >> 7);
}

// One warp writes a staged group of n blocks out: a pixel row's 4 n bytes of
// recon and 8 n bytes of qcoef go out side by side, a few 32-byte sectors an
// instruction instead of one a lane. recon_px, qcoef_px: the group's first
// pixel; mode_b, escape_b: its first block.
__device__ __forceinline__ void flush_group(const uint32_t* tile, int n, int lane, int W,
                                            int16_t* __restrict__ qcoef_px,
                                            uint8_t* __restrict__ recon_px,
                                            int8_t* __restrict__ mode_b,
                                            uint8_t* __restrict__ escape_b) {
  if ((lane & 7) < n)
    *reinterpret_cast<uint32_t*>(recon_px + static_cast<size_t>(lane >> 3) * W + 4 * (lane & 7)) = tile[lane];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rr = 2 * half + (lane >> 4), w = lane & 15;
    if (w < 2 * n)
      *reinterpret_cast<uint32_t*>(qcoef_px + static_cast<size_t>(rr) * W + 2 * w) =
          tile[4 * kGroup + rr * 2 * kGroup + w];
  }
  const uint8_t* flags = reinterpret_cast<const uint8_t*>(tile + 12 * kGroup);
  if (lane < n) mode_b[lane] = static_cast<int8_t>(flags[lane]);
  if (lane >= kGroup && lane - kGroup < n) escape_b[lane - kGroup] = flags[lane];
}

// K5 on plane blockIdx.x. Dynamic shared memory: nbh * kEncRowWords words
// of carry and, with row_warps > 0, nbh * kStageWords words of staged
// outputs. row_warps > 0, the staged forms: block = (row_warps +
// kFlushWarps) warps, nbh <= 32 * row_warps, a thread of the first warps per
// block row. row_warps == 0, the direct form: any block, each thread loops
// over block rows.
__device__ __forceinline__ void encode_planes(const uint8_t* __restrict__ planes,
                                              int16_t* __restrict__ qcoef,
                                              int8_t* __restrict__ modes,
                                              uint8_t* __restrict__ escape,
                                              uint8_t* __restrict__ recon, int H, int W,
                                              const Quantiser& q, int row_warps) {
  extern __shared__ int carry[];
  const int nbh = H / 4, nbw = W / 4;
  uint32_t* ring = reinterpret_cast<uint32_t*>(carry);
  uint32_t* left = ring + nbh * 4;
  uint32_t* stage = left + nbh;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t base = blockIdx.x * plane;
  const size_t bbase = static_cast<size_t>(blockIdx.x) * nbh * nbw;
  const int steps = 2 * (nbh - 1) + nbw;

  if (row_warps > 0) {
    // One block row per thread. The original pixels depend on nothing the
    // chain computes: those of the row's next block are loaded a step ahead,
    // so no step waits for device memory. Nor does a row thread store to
    // device memory: the threads of a warp sit in different block rows, so
    // each of a block's ten stores would go to a line of its own and the
    // warps would queue behind them. A row's outputs gather in shared memory
    // instead, kGroup blocks to a group and two groups a row, and the
    // kFlushWarps last warps of the CTA, which code nothing, write each
    // finished group out whole, beside the chain and not on it.
    const int bi = threadIdx.x;
    const int lane = bi & 31, flusher = (bi >> 5) - row_warps;
    const bool active = bi < nbh;
    const uint8_t* row_px = planes + base + static_cast<size_t>(4 * bi) * W;
    uint32_t nxt[4] = {0u, 0u, 0u, 0u};
    if (active) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        nxt[r] = *reinterpret_cast<const uint32_t*>(row_px + static_cast<size_t>(r) * W);
    }
    // two more steps than the chain has: the flush runs up to two behind
    for (int t = 0; t < steps + 2; ++t) {
      const int bj = t - 2 * bi;
      if (active && bj >= 0 && bj < nbw) {
        uint32_t o[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) o[r] = nxt[r];
        if (bj + 1 < nbw) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            nxt[r] = *reinterpret_cast<const uint32_t*>(row_px + static_cast<size_t>(r) * W + 4 * (bj + 1));
        }
        int x[16];
        uint32_t rec[4];
        const int mode = encode_block(o, ring, left, bi, bj, t, nbw, q, x, rec);
        stage_block(stage + bi * kStageWords + ((bj / kGroup) & 1) * kTileWords, bj % kGroup, x,
                    rec, mode);
      }
      if (flusher >= 0) {
        // A full group ends with block 8 j + 7, coded in an odd step s by row
        // (s - 7) / 2 - 4 j. Its row starts to overwrite it eight steps
        // later, so the groups of step s are written out over the two steps
        // that follow, a quarter by each flush warp in each.
        const int tp = t - 1;
        const int s = (tp & 1) ? tp : tp - 1;
        if (s >= kGroup - 1) {
          const int top = (s - (kGroup - 1)) / 2;
          const int j_lo = top >= nbh ? (top - nbh + 4) / 4 : 0;
          const int j_hi = min(top / 4, nbw / kGroup - 1);
          for (int j = j_lo + 2 * (tp - s) + flusher; j <= j_hi; j += 2 * kFlushWarps) {
            const int row = top - 4 * j;
            const size_t px = base + static_cast<size_t>(4 * row) * W + 4 * kGroup * j;
            const size_t b = bbase + static_cast<size_t>(row) * nbw + kGroup * j;
            flush_group(stage + row * kStageWords + (j & 1) * kTileWords, kGroup, lane, W,
                        qcoef + px, recon + px, modes + b, escape + b);
          }
        }
        // the shorter group that ends a row, coded in step tp
        const int twice = tp - (nbw - 1);
        if (flusher == 0 && nbw % kGroup && twice >= 0 && !(twice & 1) && twice / 2 < nbh) {
          const int row = twice / 2, j = nbw / kGroup;
          const size_t px = base + static_cast<size_t>(4 * row) * W + 4 * kGroup * j;
          const size_t b = bbase + static_cast<size_t>(row) * nbw + kGroup * j;
          flush_group(stage + row * kStageWords + (j & 1) * kTileWords, nbw % kGroup, lane, W,
                      qcoef + px, recon + px, modes + b, escape + b);
        }
      }
      __syncthreads();
    }
    return;
  }
  // More block rows than threads: each thread loops over its rows.
  for (int t = 0; t < steps; ++t) {
    for (int bi = threadIdx.x; bi < nbh; bi += blockDim.x) {
      const int bj = t - 2 * bi;
      if (bj < 0 || bj >= nbw) continue;
      const size_t px = base + static_cast<size_t>(4 * bi) * W + 4 * bj;
      uint32_t o[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        o[r] = *reinterpret_cast<const uint32_t*>(planes + px + static_cast<size_t>(r) * W);
      int x[16];
      uint32_t rec[4];
      const int mode = encode_block(o, ring, left, bi, bj, t, nbw, q, x, rec);
      const size_t b = bbase + static_cast<size_t>(bi) * nbw + bj;
      store_block(x, rec, mode, W, qcoef + px, recon + px, modes + b, escape + b);
    }
    __syncthreads();
  }
}

// grid (N), the staged form with at most kEncRowWarps row warps, or the
// direct form; see encode_planes.
__global__ void __launch_bounds__(kEncThreads) intra_encode_kernel(
    const uint8_t* __restrict__ planes, int16_t* __restrict__ qcoef, int8_t* __restrict__ modes,
    uint8_t* __restrict__ escape, uint8_t* __restrict__ recon, int H, int W, Quantiser q,
    int row_warps) {
  encode_planes(planes, qcoef, modes, escape, recon, H, W, q, row_warps);
}

// grid (N), the tall form: the staged form with kTallRowWarps row warps, for
// the planes of 32 kEncRowWarps + 1 to kTallRows block rows (1080p luma); a
// thread may hold 184 registers.
__global__ void __launch_bounds__(kTallThreads) intra_encode_kernel_tall(
    const uint8_t* __restrict__ planes, int16_t* __restrict__ qcoef, int8_t* __restrict__ modes,
    uint8_t* __restrict__ escape, uint8_t* __restrict__ recon, int H, int W, Quantiser q) {
  encode_planes(planes, qcoef, modes, escape, recon, H, W, q, kTallRowWarps);
}

// ---- K6: the decode ------------------------------------------------------
//
// Like K5 it is bound by the chain of dependent diagonals, so what counts is
// what a step costs. Its first version had device memory on the chain (a
// block's residual, mode and escape were loaded in the step that used them),
// ran dequant_inv there although it depends on nothing the chain computes,
// predicted through a switch that a warp of 32 block rows walks branch by
// branch, kept 20 ints of carry a block row and stored four times a block to
// 32 lines a warp.
//
// The clipped form (uint8 out, the lossy decode), up to kDecRowWarps * 32
// block rows, so that a 1080-row plane takes it:
//   * the residual leaves the chain altogether: intra_residual_kernel, one
//     thread a block over all SMs, runs dequant_inv ahead of the chain and
//     leaves the residual as int16, clamped to [-255, 255], which changes no
//     output: clip(p + r) == clip(p + clamp(r)) for a prediction p in 0..255.
//     With qstep == 0 the stored residual is taken as it is and clamped by
//     the row thread;
//   * the row thread loads its next block's residual, mode and escape a step
//     ahead, so no step waits for device memory;
//   * the reconstruction is a byte, so the carry is K5's five packed words a
//     block row and the prediction is K5's predict_all, all nine modes as
//     packed rows without a branch, and four selects a mode;
//   * prediction plus residual, clipped, is one __viaddmin_s16x2_relu for two
//     pixels;
//   * a row thread stores nothing to device memory: it leaves its four words
//     in shared memory, kGroup blocks to a group, and kFlushWarps more warps
//     write each finished group out, 32 contiguous bytes a pixel row, on the
//     schedule of K5's flush.
// What is left on the chain is about 300 instructions a block, a third of
// K5's; with two row warps on two of the SM's four schedulers the step is
// bound by their issue. A switch on the mode over packed rows, instead of
// predict_all and the select, measured 1.7 times slower: the 32 block rows
// of a warp hold all nine modes and walk every branch.
// The unclipped form (int32 out: the lossless decode, whose output the
// caller may not want clipped) reconstructs values that can leave 0..255
// when the stream is not one the encoder wrote, and the predictors' wraps
// then see them, so it keeps the int carry and predict(); it gains only the
// loads a step ahead. Planes with more block rows than a form has threads
// loop over their rows with direct loads and stores, as before.

constexpr int kDecRowWarps = 9;   // K6, clipped form: most warps of row threads (288 block rows)
constexpr int kDecThreads = 32 * (kDecRowWarps + kFlushWarps);
constexpr int kDecStageWords = 2 * 4 * kGroup + 1;  // two groups of recon words a block row; odd

// A block's operands as they come from device memory, loaded a step ahead
// and looked at only in the step that uses them: a step that touched them
// earlier would wait for the load.
struct Ahead {
  uint2 r[4];     // the residual rows, two pixels a word
  int8_t mode;
  uint8_t esc;
  __device__ __forceinline__ void load(const int16_t* __restrict__ res_at,
                                       const int8_t* __restrict__ mode_at,
                                       const uint8_t* __restrict__ esc_at, int W) {
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
      r[rr] = *reinterpret_cast<const uint2*>(res_at + static_cast<size_t>(rr) * W);
    mode = *mode_at;
    esc = *esc_at;
  }
};

// One block of the int form: r = the residual as stored, mode < 0 for an escape.
__device__ __forceinline__ void decode_block_int(int r[16], int mode, int* ring, int* left, int bi,
                                                 int bj, int t, int nbw, int W, int qstep, int clip,
                                                 void* __restrict__ out, size_t px) {
  if (qstep) dequant_inv(r, qstep);
  Neighbors n;
  load_neighbors(ring, left, bi, bj, t, nbw, n);
  int p[16];
  predict(mode, n, p);
  int rec[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    rec[i] = p[i] + r[i];
    if (clip) rec[i] = min(max(rec[i], 0), 255);
  }
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const size_t at = px + static_cast<size_t>(rr) * W;
    if (clip)
      *reinterpret_cast<uchar4*>(static_cast<uint8_t*>(out) + at) =
          make_uchar4(static_cast<unsigned char>(rec[4 * rr]), static_cast<unsigned char>(rec[4 * rr + 1]),
                      static_cast<unsigned char>(rec[4 * rr + 2]), static_cast<unsigned char>(rec[4 * rr + 3]));
    else
      *reinterpret_cast<int4*>(static_cast<int32_t*>(out) + at) =
          make_int4(rec[4 * rr], rec[4 * rr + 1], rec[4 * rr + 2], rec[4 * rr + 3]);
  }
  store_carry(ring, left, bi, t, rec);
}

__device__ __forceinline__ void unpack_rows(const uint2 w[4], int r[16]) {
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    r[4 * rr] = static_cast<int16_t>(w[rr].x & 0xffffu);
    r[4 * rr + 1] = static_cast<int>(w[rr].x) >> 16;
    r[4 * rr + 2] = static_cast<int16_t>(w[rr].y & 0xffffu);
    r[4 * rr + 3] = static_cast<int>(w[rr].y) >> 16;
  }
}

// The int form. grid (N), dynamic shared memory nbh * kRowInts ints; out is
// uint8 when clip, int32 otherwise. kAhead: block = at least nbh threads, a
// thread per block row, its next block's operands loaded a step ahead;
// otherwise any block, each thread loops over block rows.
template <bool kAhead>
__global__ void intra_decode_int_kernel(const int16_t* __restrict__ res, const int8_t* __restrict__ modes,
                                        const uint8_t* __restrict__ escape, void* __restrict__ out,
                                        int H, int W, int qstep, int clip) {
  extern __shared__ int carry[];
  const int nbh = H / 4, nbw = W / 4;
  int* ring = carry;
  int* left = carry + nbh * 16;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t base = blockIdx.x * plane;
  const size_t bbase = static_cast<size_t>(blockIdx.x) * nbh * nbw;
  const int steps = 2 * (nbh - 1) + nbw;

  if constexpr (kAhead) {
    // operands loaded a step ahead into two sets that take turns, as in
    // intra_decode_kernel
    const int bi = threadIdx.x;
    const bool active = bi < nbh;
    const size_t row_px = base + static_cast<size_t>(4 * bi) * W;
    const int16_t* res_at = res + row_px;
    const int8_t* mode_at = modes + bbase + static_cast<size_t>(bi) * nbw;
    const uint8_t* esc_at = escape + bbase + static_cast<size_t>(bi) * nbw;
    Ahead even = {}, odd = {};
    if (active) even.load(res_at, mode_at, esc_at, W);
    auto step = [&](int t, const Ahead& cur, Ahead& nxt) {
      const int bj = t - 2 * bi;
      if (active && bj >= 0 && bj < nbw) {
        if (bj + 1 < nbw) {
          res_at += 4;
          ++mode_at;
          ++esc_at;
          nxt.load(res_at, mode_at, esc_at, W);
        }
        int r[16];
        unpack_rows(cur.r, r);
        decode_block_int(r, cur.esc ? -1 : static_cast<int>(cur.mode), ring, left, bi, bj, t, nbw,
                         W, qstep, clip, out, row_px + 4 * bj);
      }
      __syncthreads();
    };
    for (int t = 0; t < steps; t += 2) {
      step(t, even, odd);
      if (t + 1 < steps) step(t + 1, odd, even);
    }
  } else {
    for (int t = 0; t < steps; ++t) {
      for (int bi = threadIdx.x; bi < nbh; bi += blockDim.x) {
        const int bj = t - 2 * bi;
        if (bj < 0 || bj >= nbw) continue;
        const size_t px = base + static_cast<size_t>(4 * bi) * W + 4 * bj;
        uint2 w[4];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
          w[rr] = *reinterpret_cast<const uint2*>(res + px + static_cast<size_t>(rr) * W);
        int r[16];
        unpack_rows(w, r);
        const size_t b = bbase + static_cast<size_t>(bi) * nbw + bj;
        decode_block_int(r, escape[b] ? -1 : static_cast<int>(modes[b]), ring, left, bi, bj, t,
                         nbw, W, qstep, clip, out, px);
      }
      __syncthreads();
    }
  }
}

// The residual of every block ahead of the chain: res holds quantized
// coefficients, out gets dequant_inv of them clamped to [-255, 255], in the
// same block layout. One thread a block, consecutive threads on consecutive
// blocks of a block row, so a warp reads and writes 256 contiguous bytes an
// instruction.
__global__ void intra_residual_kernel(const int16_t* __restrict__ res, int16_t* __restrict__ out,
                                      size_t blocks, int nbh, int nbw, int W, int qstep) {
  const size_t per_plane = static_cast<size_t>(nbh) * nbw;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < blocks;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t n = i / per_plane, in_plane = i % per_plane;
    const int bi = static_cast<int>(in_plane / nbw), bj = static_cast<int>(in_plane % nbw);
    const size_t px = (n * nbh * 4 + static_cast<size_t>(4 * bi)) * W + 4 * bj;
    uint2 w[4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
      w[rr] = *reinterpret_cast<const uint2*>(res + px + static_cast<size_t>(rr) * W);
    int r[16];
    unpack_rows(w, r);
    dequant_inv(r, qstep);
#pragma unroll
    for (int k = 0; k < 16; ++k) r[k] = min(max(r[k], -255), 255);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
      *reinterpret_cast<uint2*>(out + px + static_cast<size_t>(rr) * W) =
          make_uint2(pk16(r[4 * rr], r[4 * rr + 1]), pk16(r[4 * rr + 2], r[4 * rr + 3]));
  }
}

// One block of the clipped form: r = the residual rows, two pixels a word as
// int16 (clamped here when clamp_res), mode < 0 or > 8 predicts zero.
// Neighbours and carry as in encode_block. Returns the packed recon rows.
template <bool kClampRes>
__device__ __forceinline__ void decode_block_packed(const uint2 r[4], int mode, uint32_t* ring,
                                                    uint32_t* left, int bi, int bj, int t, int nbw,
                                                    uint32_t rec[4]) {
  const bool a_u = bi >= 1, a_l = bj >= 1, a_ur = a_u && bj < nbw - 1;
  const uint32_t* up = ring + (a_u ? bi - 1 : 0) * 4;
  const uint32_t U = a_u ? up[(t - 2) & 3] : rep4(kFill);
  const uint32_t L = a_l ? left[bi] : rep4(kFill);
  const uint32_t UR = a_ur ? up[(t - 1) & 3] : rep4(byte_of(U, 3));
  const int ul = (a_u && a_l) ? byte_of(up[(t - 3) & 3], 3) : kFill;

  uint32_t p[9][4];
  predict_all(U, L, UR, ul, a_u, a_l, a_ur, p);
  constexpr uint32_t kLo = 0x00ff00ffu;   // 255 in both halves
  constexpr uint32_t kNeg = 0xff01ff01u;  // -255 in both halves
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    uint32_t sel = 0u;
#pragma unroll
    for (int m = 0; m < 9; ++m) sel = mode == m ? p[m][rr] : sel;
    uint32_t ra = r[rr].x, rb = r[rr].y;
    if (kClampRes) {
      ra = __vmaxs2(__vmins2(ra, kLo), kNeg);
      rb = __vmaxs2(__vmins2(rb, kLo), kNeg);
    }
    // pixels 0, 1 and 2, 3 as halves; add, min with 255, max with 0; back to bytes
    const uint32_t lo = __viaddmin_s16x2_relu(__byte_perm(sel, 0u, 0x4140), ra, kLo);
    const uint32_t hi = __viaddmin_s16x2_relu(__byte_perm(sel, 0u, 0x4342), rb, kLo);
    rec[rr] = __byte_perm(lo, hi, 0x6420);
  }
  ring[bi * 4 + (t & 3)] = rec[3];
  left[bi] = pk(byte_of(rec[0], 3), byte_of(rec[1], 3), byte_of(rec[2], 3), byte_of(rec[3], 3));
}

// One warp writes the staged recon of n blocks of a group out: 4 n bytes a
// pixel row, side by side.
__device__ __forceinline__ void flush_recon(const uint32_t* tile, int n, int lane, int W,
                                            uint8_t* __restrict__ recon_px) {
  if ((lane & 7) < n)
    *reinterpret_cast<uint32_t*>(recon_px + static_cast<size_t>(lane >> 3) * W + 4 * (lane & 7)) = tile[lane];
}

// The clipped form. grid (N), block = (row_warps + kFlushWarps) warps, nbh <=
// 32 * row_warps; dynamic shared memory nbh * (kEncRowWords + kDecStageWords)
// words. res: the residual, two bytes a pixel in block layout (from
// intra_residual_kernel, or the stream's own when kClampRes).
template <bool kClampRes>
__global__ void __launch_bounds__(kDecThreads) intra_decode_kernel(
    const int16_t* __restrict__ res, const int8_t* __restrict__ modes,
    const uint8_t* __restrict__ escape, uint8_t* __restrict__ out, int H, int W, int row_warps) {
  extern __shared__ int carry[];
  const int nbh = H / 4, nbw = W / 4;
  uint32_t* ring = reinterpret_cast<uint32_t*>(carry);
  uint32_t* left = ring + nbh * 4;
  uint32_t* stage = left + nbh;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t base = blockIdx.x * plane;
  const size_t bbase = static_cast<size_t>(blockIdx.x) * nbh * nbw;
  const int steps = 2 * (nbh - 1) + nbw;

  const int bi = threadIdx.x;
  const int lane = bi & 31, flusher = (bi >> 5) - row_warps;
  const bool active = bi < nbh;
  // the operands of the row's next block, and where they come from
  const int16_t* res_at = res + base + static_cast<size_t>(4 * bi) * W;
  const int8_t* mode_at = modes + bbase + static_cast<size_t>(bi) * nbw;
  const uint8_t* esc_at = escape + bbase + static_cast<size_t>(bi) * nbw;
  Ahead even = {}, odd = {};
  if (active) even.load(res_at, mode_at, esc_at, W);

  // One step. A thread's blocks follow each other step by step from the even
  // step 2 bi on, so the block of an even step finds its operands in `even`
  // and loads the next block's into `odd`, and the other way round: the two
  // sets take turns and no register is copied.
  auto step = [&](int t, const Ahead& cur, Ahead& nxt) {
    const int bj = t - 2 * bi;
    if (active && bj >= 0 && bj < nbw) {
      if (bj + 1 < nbw) {
        res_at += 4;
        ++mode_at;
        ++esc_at;
        nxt.load(res_at, mode_at, esc_at, W);
      }
      uint32_t rec[4];
      decode_block_packed<kClampRes>(cur.r, cur.esc ? -1 : static_cast<int>(cur.mode), ring, left,
                                     bi, bj, t, nbw, rec);
      uint32_t* tile = stage + bi * kDecStageWords + ((bj / kGroup) & 1) * 4 * kGroup;
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) tile[rr * kGroup + bj % kGroup] = rec[rr];
    }
    if (flusher >= 0) {
      // K5's schedule: a full group ends with block 8 j + 7, coded in an odd
      // step s by row (s - 7) / 2 - 4 j, and its row starts to overwrite it
      // eight steps later; the groups of step s are written out over the two
      // steps that follow, a quarter by each flush warp in each.
      const int tp = t - 1;
      const int s = (tp & 1) ? tp : tp - 1;
      if (s >= kGroup - 1) {
        const int top = (s - (kGroup - 1)) / 2;
        const int j_lo = top >= nbh ? (top - nbh + 4) / 4 : 0;
        const int j_hi = min(top / 4, nbw / kGroup - 1);
        for (int j = j_lo + 2 * (tp - s) + flusher; j <= j_hi; j += 2 * kFlushWarps) {
          const int row = top - 4 * j;
          flush_recon(stage + row * kDecStageWords + (j & 1) * 4 * kGroup, kGroup, lane, W,
                      out + base + static_cast<size_t>(4 * row) * W + 4 * kGroup * j);
        }
      }
      // the shorter group that ends a row, coded in step tp
      const int twice = tp - (nbw - 1);
      if (flusher == 0 && nbw % kGroup && twice >= 0 && !(twice & 1) && twice / 2 < nbh) {
        const int row = twice / 2, j = nbw / kGroup;
        flush_recon(stage + row * kDecStageWords + (j & 1) * 4 * kGroup, nbw % kGroup, lane, W,
                    out + base + static_cast<size_t>(4 * row) * W + 4 * kGroup * j);
      }
    }
    __syncthreads();
  };
  // two more steps than the chain has: the flush runs up to two behind
  const int total = steps + 2;
  for (int t = 0; t < total; t += 2) {
    step(t, even, odd);
    if (t + 1 < total) step(t + 1, odd, even);
  }
}

int threads_for(int nbh) { return nbh >= 1024 ? 1024 : ((nbh + 31) / 32) * 32; }

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// magic, shift: the multiply-and-shift form of the division by 800 qstep,
// exact for every numerator below 2^25 (the wrapper computes them).
// row_warps: the form (ops/intra_cuda.py:encode_form): 0 the direct form,
// 1..kEncRowWarps the staged form with that many row warps, kTallRowWarps
// the tall form, for at most kTallRows block rows.
extern "C" int vcs_intra_encode(const void* planes, void* qcoef, void* modes, void* escape,
                                void* recon, int N, int H, int W, int qstep, unsigned magic,
                                int shift, int row_warps, void* stream) {
  const int nbh = H / 4;
  if (row_warps < 0 || (row_warps > kEncRowWarps && row_warps != kTallRowWarps) ||
      (row_warps && nbh > 32 * row_warps) || (row_warps == kTallRowWarps && nbh > kTallRows))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(nbh) * sizeof(uint32_t) *
                      (kEncRowWords + (row_warps ? kStageWords : 0));
  const Quantiser q = {qstep, 400 * qstep, magic, shift};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(planes);
  int16_t* qc = static_cast<int16_t*>(qcoef);
  int8_t* md = static_cast<int8_t*>(modes);
  uint8_t* es = static_cast<uint8_t*>(escape);
  uint8_t* rc = static_cast<uint8_t*>(recon);
  if (row_warps == kTallRowWarps) {
    cudaError_t err = prepare(intra_encode_kernel_tall, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    intra_encode_kernel_tall<<<N, kTallThreads, smem, st>>>(src, qc, md, es, rc, H, W, q);
  } else {
    cudaError_t err = prepare(intra_encode_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int threads = row_warps ? 32 * (row_warps + kFlushWarps) : kEncThreads;
    intra_encode_kernel<<<N, threads, smem, st>>>(src, qc, md, es, rc, H, W, q, row_warps);
  }
  return static_cast<int>(cudaGetLastError());
}

// scratch: int16 [N, H, W] for the residual, needed (and written) when clip
// and qstep > 0 and the plane has at most 32 * kDecRowWarps block rows; may be
// null otherwise. res and scratch must start on 8-byte boundaries.
extern "C" int vcs_intra_decode(const void* res, const void* modes, const void* escape, void* out,
                                void* scratch, int N, int H, int W, int qstep, int clip,
                                void* stream) {
  const int nbh = H / 4, nbw = W / 4;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int16_t* r = static_cast<const int16_t*>(res);
  const int8_t* m = static_cast<const int8_t*>(modes);
  const uint8_t* e = static_cast<const uint8_t*>(escape);
  const int row_warps = (nbh + 31) / 32;
  if (clip && row_warps <= kDecRowWarps) {
    if (qstep) {
      if (!scratch) return static_cast<int>(cudaErrorInvalidValue);
      const size_t blocks = static_cast<size_t>(N) * nbh * nbw;
      const size_t want = (blocks + 255) / 256;
      intra_residual_kernel<<<static_cast<unsigned>(want < 65536 ? want : 65536), 256, 0, st>>>(
          r, static_cast<int16_t*>(scratch), blocks, nbh, nbw, W, qstep);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      r = static_cast<const int16_t*>(scratch);
    }
    const size_t smem = static_cast<size_t>(nbh) * sizeof(uint32_t) * (kEncRowWords + kDecStageWords);
    const int threads = 32 * (row_warps + kFlushWarps);
    if (qstep) {
      cudaError_t err = prepare(intra_decode_kernel<false>, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      intra_decode_kernel<false><<<N, threads, smem, st>>>(r, m, e, static_cast<uint8_t*>(out), H, W,
                                                           row_warps);
    } else {
      cudaError_t err = prepare(intra_decode_kernel<true>, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      intra_decode_kernel<true><<<N, threads, smem, st>>>(r, m, e, static_cast<uint8_t*>(out), H, W,
                                                          row_warps);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = static_cast<size_t>(nbh) * kRowInts * sizeof(int);
  if (nbh <= 1024) {
    cudaError_t err = prepare(intra_decode_int_kernel<true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    intra_decode_int_kernel<true><<<N, threads_for(nbh), smem, st>>>(r, m, e, out, H, W, qstep, clip);
  } else {
    cudaError_t err = prepare(intra_decode_int_kernel<false>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    intra_decode_int_kernel<false><<<N, 1024, smem, st>>>(r, m, e, out, H, W, qstep, clip);
  }
  return static_cast<int>(cudaGetLastError());
}
