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
// a few MB for a 24-plane batch; the per-block work (9 predictors with their
// SADs, two 4x4 integer transforms, 16 divisions) is a few thousand integer
// operations. Design: one CTA per plane and one thread per block row (a
// thread loops over rows when a plane has more rows than the CTA threads);
// at step t the thread of row bi codes block (bi, t - 2 bi), then the CTA
// meets at one __syncthreads(). The carry stays on chip in shared memory:
// per block row, a ring of the bottom rows of its last four blocks (the row
// below reads u, ur and the ul corner from it one to three steps later) and
// the right column of its last block (the row's own next block reads l).
// Predictors, SADs, selection and transforms stay in registers. A 24-plane
// batch fills only 24 of the 132 SMs; splitting a plane across CTAs needs a
// barrier between CTAs per diagonal and is left for later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFill = 128;
constexpr int kSentinelKey = 16 * 255 * 16;
constexpr int kRowInts = 20;  // shared ints per block row: ring 4 x 4, left column 4

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

// sign(a) * ((2 |a| + b) // (2 b)) for b > 0
__device__ __forceinline__ int iround_div(int a, int b) {
  const unsigned m = static_cast<unsigned>(a < 0 ? -a : a);
  const int v = static_cast<int>((2u * m + static_cast<unsigned>(b)) / (2u * static_cast<unsigned>(b)));
  return a < 0 ? -v : v;
}

// x (residual, in place) -> quantized coefficients
__device__ __forceinline__ void fwd_quant(int x[16], int qstep) {
#pragma unroll
  for (int k = 0; k < 4; ++k) cf4(x + k, 4);      // columns: Cf X
#pragma unroll
  for (int i = 0; i < 4; ++i) cf4(x + 4 * i, 1);  // rows: (Cf X) Cf^T
  const int b = 400 * qstep;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int g = ((i >> 2) & 1 ? 4 : 5) * ((i & 1) ? 4 : 5);  // 400 G
    x[i] = iround_div(x[i] * g, b);
  }
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

// grid (N), block (threads), dynamic shared memory nbh * kRowInts ints
__global__ void intra_encode_kernel(const uint8_t* __restrict__ planes, int16_t* __restrict__ qcoef,
                                    int8_t* __restrict__ modes, uint8_t* __restrict__ escape,
                                    uint8_t* __restrict__ recon, int H, int W, int qstep) {
  extern __shared__ int carry[];
  const int nbh = H / 4, nbw = W / 4;
  int* ring = carry;
  int* left = carry + nbh * 16;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t base = blockIdx.x * plane;
  const size_t bbase = static_cast<size_t>(blockIdx.x) * nbh * nbw;
  const int steps = 2 * (nbh - 1) + nbw;

  for (int t = 0; t < steps; ++t) {
    for (int bi = threadIdx.x; bi < nbh; bi += blockDim.x) {
      const int bj = t - 2 * bi;
      if (bj < 0 || bj >= nbw) continue;
      Neighbors n;
      load_neighbors(ring, left, bi, bj, t, nbw, n);
      const size_t px = base + static_cast<size_t>(4 * bi) * W + 4 * bj;
      int o[16];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uchar4 v = *reinterpret_cast<const uchar4*>(planes + px + static_cast<size_t>(r) * W);
        o[4 * r] = v.x; o[4 * r + 1] = v.y; o[4 * r + 2] = v.z; o[4 * r + 3] = v.w;
      }
      int best = kSentinelKey;
      int bp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) bp[i] = 0;
#pragma unroll
      for (int m = 0; m < 9; ++m) {
        int p[16];
        predict(m, n, p);
        int sad = 0;
#pragma unroll
        for (int i = 0; i < 16; ++i) sad += abs(p[i] - o[i]);
        const int key = sad * 16 + m + 1;
        if (key < best) {
          best = key;
#pragma unroll
          for (int i = 0; i < 16; ++i) bp[i] = p[i];
        }
      }
      const bool esc = best == kSentinelKey;
      int x[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) x[i] = o[i] - bp[i];
      fwd_quant(x, qstep);
      int r[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) r[i] = x[i];
      dequant_inv(r, qstep);
      int rec[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) rec[i] = min(max(bp[i] + r[i], 0), 255);

#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const size_t at = px + static_cast<size_t>(rr) * W;
        *reinterpret_cast<short4*>(qcoef + at) =
            make_short4(static_cast<short>(x[4 * rr]), static_cast<short>(x[4 * rr + 1]),
                        static_cast<short>(x[4 * rr + 2]), static_cast<short>(x[4 * rr + 3]));
        *reinterpret_cast<uchar4*>(recon + at) =
            make_uchar4(static_cast<unsigned char>(rec[4 * rr]), static_cast<unsigned char>(rec[4 * rr + 1]),
                        static_cast<unsigned char>(rec[4 * rr + 2]), static_cast<unsigned char>(rec[4 * rr + 3]));
      }
      const size_t b = bbase + static_cast<size_t>(bi) * nbw + bj;
      modes[b] = static_cast<int8_t>(esc ? 0 : (best & 15) - 1);
      escape[b] = esc ? 1 : 0;
      store_carry(ring, left, bi, t, rec);
    }
    __syncthreads();
  }
}

// grid (N), block (threads), dynamic shared memory nbh * kRowInts ints.
// out is uint8 when clip, int32 otherwise.
__global__ void intra_decode_kernel(const int16_t* __restrict__ res, const int8_t* __restrict__ modes,
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

  for (int t = 0; t < steps; ++t) {
    for (int bi = threadIdx.x; bi < nbh; bi += blockDim.x) {
      const int bj = t - 2 * bi;
      if (bj < 0 || bj >= nbw) continue;
      const size_t px = base + static_cast<size_t>(4 * bi) * W + 4 * bj;
      int r[16];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const short4 v = *reinterpret_cast<const short4*>(res + px + static_cast<size_t>(rr) * W);
        r[4 * rr] = v.x; r[4 * rr + 1] = v.y; r[4 * rr + 2] = v.z; r[4 * rr + 3] = v.w;
      }
      if (qstep) dequant_inv(r, qstep);
      const size_t b = bbase + static_cast<size_t>(bi) * nbw + bj;
      Neighbors n;
      load_neighbors(ring, left, bi, bj, t, nbw, n);
      int p[16];
      predict(escape[b] ? -1 : static_cast<int>(modes[b]), n, p);
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
    __syncthreads();
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

extern "C" int vcs_intra_encode(const void* planes, void* qcoef, void* modes, void* escape,
                                void* recon, int N, int H, int W, int qstep, void* stream) {
  const int nbh = H / 4;
  const size_t smem = static_cast<size_t>(nbh) * kRowInts * sizeof(int);
  cudaError_t err = prepare(intra_encode_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  intra_encode_kernel<<<N, threads_for(nbh), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), static_cast<int16_t*>(qcoef),
      static_cast<int8_t*>(modes), static_cast<uint8_t*>(escape), static_cast<uint8_t*>(recon),
      H, W, qstep);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vcs_intra_decode(const void* res, const void* modes, const void* escape, void* out,
                                int N, int H, int W, int qstep, int clip, void* stream) {
  const int nbh = H / 4;
  const size_t smem = static_cast<size_t>(nbh) * kRowInts * sizeof(int);
  cudaError_t err = prepare(intra_decode_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  intra_decode_kernel<<<N, threads_for(nbh), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(res), static_cast<const int8_t*>(modes),
      static_cast<const uint8_t*>(escape), out, H, W, qstep, clip);
  return static_cast<int>(cudaGetLastError());
}
