// K3 / K4: fused P-frame encode and decode.
//
// Replaces the TPU kernels in vcs_h264_tpu/ops/inter_pallas.py:
//   K3 encode: _enc_kernel and _enc_kernel_wide (encode_p_coeffs_fused);
//   K4 decode: _dec_kernel and _dec_kernel_wide (decode_p_frames_fused).
// The int8 recentering, one-hot MXU compensation, kron-slab DCT matmuls,
// per-frame/wide variants and the static-row fast path are TPU devices that
// change no result and are not carried over.
//
// What they compute, per pixel of 8x8 block (bi, bj) of P-frame f of GOP g,
// with the block's vector (dx, dy) and the compensated source
// ref[g, c, i0 + y, j0 + x], where o = 8 bi + dy becomes o + H if negative
// and i0 = clamp(o, 0, H - 8), likewise j0 (lax.dynamic_slice's placement,
// as the plain gather and K1 compute it: block_origin.cuh):
//   encode: resid = cur - ref_comp (BGR) -> signed RCT
//           y = .299 r + .587 g + .114 b, cr = (r - y) .713, cb = (b - y) .564
//           -> D X D^T -> / Q (Y table on y, C table on cr, cb)
//           -> round half to even -> int16;
//   decode: coef * Q -> D^T X D -> inverse RCT
//           r = y + cr / .713, b = y + cb / .564, g = (y - .299 r - .114 b) / .587
//           -> round half to even -> + ref_comp -> clip [0, 255] -> uint8.
// Float arithmetic is IEEE float32 rounded after every operation (explicit
// __f*_rn intrinsics; the library is also built with --fmad=false), with
// true division where the plain version divides, so the kernels differ from
// the plain PyTorch versions only by the order of the 8-term DCT sums.
//
// What bounds them on an H100: device-memory traffic. Per pixel and
// channel, encode reads 1 byte of cur and 1 byte of ref and writes 2 bytes;
// decode reads 2 + 1 and writes 1. The 16 multiply-adds per output of the
// two 8-point passes are far below the ALU limit. Design of K3: one thread
// per pixel (all three channels), 64 threads per block, four neighbouring
// blocks of one row per CTA so each warp touches contiguous row segments;
// the row and column DCT passes exchange through shared memory, and nothing
// but the inputs and the final output touches device memory. K4 has since
// been rebuilt around wide accesses and register passes: see its own note.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_origin.cuh"

namespace {

constexpr int kBs = 8;
constexpr int kPix = kBs * kBs;
constexpr int kBlocksPerCta = 4;

// tables: [D (64), QY (64), QC (64)] float32
struct Tables {
  float d[kPix];
  float q[2][kPix];
};

__device__ __forceinline__ void load_tables(Tables& t, const float* __restrict__ tabs, int tid, int nthr) {
  for (int i = tid; i < 3 * kPix; i += nthr) {
    if (i < kPix) t.d[i] = tabs[i];
    else t.q[(i - kPix) / kPix][i % kPix] = tabs[i];
  }
}

// Start of the compensated source block.
__device__ __forceinline__ void source_origin(const int32_t* __restrict__ mv, size_t gf, int nbh,
                                              int nbw, int bi, int bj, int H, int W,
                                              int& i0, int& j0) {
  const int32_t* m = mv + ((gf * nbh + bi) * nbw + bj) * 2;
  i0 = place_origin(static_cast<long long>(bi) * kBs + m[1], H, kBs);
  j0 = place_origin(static_cast<long long>(bj) * kBs + m[0], W, kBs);
}

// grid (ceil(nbw / 4), nbh, G*F), block (64, 4)
__global__ void fused_p_encode_kernel(const int32_t* __restrict__ mv,
                                      const uint8_t* __restrict__ refs,
                                      const uint8_t* __restrict__ curs,
                                      const float* __restrict__ tabs,
                                      int16_t* __restrict__ out,
                                      int F, int H, int W) {
  __shared__ Tables t;
  __shared__ float xa[kBlocksPerCta][3][kPix];
  __shared__ float xb[kBlocksPerCta][3][kPix];
  const int p = threadIdx.x, sub = threadIdx.y;
  load_tables(t, tabs, sub * kPix + p, kPix * kBlocksPerCta);

  const int nbh = H / kBs, nbw = W / kBs;
  const size_t gf = blockIdx.z;
  const int g = static_cast<int>(gf / F);
  const int bi = blockIdx.y, bj = blockIdx.x * kBlocksPerCta + sub;
  const bool active = bj < nbw;
  const int py = p / kBs, px = p % kBs;
  const size_t plane = static_cast<size_t>(H) * W;
  const int y = bi * kBs + py, x = bj * kBs + px;

  if (active) {
    int i0, j0;
    source_origin(mv, gf, nbh, nbw, bi, bj, H, W, i0, j0);
    const uint8_t* ref = refs + static_cast<size_t>(g) * 3 * plane
                         + static_cast<size_t>(i0 + py) * W + j0 + px;
    const uint8_t* cur = curs + gf * 3 * plane + static_cast<size_t>(y) * W + x;
    const float rb = static_cast<float>(static_cast<int>(cur[0]) - static_cast<int>(ref[0]));
    const float rg = static_cast<float>(static_cast<int>(cur[plane]) - static_cast<int>(ref[plane]));
    const float rr = static_cast<float>(static_cast<int>(cur[2 * plane]) - static_cast<int>(ref[2 * plane]));
    const float yy = __fadd_rn(__fadd_rn(__fmul_rn(0.299f, rr), __fmul_rn(0.587f, rg)),
                               __fmul_rn(0.114f, rb));
    xa[sub][0][p] = yy;
    xa[sub][1][p] = __fmul_rn(__fsub_rn(rr, yy), 0.713f);
    xa[sub][2][p] = __fmul_rn(__fsub_rn(rb, yy), 0.564f);
  }
  __syncthreads();
  if (active) {
    // rows: T[i][k] = sum_j D[i][j] X[j][k]
    for (int c = 0; c < 3; ++c) {
      float acc = 0.0f;
      for (int j = 0; j < kBs; ++j)
        acc = __fadd_rn(acc, __fmul_rn(t.d[py * kBs + j], xa[sub][c][j * kBs + px]));
      xb[sub][c][p] = acc;
    }
  }
  __syncthreads();
  if (active) {
    // columns: Z[i][l] = sum_k T[i][k] D[l][k], then / Q and round
    int16_t* o = out + gf * 3 * plane + static_cast<size_t>(y) * W + x;
    for (int c = 0; c < 3; ++c) {
      float acc = 0.0f;
      for (int k = 0; k < kBs; ++k)
        acc = __fadd_rn(acc, __fmul_rn(xb[sub][c][py * kBs + k], t.d[px * kBs + k]));
      const float qv = t.q[c == 0 ? 0 : 1][p];
      o[c * plane] = static_cast<int16_t>(__float2int_rn(__fdiv_rn(acc, qv)));
    }
  }
}

// ---- K4: the decode, a strip of blocks to a CTA ---------------------------
//
// Bound by bytes (2 + 1 bytes in and 1 out per sample); what kept the first
// version at six times that bound was how it moved them: a thread a pixel, so
// a warp touched four rows of 8 px (half a sector a coefficient load, a
// quarter a reference load or a store, one byte a thread), 64-thread blocks
// with three barriers and a table load from device memory each, 48 shared
// loads a sample in the two passes, and the block's vector read 64 times.
//
// Here a CTA takes kStrip neighbouring blocks of one block row, all three
// channels, with one thread per block and row (or column):
//   * load: the thread of (block, row) reads its row's 8 coefficients of each
//     channel as one 16-byte word, so a warp reads two pixel rows of the
//     strip, 256 contiguous bytes each; it dequantises them and leaves them
//     in shared memory;
//   * first pass: the thread of (block, column k) reads X[0..7][k], and forms
//     T[0..7][k] in registers, D coming from the kernel's parameters (the
//     constant bank: no load instruction in the loop);
//   * second pass, after a second exchange through shared memory: the thread
//     of (block, row i) forms Z[i][0..7] of the three channels, runs the
//     inverse RCT on them, adds the compensated reference row and stores 8
//     bytes a channel, so a warp writes two runs of 128 contiguous bytes.
// Both exchanges go through one buffer of 12.7 KB (a second one measured 8 %
// slower: fewer CTAs an SM), laid out [k][row][block] with 4 words of skew a
// k, which makes both sides of both exchanges free of bank conflicts. The
// reference row starts at any byte: it is cut out of three aligned words
// with __funnelshift_r. The vector is read once a thread, 8 times a block.
//
// Every float operation of the first version and its order are kept: each
// output is acc = 0, acc = acc + d[j] * x[j] for j = 0..7 with every product
// and sum rounded, then the inverse RCT with true divisions, so the frames
// are the same bit for bit.

constexpr int kStrip = 16;                 // blocks of one block row a CTA takes
constexpr int kKStride = kBs * kStrip + 4; // words between two k of an exchange buffer

// [D, QY, QC] as the kernel's parameter
struct DecodeTables {
  float d[kPix];
  float q[2][kPix];
};

// where value (row, k) of block b lies in an exchange buffer
__device__ __forceinline__ int exchange_at(int b, int row, int k) {
  return k * kKStride + row * kStrip + b;
}

// The 8 bytes that start at p, which may be any byte of a tensor whose own
// start lies on a 4-byte boundary and whose rows are multiples of 4 long: cut
// out of the aligned words around them. The third word is read only where
// the bytes reach into it, so nothing past the 8 bytes' last word is touched.
__device__ __forceinline__ uint2 load_row8(const uint8_t* p) {
  const unsigned s = static_cast<unsigned>(reinterpret_cast<uintptr_t>(p) & 3u);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(p - s);
  const uint32_t a = w[0], b = w[1], c = s ? w[2] : 0u;
  return make_uint2(__funnelshift_r(a, b, 8 * s), __funnelshift_r(b, c, 8 * s));
}

__device__ __forceinline__ int byte_at(uint2 v, int k) {
  return static_cast<int>(((k < 4 ? v.x : v.y) >> (8 * (k & 3))) & 255u);
}

// grid (ceil(nbw / kStrip), nbh, G*F), block (kStrip * kBs)
__global__ void __launch_bounds__(kStrip * kBs) fused_p_decode_kernel(
    const int32_t* __restrict__ mv, const uint8_t* __restrict__ refs,
    const int16_t* __restrict__ coeffs, const __grid_constant__ DecodeTables t,
    uint8_t* __restrict__ out, int F, int H, int W) {
  __shared__ float xs[3][kBs * kKStride];
  const int tid = threadIdx.x;
  const int nbh = H / kBs, nbw = W / kBs;
  const size_t gf = blockIdx.z;
  const int g = static_cast<int>(gf / F);
  const int bi = blockIdx.y, bj0 = blockIdx.x * kStrip;
  const size_t plane = static_cast<size_t>(H) * W;

  // as (block, row): tid = row * kStrip + block, for the load, the second
  // pass and the store
  const int rb = tid % kStrip, row = tid / kStrip;
  const bool r_active = bj0 + rb < nbw;
  const size_t at = static_cast<size_t>(bi * kBs + row) * W + static_cast<size_t>(bj0 + rb) * kBs;
  uint2 ref[3] = {};
  if (r_active) {
    const int16_t* co = coeffs + gf * 3 * plane + at;
    int4 raw[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) raw[c] = *reinterpret_cast<const int4*>(co + c * plane);
    // the reference row is asked for here, long before it is used
    int i0, j0;
    source_origin(mv, gf, nbh, nbw, bi, bj0 + rb, H, W, i0, j0);
    const uint8_t* rp = refs + static_cast<size_t>(g) * 3 * plane + static_cast<size_t>(i0 + row) * W + j0;
#pragma unroll
    for (int c = 0; c < 3; ++c) ref[c] = load_row8(rp + c * plane);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int w4[4] = {raw[c].x, raw[c].y, raw[c].z, raw[c].w};
#pragma unroll
      for (int k = 0; k < kBs; ++k) {
        const int v = (k & 1) ? (w4[k >> 1] >> 16) : static_cast<int>(static_cast<int16_t>(w4[k >> 1] & 0xffff));
        xs[c][exchange_at(rb, row, k)] =
            __fmul_rn(static_cast<float>(v), t.q[c == 0 ? 0 : 1][row * kBs + k]);
      }
    }
  }
  __syncthreads();
  {
    // as (block, column): tid = block * kBs + k. T[i][k] = sum_j D[j][i] X[j][k],
    // formed in registers and put back where X was once every thread has read
    const int cb = tid / kBs, k = tid % kBs;
    const bool c_active = bj0 + cb < nbw;
    float tt[3][kBs];
    if (c_active) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float x[kBs];
#pragma unroll
        for (int j = 0; j < kBs; ++j) x[j] = xs[c][exchange_at(cb, j, k)];
#pragma unroll
        for (int i = 0; i < kBs; ++i) {
          float acc = 0.0f;
#pragma unroll
          for (int j = 0; j < kBs; ++j) acc = __fadd_rn(acc, __fmul_rn(t.d[j * kBs + i], x[j]));
          tt[c][i] = acc;
        }
      }
    }
    __syncthreads();
    if (c_active) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int i = 0; i < kBs; ++i) xs[c][exchange_at(cb, i, k)] = tt[c][i];
    }
  }
  __syncthreads();
  if (r_active) {
    // Z[i][l] = sum_k T[i][k] D[k][l], i = row
    float z[3][kBs];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float x[kBs];
#pragma unroll
      for (int k = 0; k < kBs; ++k) x[k] = xs[c][exchange_at(rb, row, k)];
#pragma unroll
      for (int l = 0; l < kBs; ++l) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < kBs; ++k) acc = __fadd_rn(acc, __fmul_rn(x[k], t.d[k * kBs + l]));
        z[c][l] = acc;
      }
    }
    uint32_t packed[3][2] = {};
#pragma unroll
    for (int l = 0; l < kBs; ++l) {
      const float r = __fadd_rn(z[0][l], __fdiv_rn(z[1][l], 0.713f));
      const float b = __fadd_rn(z[0][l], __fdiv_rn(z[2][l], 0.564f));
      const float gg = __fdiv_rn(__fsub_rn(__fsub_rn(z[0][l], __fmul_rn(0.299f, r)), __fmul_rn(0.114f, b)),
                                 0.587f);
      const int res[3] = {__float2int_rn(b), __float2int_rn(gg), __float2int_rn(r)};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int v = min(max(byte_at(ref[c], l) + res[c], 0), 255);
        packed[c][l >> 2] |= static_cast<uint32_t>(v) << (8 * (l & 3));
      }
    }
    uint8_t* o = out + gf * 3 * plane + at;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      *reinterpret_cast<uint2*>(o + c * plane) = make_uint2(packed[c][0], packed[c][1]);
  }
}

}  // namespace

extern "C" int vcs_fused_p_encode(const void* mv, const void* refs, const void* curs,
                                  const void* tabs, void* out, int G, int F, int H, int W,
                                  void* stream) {
  dim3 grid((W / kBs + kBlocksPerCta - 1) / kBlocksPerCta, H / kBs, G * F);
  dim3 block(kPix, kBlocksPerCta);
  fused_p_encode_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(mv), static_cast<const uint8_t*>(refs),
      static_cast<const uint8_t*>(curs), static_cast<const float*>(tabs),
      static_cast<int16_t*>(out), F, H, W);
  return static_cast<int>(cudaGetLastError());
}

// tabs_host: the 192 floats [D, QY, QC] in host memory; they travel as the
// kernel's parameter. coeffs must start on a 16-byte boundary, out on an 8-byte
// and refs on a 4-byte one (the wrapper checks).
extern "C" int vcs_fused_p_decode(const void* mv, const void* refs, const void* coeffs,
                                  const void* tabs_host, void* out, int G, int F, int H, int W,
                                  void* stream) {
  DecodeTables t;
  const float* tabs = static_cast<const float*>(tabs_host);
  for (int i = 0; i < kPix; ++i) {
    t.d[i] = tabs[i];
    t.q[0][i] = tabs[kPix + i];
    t.q[1][i] = tabs[2 * kPix + i];
  }
  dim3 grid((W / kBs + kStrip - 1) / kStrip, H / kBs, G * F);
  fused_p_decode_kernel<<<grid, kStrip * kBs, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(mv), static_cast<const uint8_t*>(refs),
      static_cast<const int16_t*>(coeffs), t, static_cast<uint8_t*>(out), F, H, W);
  return static_cast<int>(cudaGetLastError());
}
