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
// two 8-point passes are far below the ALU limit. Design: one thread per
// pixel (all three channels), 64 threads per block, four neighbouring
// blocks of one row per CTA so each warp touches contiguous row segments;
// the row and column DCT passes exchange through shared memory, and nothing
// but the inputs and the final output touches device memory.

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

// grid (ceil(nbw / 4), nbh, G*F), block (64, 4)
__global__ void fused_p_decode_kernel(const int32_t* __restrict__ mv,
                                      const uint8_t* __restrict__ refs,
                                      const int16_t* __restrict__ coeffs,
                                      const float* __restrict__ tabs,
                                      uint8_t* __restrict__ out,
                                      int F, int H, int W) {
  __shared__ Tables t;
  __shared__ float xa[kBlocksPerCta][3][kPix];
  __shared__ float xb[kBlocksPerCta][3][kPix];
  const int p = threadIdx.x, sub = threadIdx.y;
  load_tables(t, tabs, sub * kPix + p, kPix * kBlocksPerCta);
  __syncthreads();

  const int nbh = H / kBs, nbw = W / kBs;
  const size_t gf = blockIdx.z;
  const int g = static_cast<int>(gf / F);
  const int bi = blockIdx.y, bj = blockIdx.x * kBlocksPerCta + sub;
  const bool active = bj < nbw;
  const int py = p / kBs, px = p % kBs;
  const size_t plane = static_cast<size_t>(H) * W;
  const int y = bi * kBs + py, x = bj * kBs + px;

  if (active) {
    const int16_t* co = coeffs + gf * 3 * plane + static_cast<size_t>(y) * W + x;
    for (int c = 0; c < 3; ++c)
      xa[sub][c][p] = __fmul_rn(static_cast<float>(co[c * plane]), t.q[c == 0 ? 0 : 1][p]);
  }
  __syncthreads();
  if (active) {
    // T[i][k] = sum_j D[j][i] X[j][k]
    for (int c = 0; c < 3; ++c) {
      float acc = 0.0f;
      for (int j = 0; j < kBs; ++j)
        acc = __fadd_rn(acc, __fmul_rn(t.d[j * kBs + py], xa[sub][c][j * kBs + px]));
      xb[sub][c][p] = acc;
    }
  }
  __syncthreads();
  if (active) {
    // Z[i][l] = sum_k T[i][k] D[k][l]
    float v[3];
    for (int c = 0; c < 3; ++c) {
      float acc = 0.0f;
      for (int k = 0; k < kBs; ++k)
        acc = __fadd_rn(acc, __fmul_rn(xb[sub][c][py * kBs + k], t.d[k * kBs + px]));
      v[c] = acc;
    }
    const float r = __fadd_rn(v[0], __fdiv_rn(v[1], 0.713f));
    const float b = __fadd_rn(v[0], __fdiv_rn(v[2], 0.564f));
    const float gg = __fdiv_rn(__fsub_rn(__fsub_rn(v[0], __fmul_rn(0.299f, r)), __fmul_rn(0.114f, b)),
                               0.587f);
    const int res[3] = {__float2int_rn(b), __float2int_rn(gg), __float2int_rn(r)};

    int i0, j0;
    source_origin(mv, gf, nbh, nbw, bi, bj, H, W, i0, j0);
    const uint8_t* ref = refs + static_cast<size_t>(g) * 3 * plane
                         + static_cast<size_t>(i0 + py) * W + j0 + px;
    uint8_t* o = out + gf * 3 * plane + static_cast<size_t>(y) * W + x;
    for (int c = 0; c < 3; ++c)
      o[c * plane] = static_cast<uint8_t>(min(max(static_cast<int>(ref[c * plane]) + res[c], 0), 255));
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

extern "C" int vcs_fused_p_decode(const void* mv, const void* refs, const void* coeffs,
                                  const void* tabs, void* out, int G, int F, int H, int W,
                                  void* stream) {
  dim3 grid((W / kBs + kBlocksPerCta - 1) / kBlocksPerCta, H / kBs, G * F);
  dim3 block(kPix, kBlocksPerCta);
  fused_p_decode_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(mv), static_cast<const uint8_t*>(refs),
      static_cast<const int16_t*>(coeffs), static_cast<const float*>(tabs),
      static_cast<uint8_t*>(out), F, H, W);
  return static_cast<int>(cudaGetLastError());
}
