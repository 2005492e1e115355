// The strip machinery of the fused P encode and decode, shared by K3 / K4
// (inter_fused.cu, three channels under the RCT) and their bare-plane case
// and K7 (inter_plane.cu, one luma plane or two chroma planes).
//
// A CTA of kStrip * kBs = 128 threads takes kStrip neighbouring 8x8 blocks of
// one block row, every plane of them. A thread is (block, row) for the load,
// the second pass and the store (tid = row * kStrip + block) and (block,
// column) for the first pass (tid = block * kBs + k). The two 8-point passes
// run in one thread's registers with D from the kernel's __grid_constant__
// parameter (the constant bank: no load instruction, no table in shared
// memory); they exchange values through one skewed shared buffer of
// kPlaneWords floats a plane, laid out [k][row][block] with 4 words of skew
// a k, which makes every access of both sides of both exchanges free of bank
// conflicts.
//
// Float arithmetic: every output is acc = 0, then acc = acc + d * x in
// ascending j (first pass) and k (second pass), each product and sum
// rounded to float32 (__f*_rn; the library is also built with --fmad=false):
// the order ops/dct.py sums in, so the kernels agree with the plain PyTorch
// versions bit for bit. The quotient by Q is a true division: the bare-plane
// DC terms land on exact .5 ties, which a reciprocal multiply would round
// apart.
#pragma once

#include <cstdint>

constexpr int kBs = 8;
constexpr int kPix = kBs * kBs;
constexpr int kStrip = 16;                    // blocks of one block row a CTA takes
constexpr int kKStride = kBs * kStrip + 4;    // words between two k of an exchange buffer
constexpr int kPlaneWords = kBs * kKStride;   // one plane of an exchange buffer

// [D, QY, QC] as the kernels' parameter
struct Tables {
  float d[kPix];
  float q[2][kPix];
};

// The 192 floats [D, QY, QC] in host memory, as the kernels' parameter.
inline Tables tables_from_host(const void* tabs_host) {
  Tables t;
  const float* tabs = static_cast<const float*>(tabs_host);
  for (int i = 0; i < kPix; ++i) {
    t.d[i] = tabs[i];
    t.q[0][i] = tabs[kPix + i];
    t.q[1][i] = tabs[2 * kPix + i];
  }
  return t;
}

// where value (row, k) of block b lies in one plane of an exchange buffer
__device__ __forceinline__ int exchange_at(int b, int row, int k) {
  return k * kKStride + row * kStrip + b;
}

// Entry (a, b) of the transform a pass applies: D for the forward DCT
// (encode), D^T for the inverse (decode).
template <bool kInverse>
__device__ __forceinline__ float dct_at(const Tables& t, int a, int b) {
  return kInverse ? t.d[b * kBs + a] : t.d[a * kBs + b];
}

// The first pass, in the thread of (block cb, column k), on each of the NC
// planes of xs: T[i][k] = sum_j D'[i][j] X[j][k], formed in registers and
// put back where X was once every thread has read. Every thread of the CTA
// must call it (it holds a barrier); `active` says whether block cb exists.
template <int NC, bool kInverse>
__device__ __forceinline__ void column_pass(float (*xs)[kPlaneWords], const Tables& t, int cb,
                                            int k, bool active) {
  float tt[NC][kBs];
  if (active) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float x[kBs];
#pragma unroll
      for (int j = 0; j < kBs; ++j) x[j] = xs[c][exchange_at(cb, j, k)];
#pragma unroll
      for (int i = 0; i < kBs; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < kBs; ++j) acc = __fadd_rn(acc, __fmul_rn(dct_at<kInverse>(t, i, j), x[j]));
        tt[c][i] = acc;
      }
    }
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < kBs; ++i) xs[c][exchange_at(cb, i, k)] = tt[c][i];
  }
}

// The second pass, in the thread of (block rb, row i) on one plane:
// Z[i][l] = sum_k T[i][k] D'[l][k].
template <bool kInverse>
__device__ __forceinline__ void row_pass(const float* xs_c, const Tables& t, int rb, int row,
                                         float z[kBs]) {
  float x[kBs];
#pragma unroll
  for (int k = 0; k < kBs; ++k) x[k] = xs_c[exchange_at(rb, row, k)];
#pragma unroll
  for (int l = 0; l < kBs; ++l) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kBs; ++k) acc = __fadd_rn(acc, __fmul_rn(x[k], dct_at<kInverse>(t, l, k)));
    z[l] = acc;
  }
}

// A row's eight int16 coefficients (one 16-byte word) times the row of Q,
// into the row thread's cells of one plane of the exchange buffer.
__device__ __forceinline__ void dequantize_row(int4 raw, const float* q_row, float* xs_c, int rb,
                                               int row) {
  const int w4[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < kBs; ++k) {
    const int v = (k & 1) ? (w4[k >> 1] >> 16) : static_cast<int>(static_cast<int16_t>(w4[k >> 1] & 0xffff));
    xs_c[exchange_at(rb, row, k)] = __fmul_rn(static_cast<float>(v), q_row[k]);
  }
}

// z / Q rounded half to even, the low 16 bits of each of the row's eight
// values, two to a word: one 16-byte word of int16.
__device__ __forceinline__ uint4 quantize_row(const float z[kBs], const float* q_row) {
  uint32_t packed[kBs / 2];
#pragma unroll
  for (int l = 0; l < kBs; ++l) {
    const uint32_t v = static_cast<uint32_t>(__float2int_rn(__fdiv_rn(z[l], q_row[l]))) & 0xffffu;
    packed[l >> 1] = (l & 1) ? (packed[l >> 1] | (v << 16)) : v;
  }
  return make_uint4(packed[0], packed[1], packed[2], packed[3]);
}
