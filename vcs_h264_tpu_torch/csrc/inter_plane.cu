// Bare-plane fused P encode and decode: the C == 1 case of K3 / K4 (the
// 4:2:0 luma plane) and K7 (the two 4:2:0 chroma planes).
//
// Replaces the TPU kernels in vcs_h264_tpu/ops/inter_pallas.py:
//   plane_encode / plane_decode: _enc_kernel(_wide) / _dec_kernel(_wide) at
//     c == 1 (encode_p_coeffs_fused / decode_p_frames_fused on a bare plane);
//   c420_encode / c420_decode: _enc_kernel_wide2h / _dec_kernel_wide2h
//     (_fused_call_c420: encode_c420_coeffs_fused / decode_c420_frames_fused).
// The Cr|Cb concatenation along W, the per-half displacement maps, the
// one-hot column matmul, the row select, the int8 recentering, the kron
// slabs, the static-row fast path and the 128-lane alignment condition are
// TPU devices that change no result and are not carried over: one kernel
// pair, templated on the planes a CTA takes and the side of the motion
// grid's cells, serves both.
//
// What they compute, per pixel (y, x) of 8x8 transform block (bi, bj) of
// plane c of frame f of GOP g. The motion grid has MVBS-pixel cells on the
// plane's own H x W: MVBS 8 on luma (one vector per transform block), MVBS 4
// on chroma (four per transform block, two vector rows and two vector
// columns). The cell (y / MVBS, x / MVBS) has the vector (dx, dy); its source
// origin o = MVBS * cell + d becomes o + extent if negative and is clamped
// into [0, extent - MVBS] (lax.dynamic_slice's placement, block_origin.cuh),
// so any int32 vector reads inside the plane:
//   encode: float(cur - pred) -> D X D^T -> / Q -> round half to even -> int16;
//   decode: coef * Q -> D^T X D -> round half to even -> + pred
//           -> clip [0, 255] -> uint8.
// No colour transform. Q is the luma table for plane_* and the chroma table
// for both planes of c420_*. The float operations and their order are those
// of dct_strip.cuh, so the kernels agree with their plain PyTorch versions
// bit for bit.
//
// What bounds them on an H100: per sample, encode reads 1 byte of cur and 1
// of ref and writes 2; decode reads 2 + 1 and writes 1; the vectors add 8
// bytes per cell. Once those bytes move in wide words the limit is
// instruction issue, as for K3 / K4: the 16 multiplies and adds of an output
// cannot fuse, and the encode divides. The design is K3 / K4's strip
// (dct_strip.cuh) without the RCT: a CTA of 128 threads takes 16
// neighbouring blocks of one block row, all NC planes of them (K7's two
// chroma planes share their vectors and the grid has no plane axis); the
// thread of (block, row) reads its row of cur as one 8-byte word or its row
// of coefficients as one 16-byte word a plane, stores its row as one 16-byte
// word of int16 or one 8-byte word of uint8, and places its source origins
// once. Its compensated reference row is cut out of aligned 32-bit words
// (shifted_rows.cuh): at cells of 8 one 8-byte run (`load_row8`); at cells
// of 4 its 8 pixels lie under two cells with their own vectors and source
// origins, so two 4-byte runs at independent byte shifts, the two vectors
// read as one 16-byte word (a vector row is 2 * W / 4 int32, W a multiple of
// 8, so the pair starts on a 16-byte boundary).

#include <cstdint>
#include <cuda_runtime.h>

#include "block_origin.cuh"
#include "dct_strip.cuh"
#include "shifted_rows.cuh"

namespace {

// Row `row` of transform block (bi, bj), 8 bytes, as the motion grid
// predicts it from each of the NC planes of `ref` (the GOP's reference).
template <int NC, int MVBS>
__device__ __forceinline__ void predicted_rows(const int32_t* __restrict__ mv,
                                               const uint8_t* __restrict__ ref, size_t gf, int bi,
                                               int bj, int row, int H, int W, uint2 out[NC]) {
  const size_t plane = static_cast<size_t>(H) * W;
  if constexpr (MVBS == kBs) {
    const int nbh = H / kBs, nbw = W / kBs;
    const int2 m = *reinterpret_cast<const int2*>(mv + ((gf * nbh + bi) * nbw + bj) * 2);
    const int i0 = place_origin(static_cast<long long>(bi) * kBs + m.y, H, kBs);
    const int j0 = place_origin(static_cast<long long>(bj) * kBs + m.x, W, kBs);
    const uint8_t* p = ref + static_cast<size_t>(i0 + row) * W + j0;
#pragma unroll
    for (int c = 0; c < NC; ++c) out[c] = load_row8(p + c * plane);
  } else {
    static_assert(MVBS == kBs || 2 * MVBS == kBs, "cells of 8 or 4 pixels");
    const int nmh = H / MVBS, nmw = W / MVBS;
    const int mi = 2 * bi + row / MVBS, r = row % MVBS;
    // (dx, dy) of cells (mi, 2 bj) and (mi, 2 bj + 1)
    const int4 m = *reinterpret_cast<const int4*>(mv + ((gf * nmh + mi) * nmw + 2 * bj) * 2);
    const long long oi = static_cast<long long>(mi) * MVBS;
    const long long oj = static_cast<long long>(2 * bj) * MVBS;
    const int ia = place_origin(oi + m.y, H, MVBS), ja = place_origin(oj + m.x, W, MVBS);
    const int ib = place_origin(oi + m.w, H, MVBS), jb = place_origin(oj + MVBS + m.z, W, MVBS);
    // the plane is a multiple of 4 bytes long, so a run's shift is the same
    // in every plane
    const uint8_t* pa = ref + static_cast<size_t>(ia + r) * W + ja;
    const uint8_t* pb = ref + static_cast<size_t>(ib + r) * W + jb;
    const unsigned sa = static_cast<unsigned>(reinterpret_cast<uintptr_t>(pa) & 3u);
    const unsigned sb = static_cast<unsigned>(reinterpret_cast<uintptr_t>(pb) & 3u);
    const uint32_t* wa = reinterpret_cast<const uint32_t*>(pa - sa);
    const uint32_t* wb = reinterpret_cast<const uint32_t*>(pb - sb);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      uint32_t lo, hi;
      load_shifted<1>(wa + c * (plane / 4), sa, &lo);
      load_shifted<1>(wb + c * (plane / 4), sb, &hi);
      out[c] = make_uint2(lo, hi);
    }
  }
}

// grid (ceil(nbw / kStrip), nbh, G*F), block (kStrip * kBs)
template <int NC, int MVBS>
__global__ void __launch_bounds__(kStrip * kBs) plane_encode_kernel(
    const int32_t* __restrict__ mv, const uint8_t* __restrict__ refs,
    const uint8_t* __restrict__ curs, const __grid_constant__ Tables t,
    int16_t* __restrict__ out, int F, int H, int W, int qsel) {
  __shared__ float xs[NC][kPlaneWords];
  const int tid = threadIdx.x;
  const int nbw = W / kBs;
  const size_t gf = blockIdx.z;
  const size_t g = gf / F;
  const int bi = blockIdx.y, bj0 = blockIdx.x * kStrip;
  const size_t plane = static_cast<size_t>(H) * W;

  // as (block, row): tid = row * kStrip + block, for the load, the second
  // pass and the store
  const int blk = tid % kStrip, row = tid / kStrip;
  const bool r_active = bj0 + blk < nbw;
  const size_t at = static_cast<size_t>(bi * kBs + row) * W + static_cast<size_t>(bj0 + blk) * kBs;
  if (r_active) {
    uint2 cur[NC], ref[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      cur[c] = *reinterpret_cast<const uint2*>(curs + (gf * NC + c) * plane + at);
    predicted_rows<NC, MVBS>(mv, refs + g * NC * plane, gf, bi, bj0 + blk, row, H, W, ref);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int k = 0; k < kBs; ++k)
        xs[c][exchange_at(blk, row, k)] = static_cast<float>(byte_at(cur[c], k) - byte_at(ref[c], k));
  }
  __syncthreads();
  // as (block, column): tid = block * kBs + k. T[i][k] = sum_j D[i][j] X[j][k]
  column_pass<NC, false>(xs, t, tid / kBs, tid % kBs, bj0 + tid / kBs < nbw);
  __syncthreads();
  if (r_active) {
    // Z[i][l] = sum_k T[i][k] D[l][k], i = row; / Q, round, one 16-byte store
    int16_t* o = out + gf * NC * plane + at;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float z[kBs];
      row_pass<false>(xs[c], t, blk, row, z);
      *reinterpret_cast<uint4*>(o + c * plane) = quantize_row(z, t.q[qsel] + row * kBs);
    }
  }
}

// grid (ceil(nbw / kStrip), nbh, G*F), block (kStrip * kBs)
template <int NC, int MVBS>
__global__ void __launch_bounds__(kStrip * kBs) plane_decode_kernel(
    const int32_t* __restrict__ mv, const uint8_t* __restrict__ refs,
    const int16_t* __restrict__ coeffs, const __grid_constant__ Tables t,
    uint8_t* __restrict__ out, int F, int H, int W, int qsel) {
  __shared__ float xs[NC][kPlaneWords];
  const int tid = threadIdx.x;
  const int nbw = W / kBs;
  const size_t gf = blockIdx.z;
  const size_t g = gf / F;
  const int bi = blockIdx.y, bj0 = blockIdx.x * kStrip;
  const size_t plane = static_cast<size_t>(H) * W;

  const int rb = tid % kStrip, row = tid / kStrip;
  const bool r_active = bj0 + rb < nbw;
  const size_t at = static_cast<size_t>(bi * kBs + row) * W + static_cast<size_t>(bj0 + rb) * kBs;
  uint2 ref[NC] = {};
  if (r_active) {
    int4 raw[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      raw[c] = *reinterpret_cast<const int4*>(coeffs + (gf * NC + c) * plane + at);
    // the reference rows are asked for here, long before they are used
    predicted_rows<NC, MVBS>(mv, refs + g * NC * plane, gf, bi, bj0 + rb, row, H, W, ref);
#pragma unroll
    for (int c = 0; c < NC; ++c) dequantize_row(raw[c], t.q[qsel] + row * kBs, xs[c], rb, row);
  }
  __syncthreads();
  // as (block, column): tid = block * kBs + k. T[i][k] = sum_j D[j][i] X[j][k]
  column_pass<NC, true>(xs, t, tid / kBs, tid % kBs, bj0 + tid / kBs < nbw);
  __syncthreads();
  if (r_active) {
    // Z[i][l] = sum_k T[i][k] D[k][l], i = row; + pred, clip, one 8-byte store
    uint8_t* o = out + gf * NC * plane + at;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float z[kBs];
      row_pass<true>(xs[c], t, rb, row, z);
      uint32_t packed[2] = {0u, 0u};
#pragma unroll
      for (int l = 0; l < kBs; ++l) {
        const int v = min(max(byte_at(ref[c], l) + __float2int_rn(z[l]), 0), 255);
        packed[l >> 2] |= static_cast<uint32_t>(v) << (8 * (l & 3));
      }
      *reinterpret_cast<uint2*>(o + c * plane) = make_uint2(packed[0], packed[1]);
    }
  }
}

template <int NC, int MVBS>
int launch_encode(const void* mv, const void* refs, const void* curs, const void* tabs_host,
                  void* out, int G, int F, int H, int W, int qsel, void* stream) {
  dim3 grid((W / kBs + kStrip - 1) / kStrip, H / kBs, G * F);
  plane_encode_kernel<NC, MVBS><<<grid, kStrip * kBs, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(mv), static_cast<const uint8_t*>(refs),
      static_cast<const uint8_t*>(curs), tables_from_host(tabs_host),
      static_cast<int16_t*>(out), F, H, W, qsel);
  return static_cast<int>(cudaGetLastError());
}

template <int NC, int MVBS>
int launch_decode(const void* mv, const void* refs, const void* coeffs, const void* tabs_host,
                  void* out, int G, int F, int H, int W, int qsel, void* stream) {
  dim3 grid((W / kBs + kStrip - 1) / kStrip, H / kBs, G * F);
  plane_decode_kernel<NC, MVBS><<<grid, kStrip * kBs, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(mv), static_cast<const uint8_t*>(refs),
      static_cast<const int16_t*>(coeffs), tables_from_host(tabs_host),
      static_cast<uint8_t*>(out), F, H, W, qsel);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tabs_host: the 192 floats [D, QY, QC] in host memory; they travel as the
// kernel's parameter. curs must start on an 8-byte boundary, coeffs and the
// int16 out on a 16-byte one, the uint8 out on an 8-byte one, refs on a
// 4-byte one and mv on an 8-byte one (16 for the chroma pair): the wrapper
// checks.

// The luma plane: mv [G, F, H/8, W/8, 2], refs [G, 1, H, W],
// curs / coeffs / out [G, F, 1, H, W]; the luma table.
extern "C" int vcs_plane_encode(const void* mv, const void* refs, const void* curs,
                                const void* tabs_host, void* out, int G, int F, int H, int W,
                                void* stream) {
  return launch_encode<1, 8>(mv, refs, curs, tabs_host, out, G, F, H, W, 0, stream);
}

extern "C" int vcs_plane_decode(const void* mv, const void* refs, const void* coeffs,
                                const void* tabs_host, void* out, int G, int F, int H, int W,
                                void* stream) {
  return launch_decode<1, 8>(mv, refs, coeffs, tabs_host, out, G, F, H, W, 0, stream);
}

// The two chroma planes, H x W each: mv [G, F, H/4, W/4, 2] (chroma
// vectors), refs [G, 2, H, W], curs / coeffs / out [G, F, 2, H, W]; the
// chroma table on both planes.
extern "C" int vcs_c420_encode(const void* mv, const void* refs, const void* curs,
                               const void* tabs_host, void* out, int G, int F, int H, int W,
                               void* stream) {
  return launch_encode<2, 4>(mv, refs, curs, tabs_host, out, G, F, H, W, 1, stream);
}

extern "C" int vcs_c420_decode(const void* mv, const void* refs, const void* coeffs,
                               const void* tabs_host, void* out, int G, int F, int H, int W,
                               void* stream) {
  return launch_decode<2, 4>(mv, refs, coeffs, tabs_host, out, G, F, H, W, 1, stream);
}
