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
// true division where the plain version divides, and each 8-term DCT sum in
// the order ops/dct.py adds in, so on the card the kernels give what the
// plain PyTorch versions give.
//
// What bounds them on an H100: device-memory traffic. Per pixel and
// channel, encode reads 1 byte of cur and 1 byte of ref and writes 2 bytes;
// decode reads 2 + 1 and writes 1. The 16 multiply-adds per output of the
// two 8-point passes cannot fuse (each product and each sum is rounded), so
// once the bytes move in wide words the limit is instruction issue: about 80
// instructions a sample, 35 of them those multiplies and adds and (K3) 11
// the true division. What the design does about both: a CTA takes a strip
// of 16 neighbouring blocks of one block row, all three channels; every access to
// device memory is an aligned word of 8 or 16 bytes (4 for the shifted
// reference row) in runs of 128 to 256 contiguous bytes a warp; each 8-point
// pass runs in one thread's registers with D as immediate operands from the
// kernel's parameters; the passes exchange through one skewed shared buffer
// free of bank conflicts; nothing but the inputs and the final output
// touches device memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_origin.cuh"
#include "dct_strip.cuh"
#include "shifted_rows.cuh"

namespace {

// Start of the compensated source block.
__device__ __forceinline__ void source_origin(const int32_t* __restrict__ mv, size_t gf, int nbh,
                                              int nbw, int bi, int bj, int H, int W,
                                              int& i0, int& j0) {
  const int32_t* m = mv + ((gf * nbh + bi) * nbw + bj) * 2;
  i0 = place_origin(static_cast<long long>(bi) * kBs + m[1], H, kBs);
  j0 = place_origin(static_cast<long long>(bj) * kBs + m[0], W, kBs);
}

// ---- the strip of blocks a CTA takes, in both directions -------------------
//
// What kept the first version of both kernels at six times their byte bound
// was how it moved the bytes: a thread a pixel, so a warp touched four rows
// of 8 px (half a sector a coefficient load or store, a quarter a pixel load
// or store, one or two bytes a thread), 64-thread blocks with two or three
// barriers and a table load from device memory each, 48 shared loads a
// sample in the two passes, and the block's vector read 64 times.
//
// Here a CTA takes kStrip neighbouring blocks of one block row, all three
// channels, with one thread per block and row (or column), on the strip
// machinery of dct_strip.cuh. The decode (K4):
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
// with __funnelshift_r (shifted_rows.cuh). The vector is read once a thread,
// 8 times a block.
//
// Every float operation of the first version and its order are kept: each
// output is acc = 0, acc = acc + d[j] * x[j] for j = 0..7 with every product
// and sum rounded, then the inverse RCT with true divisions, so the frames
// are the same bit for bit.
//
// The encode (K3) is the same strip run forwards:
//   * load: the thread of (block, row) reads the 8 bytes of its row of cur
//     of each channel as one aligned word (a warp reads two runs of 128
//     contiguous bytes) and the compensated reference row as above, forms
//     the residual and the RCT of its 8 pixels in registers and leaves
//     y, cr, cb in the exchange buffer;
//   * first pass: the thread of (block, column k) forms T[i][k] = sum_j
//     D[i][j] X[j][k] for i = 0..7;
//   * second pass: the thread of (block, row i) forms Z[i][l] = sum_k T[i][k]
//     D[l][k], divides by Q[c][8 i + l] (a true division: a reciprocal
//     multiply rounds twice and the .5 ties are common), rounds half to even
//     and stores its row of each channel as one 16-byte word of eight int16,
//     so a warp writes two runs of 256 contiguous bytes.
// Its float operations and their order are those of its first version too
// (a thread a pixel): the RCT's expressions, acc = 0, acc = acc + d * x in
// ascending j and k, the division, __float2int_rn, the low 16 bits.

// grid (ceil(nbw / kStrip), nbh, G*F), block (kStrip * kBs)
__global__ void __launch_bounds__(kStrip * kBs) fused_p_decode_kernel(
    const int32_t* __restrict__ mv, const uint8_t* __restrict__ refs,
    const int16_t* __restrict__ coeffs, const __grid_constant__ Tables t,
    uint8_t* __restrict__ out, int F, int H, int W) {
  __shared__ float xs[3][kPlaneWords];
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
    for (int c = 0; c < 3; ++c) dequantize_row(raw[c], t.q[c == 0 ? 0 : 1] + row * kBs, xs[c], rb, row);
  }
  __syncthreads();
  // as (block, column): tid = block * kBs + k. T[i][k] = sum_j D[j][i] X[j][k]
  column_pass<3, true>(xs, t, tid / kBs, tid % kBs, bj0 + tid / kBs < nbw);
  __syncthreads();
  if (r_active) {
    // Z[i][l] = sum_k T[i][k] D[k][l], i = row
    float z[3][kBs];
#pragma unroll
    for (int c = 0; c < 3; ++c) row_pass<true>(xs[c], t, rb, row, z[c]);
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

// grid (ceil(nbw / kStrip), nbh, G*F), block (kStrip * kBs)
__global__ void __launch_bounds__(kStrip * kBs) fused_p_encode_kernel(
    const int32_t* __restrict__ mv, const uint8_t* __restrict__ refs,
    const uint8_t* __restrict__ curs, const __grid_constant__ Tables t,
    int16_t* __restrict__ out, int F, int H, int W) {
  __shared__ float xs[3][kPlaneWords];
  const int tid = threadIdx.x;
  const int nbh = H / kBs, nbw = W / kBs;
  const size_t gf = blockIdx.z;
  const int g = static_cast<int>(gf / F);
  const int bi = blockIdx.y, bj0 = blockIdx.x * kStrip;
  const size_t plane = static_cast<size_t>(H) * W;

  // as (block, row): tid = row * kStrip + block, for the load, the second
  // pass and the store
  const int blk = tid % kStrip, row = tid / kStrip;
  const bool r_active = bj0 + blk < nbw;
  const size_t at = static_cast<size_t>(bi * kBs + row) * W + static_cast<size_t>(bj0 + blk) * kBs;
  if (r_active) {
    const uint8_t* cp = curs + gf * 3 * plane + at;
    uint2 cur[3], ref[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) cur[c] = *reinterpret_cast<const uint2*>(cp + c * plane);
    int i0, j0;
    source_origin(mv, gf, nbh, nbw, bi, bj0 + blk, H, W, i0, j0);
    const uint8_t* rp = refs + static_cast<size_t>(g) * 3 * plane + static_cast<size_t>(i0 + row) * W + j0;
#pragma unroll
    for (int c = 0; c < 3; ++c) ref[c] = load_row8(rp + c * plane);
#pragma unroll
    for (int k = 0; k < kBs; ++k) {
      const float rb = static_cast<float>(byte_at(cur[0], k) - byte_at(ref[0], k));
      const float rg = static_cast<float>(byte_at(cur[1], k) - byte_at(ref[1], k));
      const float rr = static_cast<float>(byte_at(cur[2], k) - byte_at(ref[2], k));
      const float yy = __fadd_rn(__fadd_rn(__fmul_rn(0.299f, rr), __fmul_rn(0.587f, rg)),
                                 __fmul_rn(0.114f, rb));
      const int e = exchange_at(blk, row, k);
      xs[0][e] = yy;
      xs[1][e] = __fmul_rn(__fsub_rn(rr, yy), 0.713f);
      xs[2][e] = __fmul_rn(__fsub_rn(rb, yy), 0.564f);
    }
  }
  __syncthreads();
  // as (block, column): tid = block * kBs + k. T[i][k] = sum_j D[i][j] X[j][k]
  column_pass<3, false>(xs, t, tid / kBs, tid % kBs, bj0 + tid / kBs < nbw);
  __syncthreads();
  if (r_active) {
    // Z[i][l] = sum_k T[i][k] D[l][k], i = row; then / Q, round, and the low
    // 16 bits of each of the row's eight values, two to a word
    int16_t* o = out + gf * 3 * plane + at;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float z[kBs];
      row_pass<false>(xs[c], t, blk, row, z);
      *reinterpret_cast<uint4*>(o + c * plane) = quantize_row(z, t.q[c == 0 ? 0 : 1] + row * kBs);
    }
  }
}

}  // namespace

// enc_tabs_host: the 192 floats [D, QY, QC] in host memory; they travel as
// the kernel's parameter. curs must start on an 8-byte boundary, out on a
// 16-byte and refs on a 4-byte one (the wrapper checks).
extern "C" int vcs_fused_p_encode(const void* mv, const void* refs, const void* curs,
                                  const void* enc_tabs_host, void* out, int G, int F, int H,
                                  int W, void* stream) {
  dim3 grid((W / kBs + kStrip - 1) / kStrip, H / kBs, G * F);
  fused_p_encode_kernel<<<grid, kStrip * kBs, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(mv), static_cast<const uint8_t*>(refs),
      static_cast<const uint8_t*>(curs), tables_from_host(enc_tabs_host),
      static_cast<int16_t*>(out), F, H, W);
  return static_cast<int>(cudaGetLastError());
}

// tabs_host: as above. coeffs must start on a 16-byte boundary, out on an
// 8-byte and refs on a 4-byte one (the wrapper checks).
extern "C" int vcs_fused_p_decode(const void* mv, const void* refs, const void* coeffs,
                                  const void* tabs_host, void* out, int G, int F, int H, int W,
                                  void* stream) {
  dim3 grid((W / kBs + kStrip - 1) / kStrip, H / kBs, G * F);
  fused_p_decode_kernel<<<grid, kStrip * kBs, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(mv), static_cast<const uint8_t*>(refs),
      static_cast<const int16_t*>(coeffs), tables_from_host(tabs_host),
      static_cast<uint8_t*>(out), F, H, W);
  return static_cast<int>(cudaGetLastError());
}
