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
// pair, parametrised by the side of the motion grid, serves both.
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
// for both planes of c420_*. Float arithmetic is IEEE float32 rounded after
// every operation (__f*_rn; the library is built with --fmad=false), summed
// in the order of ops/dct.py, with true division, so the kernels agree with
// their plain PyTorch versions exactly.
//
// What bounds them on an H100: device-memory traffic. Per sample, encode
// reads 1 byte of cur and 1 of ref and writes 2; decode reads 2 + 1 and
// writes 1; the vectors add 8 bytes per cell. The 16 multiply-adds per
// output are far below the ALU limit. Design, as K3 / K4: one thread per
// sample, 64 threads per transform block, four neighbouring blocks of one
// block row per CTA so that a warp touches contiguous row segments; the row
// and column passes exchange through shared memory, and only the inputs and
// the final output touch device memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_origin.cuh"

namespace {

constexpr int kBs = 8;
constexpr int kPix = kBs * kBs;
constexpr int kBlocksPerCta = 4;

// tables: [D (64), QY (64), QC (64)] float32; qsel picks QY (0) or QC (1)
struct Tables {
  float d[kPix];
  float q[kPix];
};

__device__ __forceinline__ void load_tables(Tables& t, const float* __restrict__ tabs, int qsel,
                                            int tid, int nthr) {
  for (int i = tid; i < 2 * kPix; i += nthr) {
    if (i < kPix) t.d[i] = tabs[i];
    else t.q[i - kPix] = tabs[kPix * (1 + qsel) + (i - kPix)];
  }
}

// The predicted sample for (y, x) of a plane: the reference read at the
// placed source of the motion cell that holds (y, x).
template <int MVBS>
__device__ __forceinline__ int predicted(const int32_t* __restrict__ mv, const uint8_t* __restrict__ ref,
                                         size_t gf, int H, int W, int y, int x) {
  const int nmh = H / MVBS, nmw = W / MVBS;
  const int mi = y / MVBS, mj = x / MVBS;
  const int32_t* m = mv + ((gf * nmh + mi) * nmw + mj) * 2;
  const int i0 = place_origin(static_cast<long long>(mi) * MVBS + m[1], H, MVBS);
  const int j0 = place_origin(static_cast<long long>(mj) * MVBS + m[0], W, MVBS);
  return ref[static_cast<size_t>(i0 + y % MVBS) * W + j0 + x % MVBS];
}

// grid (ceil(nbw / 4), nbh, G*F*C), block (64, 4)
template <int MVBS>
__global__ void plane_encode_kernel(const int32_t* __restrict__ mv,
                                    const uint8_t* __restrict__ refs,
                                    const uint8_t* __restrict__ curs,
                                    const float* __restrict__ tabs,
                                    int16_t* __restrict__ out,
                                    int F, int C, int H, int W, int qsel) {
  __shared__ Tables t;
  __shared__ float xa[kBlocksPerCta][kPix];
  __shared__ float xb[kBlocksPerCta][kPix];
  const int p = threadIdx.x, sub = threadIdx.y;
  load_tables(t, tabs, qsel, sub * kPix + p, kPix * kBlocksPerCta);

  const size_t z = blockIdx.z;                 // (g * F + f) * C + c
  const size_t gf = z / C;
  const int c = static_cast<int>(z % C);
  const size_t g = gf / F;
  const int bi = blockIdx.y, bj = blockIdx.x * kBlocksPerCta + sub;
  const bool active = bj < W / kBs;
  const int py = p / kBs, px = p % kBs;
  const size_t plane = static_cast<size_t>(H) * W;
  const int y = bi * kBs + py, x = bj * kBs + px;

  if (active) {
    const int pred = predicted<MVBS>(mv, refs + (g * C + c) * plane, gf, H, W, y, x);
    const int cur = curs[z * plane + static_cast<size_t>(y) * W + x];
    xa[sub][p] = static_cast<float>(cur - pred);
  }
  __syncthreads();
  if (active) {
    // rows: T[i][k] = sum_j D[i][j] X[j][k]
    float acc = 0.0f;
    for (int j = 0; j < kBs; ++j)
      acc = __fadd_rn(acc, __fmul_rn(t.d[py * kBs + j], xa[sub][j * kBs + px]));
    xb[sub][p] = acc;
  }
  __syncthreads();
  if (active) {
    // columns: Z[i][l] = sum_k T[i][k] D[l][k], then / Q and round
    float acc = 0.0f;
    for (int k = 0; k < kBs; ++k)
      acc = __fadd_rn(acc, __fmul_rn(xb[sub][py * kBs + k], t.d[px * kBs + k]));
    out[z * plane + static_cast<size_t>(y) * W + x] =
        static_cast<int16_t>(__float2int_rn(__fdiv_rn(acc, t.q[p])));
  }
}

// grid (ceil(nbw / 4), nbh, G*F*C), block (64, 4)
template <int MVBS>
__global__ void plane_decode_kernel(const int32_t* __restrict__ mv,
                                    const uint8_t* __restrict__ refs,
                                    const int16_t* __restrict__ coeffs,
                                    const float* __restrict__ tabs,
                                    uint8_t* __restrict__ out,
                                    int F, int C, int H, int W, int qsel) {
  __shared__ Tables t;
  __shared__ float xa[kBlocksPerCta][kPix];
  __shared__ float xb[kBlocksPerCta][kPix];
  const int p = threadIdx.x, sub = threadIdx.y;
  load_tables(t, tabs, qsel, sub * kPix + p, kPix * kBlocksPerCta);
  __syncthreads();

  const size_t z = blockIdx.z;                 // (g * F + f) * C + c
  const size_t gf = z / C;
  const int c = static_cast<int>(z % C);
  const size_t g = gf / F;
  const int bi = blockIdx.y, bj = blockIdx.x * kBlocksPerCta + sub;
  const bool active = bj < W / kBs;
  const int py = p / kBs, px = p % kBs;
  const size_t plane = static_cast<size_t>(H) * W;
  const int y = bi * kBs + py, x = bj * kBs + px;
  const size_t at = z * plane + static_cast<size_t>(y) * W + x;

  if (active) xa[sub][p] = __fmul_rn(static_cast<float>(coeffs[at]), t.q[p]);
  __syncthreads();
  if (active) {
    // T[i][k] = sum_j D[j][i] X[j][k]
    float acc = 0.0f;
    for (int j = 0; j < kBs; ++j)
      acc = __fadd_rn(acc, __fmul_rn(t.d[j * kBs + py], xa[sub][j * kBs + px]));
    xb[sub][p] = acc;
  }
  __syncthreads();
  if (active) {
    // Z[i][l] = sum_k T[i][k] D[k][l]
    float acc = 0.0f;
    for (int k = 0; k < kBs; ++k)
      acc = __fadd_rn(acc, __fmul_rn(xb[sub][py * kBs + k], t.d[k * kBs + px]));
    const int pred = predicted<MVBS>(mv, refs + (g * C + c) * plane, gf, H, W, y, x);
    out[at] = static_cast<uint8_t>(min(max(pred + __float2int_rn(acc), 0), 255));
  }
}

template <int MVBS>
int launch_encode(const void* mv, const void* refs, const void* curs, const void* tabs,
                  void* out, int G, int F, int C, int H, int W, int qsel, void* stream) {
  dim3 grid((W / kBs + kBlocksPerCta - 1) / kBlocksPerCta, H / kBs, G * F * C);
  dim3 block(kPix, kBlocksPerCta);
  plane_encode_kernel<MVBS><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(mv), static_cast<const uint8_t*>(refs),
      static_cast<const uint8_t*>(curs), static_cast<const float*>(tabs),
      static_cast<int16_t*>(out), F, C, H, W, qsel);
  return static_cast<int>(cudaGetLastError());
}

template <int MVBS>
int launch_decode(const void* mv, const void* refs, const void* coeffs, const void* tabs,
                  void* out, int G, int F, int C, int H, int W, int qsel, void* stream) {
  dim3 grid((W / kBs + kBlocksPerCta - 1) / kBlocksPerCta, H / kBs, G * F * C);
  dim3 block(kPix, kBlocksPerCta);
  plane_decode_kernel<MVBS><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(mv), static_cast<const uint8_t*>(refs),
      static_cast<const int16_t*>(coeffs), static_cast<const float*>(tabs),
      static_cast<uint8_t*>(out), F, C, H, W, qsel);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The luma plane: mv [G, F, H/8, W/8, 2], refs [G, 1, H, W],
// curs / coeffs / out [G, F, 1, H, W]; the luma table.
extern "C" int vcs_plane_encode(const void* mv, const void* refs, const void* curs,
                                const void* tabs, void* out, int G, int F, int H, int W,
                                void* stream) {
  return launch_encode<8>(mv, refs, curs, tabs, out, G, F, 1, H, W, 0, stream);
}

extern "C" int vcs_plane_decode(const void* mv, const void* refs, const void* coeffs,
                                const void* tabs, void* out, int G, int F, int H, int W,
                                void* stream) {
  return launch_decode<8>(mv, refs, coeffs, tabs, out, G, F, 1, H, W, 0, stream);
}

// The two chroma planes, H x W each: mv [G, F, H/4, W/4, 2] (chroma
// vectors), refs [G, 2, H, W], curs / coeffs / out [G, F, 2, H, W]; the
// chroma table on both planes.
extern "C" int vcs_c420_encode(const void* mv, const void* refs, const void* curs,
                               const void* tabs, void* out, int G, int F, int H, int W,
                               void* stream) {
  return launch_encode<4>(mv, refs, curs, tabs, out, G, F, 2, H, W, 1, stream);
}

extern "C" int vcs_c420_decode(const void* mv, const void* refs, const void* coeffs,
                               const void* tabs, void* out, int G, int F, int H, int W,
                               void* stream) {
  return launch_decode<4>(mv, refs, coeffs, tabs, out, G, F, 2, H, W, 1, stream);
}
