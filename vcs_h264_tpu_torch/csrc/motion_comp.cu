// K1: block motion compensation.
//
// Replaces the TPU kernel vcs_h264_tpu/ops/motion_pallas.py: _comp_kernel
// (called through motion_compensate_pallas_gops). The TPU has no gather, so
// that kernel mixes columns with a one-hot matmul, selects among
// 2 * reach + 1 row shifts, DMAs row octets and pads rows to 128 lanes; it
// needs |d| <= reach. None of that is carried over: on Hopper this is a
// plain gather, and it takes any vector.
//
// What it computes, for block (bi, bj) of frame f of GOP g with vector
// (dx, dy): out[g, f, c, bs bi + y, bs bj + x] = ref[g, c, i0 + y, j0 + x],
// with i0 = place_origin(bs bi + dy, H, bs) and j0 = place_origin(bs bj + dx,
// W, bs) (block_origin.cuh: the XLA gather's placement, identical to the
// plain PyTorch version, ops/motion.py:motion_compensate_plain).
//
// What bounds it on an H100: device-memory traffic, one byte read and one
// written per output value (about 66 MB each way for 8 GOPs of 3 P-frames of
// 1280x720x3), no arithmetic to speak of. Design: one CTA per 1024-pixel
// segment of one output row; the CTA first places the origins of the block
// columns its segment touches, once per block, into shared memory; then each
// thread gathers 4 neighbouring pixels of the C channels and, when W is a
// multiple of 4, writes each channel's 4 bytes as one aligned 32-bit store,
// so a warp writes 128 contiguous bytes of a row.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_origin.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 4;                        // output pixels per thread
constexpr int kSeg = kThreads * kPix;          // pixels of a row per CTA
// block columns a segment touches at bs >= 2: kSeg / 2 + 1
constexpr int kMaxCols = kSeg / 2 + 2;

// grid (ceil(W / 1024), H, G*F), block 256
__global__ void compensate_kernel(const int32_t* __restrict__ mv,
                                  const uint8_t* __restrict__ refs,
                                  uint8_t* __restrict__ out,
                                  int F, int C, int H, int W, int bs) {
  __shared__ int2 origin[kMaxCols];          // (i0, j0) per block column
  const int nbh = H / bs, nbw = W / bs;
  const size_t gf = blockIdx.z;
  const int g = static_cast<int>(gf / F);
  const int y = blockIdx.y, bi = y / bs;
  const int x0 = blockIdx.x * kSeg;
  const int bj0 = x0 / bs;
  const int bj1 = min(nbw - 1, (x0 + kSeg - 1) / bs);

  for (int k = threadIdx.x; k <= bj1 - bj0; k += kThreads) {
    const int32_t* m = mv + ((gf * nbh + bi) * nbw + bj0 + k) * 2;
    origin[k] = make_int2(
        place_origin(static_cast<long long>(bi) * bs + m[1], H, bs),
        place_origin(static_cast<long long>(bj0 + k) * bs + m[0], W, bs));
  }
  __syncthreads();

  const int x = x0 + threadIdx.x * kPix;
  if (x >= W) return;
  const int n = min(kPix, W - x);            // pixels of this thread in the row
  int off[kPix];                             // source offset within a plane
  for (int p = 0; p < kPix; ++p) {
    const int xp = x + min(p, n - 1);        // past the row: repeat the last
    const int bj = xp / bs;
    const int2 o = origin[bj - bj0];
    off[p] = (o.x + y - bi * bs) * W + o.y + (xp - bj * bs);
  }
  const size_t plane = static_cast<size_t>(H) * W;
  const uint8_t* ref = refs + static_cast<size_t>(g) * C * plane;
  uint8_t* dst = out + gf * C * plane + static_cast<size_t>(y) * W + x;
  const bool words = (W % kPix) == 0;        // then x, W and H*W are too
  for (int c = 0; c < C; ++c) {
    const uint8_t* src = ref + c * plane;
    if (words) {
      const uint32_t v = static_cast<uint32_t>(src[off[0]])
                         | static_cast<uint32_t>(src[off[1]]) << 8
                         | static_cast<uint32_t>(src[off[2]]) << 16
                         | static_cast<uint32_t>(src[off[3]]) << 24;
      *reinterpret_cast<uint32_t*>(dst + c * plane) = v;
    } else {
      for (int p = 0; p < n; ++p) dst[c * plane + p] = src[off[p]];
    }
  }
}

}  // namespace

extern "C" int vcs_compensate(const void* mv, const void* refs, void* out, int G, int F,
                              int C, int H, int W, int bs, void* stream) {
  dim3 grid((W + kSeg - 1) / kSeg, H, G * F);
  compensate_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(mv), static_cast<const uint8_t*>(refs),
      static_cast<uint8_t*>(out), F, C, H, W, bs);
  return static_cast<int>(cudaGetLastError());
}
