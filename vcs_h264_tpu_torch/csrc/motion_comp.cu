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
// written per output value (about 66 MB out and 22 MB in for 8 GOPs of 3
// P-frames of 1280x720x3), no arithmetic to speak of; after the bytes, the
// number of memory instructions it takes to move them. Two forms, chosen by
// the wrapper (ops/motion_cuda.py:compensate_form) and passed in as `form`:
//
//   * the fast form, for block sizes 4, 8 and 16 on rows that are multiples
//     of 16 bytes, refs on a 4-byte and out on a 16-byte boundary: every
//     shape the codec's paths launch. A thread owns 16 neighbouring output
//     bytes of a block row (one block at bs 16, two at bs 8, four cells at
//     bs 4): it reads their vectors and places their origins once, then
//     walks its rows and the C channels. Each source row segment is cut out
//     of aligned 32-bit words with __funnelshift_r (shifted_rows.cuh: the
//     shift is the same for every row and channel of a block), each store is
//     one 16-byte word, so a warp writes 512 contiguous bytes a row. The work
//     items (frame, block row, 16-byte column) are flattened over the grid,
//     so every thread of every CTA but the last has work whatever W is. No
//     shared memory, no barrier, no division by the block size.
//   * the general form, for everything else (other block sizes, ragged
//     widths, operands off those boundaries): one CTA per 1024-pixel segment
//     of one output row; the CTA first places the origins of the block
//     columns its segment touches, once per block, into shared memory; then
//     each thread gathers 4 neighbouring pixels of the C channels byte by
//     byte and, when W is a multiple of 4 and out lies on a 4-byte boundary,
//     writes each channel's 4 bytes as one aligned 32-bit store.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_origin.cuh"
#include "shifted_rows.cuh"

namespace {

// ---- the fast form ---------------------------------------------------------

constexpr int kFastThreads = 256;
constexpr int kOutBytes = 16;                  // output bytes of a row per thread

// grid (ceil(items / 256)), block 256; items = G*F * nbh * (W / 16)
template <int BS>
__global__ void __launch_bounds__(kFastThreads) compensate_fast_kernel(
    const int32_t* __restrict__ mv, const uint8_t* __restrict__ refs,
    uint8_t* __restrict__ out, long long items, int F, int C, int H, int W) {
  constexpr int kBlocks = kOutBytes / BS;      // blocks under a thread's 16 bytes
  constexpr int kWords = BS / 4;               // words of a block's row
  const long long item = static_cast<long long>(blockIdx.x) * kFastThreads + threadIdx.x;
  if (item >= items) return;
  const int nbh = H / BS, nbw = W / BS, wq = W / kOutBytes;
  const int xq = static_cast<int>(item % wq);
  const long long rest = item / wq;
  const int bi = static_cast<int>(rest % nbh);
  const size_t gf = static_cast<size_t>(rest / nbh);
  const size_t g = gf / F;
  const size_t plane = static_cast<size_t>(H) * W;

  // per block: the aligned word its first source row starts in, and the
  // byte shift, which every row and channel of the block share (W and H * W
  // are multiples of 4)
  const uint32_t* src[kBlocks];
  unsigned shift[kBlocks];
  const uint8_t* ref = refs + g * C * plane;
#pragma unroll
  for (int b = 0; b < kBlocks; ++b) {
    const int bj = xq * kBlocks + b;
    const int32_t* m = mv + ((gf * nbh + bi) * nbw + bj) * 2;
    const int i0 = place_origin(static_cast<long long>(bi) * BS + m[1], H, BS);
    const int j0 = place_origin(static_cast<long long>(bj) * BS + m[0], W, BS);
    const uint8_t* p = ref + static_cast<size_t>(i0) * W + j0;
    shift[b] = static_cast<unsigned>(reinterpret_cast<uintptr_t>(p) & 3u);
    src[b] = reinterpret_cast<const uint32_t*>(p - shift[b]);
  }
  uint8_t* dst = out + gf * C * plane + static_cast<size_t>(bi) * BS * W
                 + static_cast<size_t>(xq) * kOutBytes;
  const size_t row_words = static_cast<size_t>(W) / 4, plane_words = plane / 4;
  for (int c = 0; c < C; ++c) {
    uint32_t v[BS][kOutBytes / 4];
#pragma unroll
    for (int r = 0; r < BS; ++r)
#pragma unroll
      for (int b = 0; b < kBlocks; ++b)
        load_shifted<kWords>(src[b] + c * plane_words + r * row_words, shift[b],
                             &v[r][b * kWords]);
#pragma unroll
    for (int r = 0; r < BS; ++r)
      *reinterpret_cast<uint4*>(dst + c * plane + static_cast<size_t>(r) * W) =
          make_uint4(v[r][0], v[r][1], v[r][2], v[r][3]);
  }
}

template <int BS>
cudaError_t launch_fast(const int32_t* mv, const uint8_t* refs, uint8_t* out, int G, int F,
                        int C, int H, int W, cudaStream_t stream) {
  const long long items = static_cast<long long>(G) * F * (H / BS) * (W / kOutBytes);
  const long long ctas = (items + kFastThreads - 1) / kFastThreads;
  if (ctas > 2147483647LL) return cudaErrorInvalidConfiguration;
  compensate_fast_kernel<BS><<<static_cast<unsigned>(ctas), kFastThreads, 0, stream>>>(
      mv, refs, out, items, F, C, H, W);
  return cudaGetLastError();
}

// ---- the general form ------------------------------------------------------

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
  // 32-bit stores where every row's 4-pixel groups lie on word boundaries
  const bool words = (W % kPix) == 0 && (reinterpret_cast<uintptr_t>(out) & 3u) == 0;
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

// form: 1 the fast form (bs 4, 8 or 16, W a multiple of 16, refs on a 4-byte
// and out on a 16-byte boundary: the wrapper decides), 0 the general form.
extern "C" int vcs_compensate(const void* mv, const void* refs, void* out, int G, int F,
                              int C, int H, int W, int bs, int form, void* stream) {
  const auto* m = static_cast<const int32_t*>(mv);
  const auto* r = static_cast<const uint8_t*>(refs);
  auto* o = static_cast<uint8_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (form == 1) {
    if (W % kOutBytes) return static_cast<int>(cudaErrorInvalidValue);
    switch (bs) {
      case 4: return static_cast<int>(launch_fast<4>(m, r, o, G, F, C, H, W, s));
      case 8: return static_cast<int>(launch_fast<8>(m, r, o, G, F, C, H, W, s));
      case 16: return static_cast<int>(launch_fast<16>(m, r, o, G, F, C, H, W, s));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  dim3 grid((W + kSeg - 1) / kSeg, H, G * F);
  compensate_kernel<<<grid, kThreads, 0, s>>>(m, r, o, F, C, H, W, bs);
  return static_cast<int>(cudaGetLastError());
}
