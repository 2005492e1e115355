// K2: block motion search, frames in, motion vectors out.
//
// Replaces the TPU kernel vcs_h264_tpu/ops/motion_pallas.py:_sad_kernel_gops
// (driven by sad_candidates_pallas_gops) together with the XLA stages that
// surround it in vcs_h264_tpu/ops/motion.py:motion_search_gops: the static
// pre-pass, the packed key-min, the left-edge candidate families and
// _mvs_from_best. The int8 recentering, the one-hot box-sum matmuls, the
// phase copies and the row skip are TPU devices that change no result and
// are not carried over.
//
// What it computes, for every bs x bs block of every P-frame f of GOP g
// against the GOP's reference (I-frame):
//   * candidate positions p = max(c - reach, 0) + step * k on each axis,
//     valid iff p + bs < min(c + reach, extent);
//   * the wrapping, ordered SAD  sum_{c,y,x} (ref[p + .] - cur[.]) & 255;
//   * the first minimum in row-major (ki, kj) order via the packed key
//     (sad << sh) + (ki * K + kj + 1), against the sentinel
//     (C * 255 * bs^2 + 1) << sh; no valid candidate -> absolute (0, 0);
//   * the saturating, one-sided static check sum max(ref - cur, 0) over the
//     co-located block <= static_threshold -> zero vector;
//   * MV stored as (dx, dy) = (pj - cj, pi - ci).
//
// What bounds it on an H100: the integer instruction rate and shared-memory
// loads, K*K*C*bs^2 (23k at K = 11, C = 3, bs 8) sample differences per
// block and frame; the frames themselves are read once (a few bytes per
// pixel) and never bound it.
//
// Design (sad_search_words_kernel, block sizes 4, 8 and 16): one
// CTA per (GOP, block), one thread per candidate. Four samples share every
// instruction:
//   * the block's search window of the reference is staged ONCE for all F
//     frames, with aligned 32-bit loads, as four copies shifted by 0..3
//     bytes, so a candidate at any byte column reads whole aligned words of
//     the copy (column & 3); the copy stride is padded on the host so that a
//     warp's candidates spread over the banks;
//   * per frame the current block is staged as words b, stored as the pair
//     (b & ~H, ~b & H), H = 0x80808080, and read back by every thread with
//     one broadcast 16-byte load per row;
//   * the four wrapping byte differences of a word are
//     ((a | H) - (b & ~H)) ^ (a & H) ^ (~b & H): the subtraction cannot borrow
//     across bytes, and the exclusive-ors repair bit 7; __dp4a with
//     0x01010101 adds the four bytes to the SAD. The same sums in the same
//     integers as the byte loop, so keys, ties and the sentinel are as above;
//   * the static check comes FIRST: the threads that stage the current block
//     also sum its saturating differences against the co-located window
//     words, and a frame whose block is static skips the candidate loop for
//     the whole CTA.
// A warp-shuffle min over packed keys picks the winner; the [G, F, nbh, nbw,
// K, K] SAD tensor never reaches device memory.
//
// Three forms, chosen by shape alone (sad_search_form in sad_form.cuh,
// which vcs_sad_search_form reports without launching anything, and which
// ops/motion_cuda.py:sad_search_form repeats):
//   * words: the word kernel above, for block sizes 4, 8 and 16 on 4-byte
//     boundaries whose four window copies fit a block's shared memory;
//   * bytes: sad_search_bytes_kernel, one byte per step, the window staged
//     once per GOP and the current block per frame, both as bytes, for any
//     block size and alignment whose window fits a block's shared memory
//     (227 KB, opted into above 48 KB);
//   * direct: sad_search_direct_kernel, for windows too large for any
//     block's shared memory. It stages nothing: each thread reads its
//     candidate's reference bytes, and the current block's (the same
//     address across a warp, one broadcast), from device memory through
//     the read-only cache. It needs no shared memory beyond its
//     reductions', so it takes every geometry the search admits.
// All three keep each thread's running packed key and take the minimum over
// threads in any order: the key is unique per candidate, so the minimum is
// the first minimum in row-major order whatever the order of the reduction.

#include <cstdint>
#include <cuda_runtime.h>

#include "sad_form.cuh"

namespace {

using namespace vcs_sad;

constexpr uint32_t kHigh = 0x80808080u;   // bit 7 of each byte
constexpr uint32_t kOnes = 0x01010101u;

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// acc + sum over the four bytes of (a - b) & 255, given b as
// b_low = b & ~kHigh and nb_high = ~b & kHigh.
__device__ __forceinline__ uint32_t wrap_sad4(uint32_t a, uint32_t b_low, uint32_t nb_high,
                                              uint32_t acc) {
  const uint32_t t = (a | kHigh) - b_low;      // per byte 128 + a_low - b_low: no borrow
  const uint32_t m = (a & kHigh) ^ nb_high;    // bit 7: a7 ^ ~b7
  return __dp4a(t ^ m, kOnes, acc);
}

// sum over the four bytes of max(a - b, 0)
__device__ __forceinline__ uint32_t sat_sad4(uint32_t a, uint32_t b) {
  const uint32_t t = (a | kHigh) - (b & ~kHigh);
  const uint32_t d = t ^ ((a ^ ~b) & kHigh);                  // (a - b) & 255 per byte
  const uint32_t ge = ((a & ~b) | (~(a ^ b) & t)) & kHigh;    // bit 7: a >= b
  return __dp4a(d & ((ge >> 7) * 255u), kOnes, 0u);
}

// The winner of one block and frame: packed best key -> (dx, dy).
__device__ __forceinline__ void store_vector(int32_t* o, int best, bool is_static, int sent, int sh,
                                             int K, int step, int lo_i, int lo_j, int ci, int cj) {
  int pi = 0, pj = 0;
  best = min(best, sent);
  if (best < sent) {
    const int flat = (best & ((1 << sh) - 1)) - 1;
    pi = lo_i + step * (flat / K);
    pj = lo_j + step * (flat % K);
  }
  if (is_static) { pi = ci; pj = cj; }
  o[0] = pj - cj;
  o[1] = pi - ci;
}

// grid (nbw, nbh, G), block = K*K rounded up to a multiple of 32 (<= 1024).
// Dynamic shared memory: C*BS*BS/4 uint2 of the current block, then the four
// shifted window copies of copy_w words each, a copy being [C, win, n_w]
// words. curs, refs on 4-byte boundaries, W a multiple of 4.
template <int BS>
__global__ void sad_search_words_kernel(const uint8_t* __restrict__ curs,
                                        const uint8_t* __restrict__ refs,
                                        int32_t* __restrict__ mv_out,
                                        int F, int C, int H, int W, int reach, int step, int K,
                                        int win, int n_w, int copy_w, int sh, int sent,
                                        int static_threshold) {
  constexpr int BSW = BS / 4;                // words per block row
  extern __shared__ __align__(16) unsigned char smem[];
  const int cur_n = C * BS * BSW;
  uint2* cur_s = reinterpret_cast<uint2*>(smem);                        // [C, BS, BSW]
  uint32_t* win_s = reinterpret_cast<uint32_t*>(smem) + 2 * cur_n;
  __shared__ int red_key[kMaxThreads / 32];
  __shared__ int red_stat[kMaxThreads / 32];

  const int bj = blockIdx.x, bi = blockIdx.y, g = blockIdx.z;
  const int nbw = W / BS, nbh = H / BS;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int ci = bi * BS, cj = bj * BS;
  const int lo_i = max(ci - reach, 0), hi_i = min(ci + reach, H);
  const int lo_j = max(cj - reach, 0), hi_j = min(cj + reach, W);
  const int x0 = lo_j & ~3, off = lo_j - x0;    // the window's first aligned column
  const size_t plane = static_cast<size_t>(H) * W;
  const int chan_w = win * n_w;

  // Stage the window once for all F frames: word w of row r holds columns
  // x0 + 4w .. +3, copy s the same bytes shifted down by s. Words past the
  // frame's edge are only ever read by invalid candidates and hold 0.
  const uint8_t* ref = refs + static_cast<size_t>(g) * C * plane;
  for (int idx = tid; idx < C * chan_w; idx += nthr) {
    const int c = idx / chan_w, rem = idx - c * chan_w;
    const int r = rem / n_w, w = rem - r * n_w;
    const int y = lo_i + r, x = x0 + 4 * w;
    uint32_t a = 0, b = 0;
    if (y < H) {
      const uint32_t* row = reinterpret_cast<const uint32_t*>(ref + c * plane + static_cast<size_t>(y) * W + x);
      if (x < W) a = row[0];
      if (w + 1 < n_w && x + 4 < W) b = row[1];
    }
    win_s[idx] = a;
#pragma unroll
    for (int s = 1; s < 4; ++s) win_s[s * copy_w + idx] = __funnelshift_r(a, b, 8 * s);
  }

  const int masked = sent + ((1 << sh) - 1);
  const int ri = ci - lo_i, sb = off + cj - lo_j;   // the co-located block in the window
  const uint32_t* stat_w = win_s + (sb & 3) * copy_w + ri * n_w + (sb >> 2);
  for (int f = 0; f < F; ++f) {
    const uint8_t* cur = curs + (static_cast<size_t>(g) * F + f) * C * plane;
    __syncthreads();   // window staged / previous frame's block consumed
    int stat = 0;
    for (int idx = tid; idx < cur_n; idx += nthr) {
      const int c = idx / (BS * BSW), y = (idx / BSW) % BS, xw = idx % BSW;
      const uint32_t b = *reinterpret_cast<const uint32_t*>(
          cur + c * plane + static_cast<size_t>(ci + y) * W + cj + 4 * xw);
      cur_s[idx] = make_uint2(b & ~kHigh, ~b & kHigh);
      stat += static_cast<int>(sat_sad4(stat_w[c * chan_w + y * n_w + xw], b));
    }
    stat = warp_sum(stat);
    if (lane == 0) red_stat[warp] = stat;
    __syncthreads();
    stat = 0;
    for (int w = 0; w < nwarps; ++w) stat += red_stat[w];
    int32_t* o = mv_out + ((((static_cast<size_t>(g) * F + f) * nbh + bi) * nbw + bj) * 2);
    if (stat <= static_threshold) {            // the same for every thread of the CTA
      if (tid == 0) { o[0] = 0; o[1] = 0; }
      continue;
    }

    int key = masked;
    for (int cand = tid; cand < K * K; cand += nthr) {
      const int ki = cand / K, kj = cand - ki * K;
      const int oi = step * ki, oj = step * kj;
      if (lo_i + oi + BS < hi_i && lo_j + oj + BS < hi_j) {
        const int col = off + oj;
        const uint32_t* wp = win_s + (col & 3) * copy_w + oi * n_w + (col >> 2);
        uint32_t sad = 0;
        for (int c = 0; c < C; ++c) {
          const uint32_t* wc = wp + c * chan_w;
          const uint2* cc = cur_s + c * BS * BSW;
#pragma unroll
          for (int y = 0; y < BS; ++y) {
            if (BSW == 1) {
              const uint2 b = cc[y];
              sad = wrap_sad4(wc[y * n_w], b.x, b.y, sad);
            } else {
#pragma unroll
              for (int xw = 0; xw < BSW; xw += 2) {
                const uint4 b = *reinterpret_cast<const uint4*>(cc + y * BSW + xw);
                sad = wrap_sad4(wc[y * n_w + xw], b.x, b.y, sad);
                sad = wrap_sad4(wc[y * n_w + xw + 1], b.z, b.w, sad);
              }
            }
          }
        }
        key = min(key, static_cast<int>(sad << sh) + cand + 1);
      }
    }
    key = warp_min(key);
    if (lane == 0) red_key[warp] = key;
    __syncthreads();
    if (tid == 0) {
      int best = red_key[0];
      for (int w = 1; w < nwarps; ++w) best = min(best, red_key[w]);
      store_vector(o, best, false, sent, sh, K, step, lo_i, lo_j, ci, cj);
    }
  }
}

// grid (nbw, nbh, G), block = K*K rounded up to a multiple of 32 (<= 1024).
// dynamic shared memory: C*bs*bs bytes of block + C*win*win bytes of window.
__global__ void sad_search_bytes_kernel(const uint8_t* __restrict__ curs,
                                        const uint8_t* __restrict__ refs,
                                        int32_t* __restrict__ mv_out,
                                        int F, int C, int H, int W, int bs,
                                        int reach, int step, int K, int win,
                                        int sh, int sent, int static_threshold) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* cur_s = smem;                   // [C, bs, bs]
  uint8_t* win_s = smem + C * bs * bs;     // [C, win, win]
  __shared__ int red_key[kMaxThreads / 32];
  __shared__ int red_stat[kMaxThreads / 32];

  const int bj = blockIdx.x, bi = blockIdx.y, g = blockIdx.z;
  const int nbw = W / bs, nbh = H / bs;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int ci = bi * bs, cj = bj * bs;
  const int lo_i = max(ci - reach, 0), hi_i = min(ci + reach, H);
  const int lo_j = max(cj - reach, 0), hi_j = min(cj + reach, W);
  const size_t plane = static_cast<size_t>(H) * W;

  // Stage the search window once for all F frames; cells past the frame's
  // edge are only ever read by invalid candidates and hold 0.
  const uint8_t* ref = refs + static_cast<size_t>(g) * C * plane;
  const int win2 = win * win;
  for (int idx = tid; idx < C * win2; idx += nthr) {
    const int c = idx / win2, r = (idx / win) % win, s = idx % win;
    const int y = lo_i + r, x = lo_j + s;
    win_s[idx] = (y < H && x < W) ? ref[c * plane + static_cast<size_t>(y) * W + x] : 0;
  }

  const int masked = sent + ((1 << sh) - 1);
  const int bsq = bs * bs;
  for (int f = 0; f < F; ++f) {
    const uint8_t* cur = curs + (static_cast<size_t>(g) * F + f) * C * plane;
    __syncthreads();   // window staged / previous frame's block consumed
    for (int idx = tid; idx < C * bsq; idx += nthr) {
      const int c = idx / bsq, y = (idx / bs) % bs, x = idx % bs;
      cur_s[idx] = cur[c * plane + static_cast<size_t>(ci + y) * W + cj + x];
    }
    __syncthreads();

    int key = masked;
    for (int cand = tid; cand < K * K; cand += nthr) {
      const int ki = cand / K, kj = cand % K;
      const int oi = step * ki, oj = step * kj;
      if (lo_i + oi + bs < hi_i && lo_j + oj + bs < hi_j) {
        int sad = 0;
        for (int c = 0; c < C; ++c) {
          const uint8_t* wrow = win_s + c * win2 + oi * win + oj;
          const uint8_t* crow = cur_s + c * bsq;
          for (int y = 0; y < bs; ++y)
            for (int x = 0; x < bs; ++x)
              sad += (static_cast<int>(wrow[y * win + x]) - static_cast<int>(crow[y * bs + x])) & 255;
        }
        key = min(key, (sad << sh) + cand + 1);
      }
    }
    // saturating co-located SAD, spread over the threads
    int stat = 0;
    const int ri = ci - lo_i, rj = cj - lo_j;
    for (int idx = tid; idx < C * bsq; idx += nthr) {
      const int c = idx / bsq, y = (idx / bs) % bs, x = idx % bs;
      stat += max(static_cast<int>(win_s[c * win2 + (ri + y) * win + rj + x]) -
                  static_cast<int>(cur_s[idx]), 0);
    }

    key = warp_min(key);
    stat = warp_sum(stat);
    if (lane == 0) { red_key[warp] = key; red_stat[warp] = stat; }
    __syncthreads();
    if (tid == 0) {
      int best = red_key[0], st = red_stat[0];
      for (int w = 1; w < nwarps; ++w) { best = min(best, red_key[w]); st += red_stat[w]; }
      store_vector(mv_out + ((((static_cast<size_t>(g) * F + f) * nbh + bi) * nbw + bj) * 2), best,
                   st <= static_threshold, sent, sh, K, step, lo_i, lo_j, ci, cj);
    }
  }
}

// grid (nbw, nbh, G), block = K*K rounded up to a multiple of 32 (<= 1024,
// so at most 64 registers a thread), no dynamic shared memory: every sample
// is read from device memory. The static check comes first, as in the word
// kernel, and a static block skips its candidates.
__global__ void __launch_bounds__(kMaxThreads)
sad_search_direct_kernel(const uint8_t* __restrict__ curs, const uint8_t* __restrict__ refs,
                         int32_t* __restrict__ mv_out, int F, int C, int H, int W, int bs,
                         int reach, int step, int K, int sh, int sent, int static_threshold) {
  __shared__ int red_key[kMaxThreads / 32];
  __shared__ int red_stat[kMaxThreads / 32];

  const int bj = blockIdx.x, bi = blockIdx.y, g = blockIdx.z;
  const int nbw = W / bs, nbh = H / bs;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int ci = bi * bs, cj = bj * bs;
  const int lo_i = max(ci - reach, 0), hi_i = min(ci + reach, H);
  const int lo_j = max(cj - reach, 0), hi_j = min(cj + reach, W);
  const size_t plane = static_cast<size_t>(H) * W;
  const uint8_t* ref = refs + static_cast<size_t>(g) * C * plane;
  const int bsq = bs * bs;
  const int masked = sent + ((1 << sh) - 1);

  for (int f = 0; f < F; ++f) {
    const uint8_t* cur = curs + (static_cast<size_t>(g) * F + f) * C * plane;
    __syncthreads();   // the previous frame's reductions consumed
    int stat = 0;
    for (int idx = tid; idx < C * bsq; idx += nthr) {
      const int c = idx / bsq, y = (idx / bs) % bs, x = idx % bs;
      const size_t at = c * plane + static_cast<size_t>(ci + y) * W + cj + x;
      stat += max(static_cast<int>(__ldg(ref + at)) - static_cast<int>(__ldg(cur + at)), 0);
    }
    stat = warp_sum(stat);
    if (lane == 0) red_stat[warp] = stat;
    __syncthreads();
    stat = 0;
    for (int w = 0; w < nwarps; ++w) stat += red_stat[w];
    int32_t* o = mv_out + ((((static_cast<size_t>(g) * F + f) * nbh + bi) * nbw + bj) * 2);
    if (stat <= static_threshold) {            // the same for every thread of the CTA
      if (tid == 0) { o[0] = 0; o[1] = 0; }
      continue;
    }

    int key = masked;
    for (int cand = tid; cand < K * K; cand += nthr) {
      const int ki = cand / K, kj = cand - ki * K;
      const int pi = lo_i + step * ki, pj = lo_j + step * kj;
      if (pi + bs < hi_i && pj + bs < hi_j) {   // inside the frame: never reads past it
        int sad = 0;
        for (int c = 0; c < C; ++c) {
          const uint8_t* rp = ref + c * plane + static_cast<size_t>(pi) * W + pj;
          const uint8_t* cp = cur + c * plane + static_cast<size_t>(ci) * W + cj;
          for (int y = 0; y < bs; ++y)
            for (int x = 0; x < bs; ++x)
              sad += (static_cast<int>(__ldg(rp + static_cast<size_t>(y) * W + x)) -
                      static_cast<int>(__ldg(cp + static_cast<size_t>(y) * W + x))) & 255;
        }
        key = min(key, (sad << sh) + cand + 1);
      }
    }
    key = warp_min(key);
    if (lane == 0) red_key[warp] = key;
    __syncthreads();
    if (tid == 0) {
      int best = red_key[0];
      for (int w = 1; w < nwarps; ++w) best = min(best, red_key[w]);
      store_vector(o, best, false, sent, sh, K, step, lo_i, lo_j, ci, cj);
    }
  }
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t shmem) {
  if (shmem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(shmem));
}

template <int BS>
cudaError_t launch_words(const uint8_t* curs, const uint8_t* refs, int32_t* mv_out, dim3 grid,
                         int threads, size_t shmem, cudaStream_t stream, int F, int C, int H,
                         int W, int reach, int step, int K, int win, int n_w, int copy_w, int sh,
                         int sent, int static_threshold) {
  const cudaError_t err = allow_shared(sad_search_words_kernel<BS>, shmem);
  if (err != cudaSuccess) return err;
  sad_search_words_kernel<BS><<<grid, threads, shmem, stream>>>(
      curs, refs, mv_out, F, C, H, W, reach, step, K, win, n_w, copy_w, sh, sent,
      static_threshold);
  return cudaGetLastError();
}

}  // namespace

// The form vcs_sad_search launches for this geometry (0 words, 1 bytes, 2
// direct), its dynamic shared memory and threads per block; launches
// nothing.
extern "C" int vcs_sad_search_form(int C, int bs, int reach, int step, int aligned,
                                   int* shmem_out, int* threads_out) {
  const vcs_sad::SadPlan p = vcs_sad::sad_search_form(C, bs, reach, step, aligned != 0);
  *shmem_out = static_cast<int>(p.shmem);
  *threads_out = p.threads;
  return p.form;
}

extern "C" int vcs_sad_search(const void* curs, const void* refs, void* mv_out,
                              int G, int F, int C, int H, int W, int bs,
                              int reach, int step, int static_threshold,
                              void* stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(curs) | reinterpret_cast<uintptr_t>(refs)) % 4 == 0;
  const vcs_sad::SadPlan p = vcs_sad::sad_search_form(C, bs, reach, step, aligned);
  const int sent = (C * 255 * bs * bs + 1) << p.sh;
  const dim3 grid(W / bs, H / bs, G);
  const auto* cur_p = static_cast<const uint8_t*>(curs);
  const auto* ref_p = static_cast<const uint8_t*>(refs);
  auto* out_p = static_cast<int32_t*>(mv_out);
  const auto st = static_cast<cudaStream_t>(stream);

  cudaError_t err = cudaSuccess;
  if (p.form == vcs_sad::kFormWords) {
    if (bs == 4)
      err = launch_words<4>(cur_p, ref_p, out_p, grid, p.threads, p.shmem, st, F, C, H, W, reach,
                            step, p.K, p.win, p.n_w, p.copy_w, p.sh, sent, static_threshold);
    else if (bs == 8)
      err = launch_words<8>(cur_p, ref_p, out_p, grid, p.threads, p.shmem, st, F, C, H, W, reach,
                            step, p.K, p.win, p.n_w, p.copy_w, p.sh, sent, static_threshold);
    else
      err = launch_words<16>(cur_p, ref_p, out_p, grid, p.threads, p.shmem, st, F, C, H, W, reach,
                             step, p.K, p.win, p.n_w, p.copy_w, p.sh, sent, static_threshold);
    return static_cast<int>(err);
  }
  if (p.form == vcs_sad::kFormBytes) {
    err = allow_shared(sad_search_bytes_kernel, p.shmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sad_search_bytes_kernel<<<grid, p.threads, p.shmem, st>>>(
        cur_p, ref_p, out_p, F, C, H, W, bs, reach, step, p.K, p.win, p.sh, sent,
        static_threshold);
    return static_cast<int>(cudaGetLastError());
  }
  sad_search_direct_kernel<<<grid, p.threads, 0, st>>>(
      cur_p, ref_p, out_p, F, C, H, W, bs, reach, step, p.K, p.sh, sent, static_threshold);
  return static_cast<int>(cudaGetLastError());
}
