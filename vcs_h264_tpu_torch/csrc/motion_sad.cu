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
// What it computes, for every 8x8 block of every P-frame f of GOP g against
// the GOP's reference (I-frame):
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
// What bounds it on an H100: integer ALU work in shared memory, about
// K*K*C*bs^2 (23k at K = 11) byte loads, subtractions and adds per block and
// frame; the frames themselves are read once (a few bytes per pixel).
// Design: one CTA per (GOP, block) with one thread per candidate (121 of 128
// threads at reach 16, step 3). The CTA stages the block's whole search
// window of the reference, C x (step*(K-1)+bs)^2 bytes, in shared memory
// ONCE and reuses it for all F frames of the GOP; per frame it stages the
// current block, each thread sums its candidate's SAD, and a warp-shuffle
// min over packed keys picks the winner. The [G, F, nbh, nbw, K, K] SAD
// tensor never reaches device memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// grid (nbw, nbh, G), block = K*K rounded up to a multiple of 32 (<= 1024).
// dynamic shared memory: C*win*win bytes of window + C*bs*bs ints of block.
__global__ void sad_search_kernel(const uint8_t* __restrict__ curs,
                                  const uint8_t* __restrict__ refs,
                                  int32_t* __restrict__ mv_out,
                                  int F, int C, int H, int W, int bs,
                                  int reach, int step, int K, int win,
                                  int sh, int sent, int static_threshold) {
  extern __shared__ unsigned char smem[];
  int* cur_s = reinterpret_cast<int*>(smem);            // [C, bs, bs]
  uint8_t* win_s = smem + sizeof(int) * C * bs * bs;    // [C, win, win]
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
          const int* crow = cur_s + c * bsq;
          for (int y = 0; y < bs; ++y)
            for (int x = 0; x < bs; ++x)
              sad += (static_cast<int>(wrow[y * win + x]) - crow[y * bs + x]) & 255;
        }
        key = min(key, (sad << sh) + cand + 1);
      }
    }
    // saturating co-located SAD, spread over the threads
    int stat = 0;
    const int ri = ci - lo_i, rj = cj - lo_j;
    for (int idx = tid; idx < C * bsq; idx += nthr) {
      const int c = idx / bsq, y = (idx / bs) % bs, x = idx % bs;
      stat += max(static_cast<int>(win_s[c * win2 + (ri + y) * win + rj + x]) - cur_s[idx], 0);
    }

    key = warp_min(key);
    stat = warp_sum(stat);
    if (lane == 0) { red_key[warp] = key; red_stat[warp] = stat; }
    __syncthreads();
    if (tid == 0) {
      int best = red_key[0], st = red_stat[0];
      for (int w = 1; w < nwarps; ++w) { best = min(best, red_key[w]); st += red_stat[w]; }
      best = min(best, sent);
      int pi = 0, pj = 0;
      if (best < sent) {
        const int flat = (best & ((1 << sh) - 1)) - 1;
        pi = lo_i + step * (flat / K);
        pj = lo_j + step * (flat % K);
      }
      if (st <= static_threshold) { pi = ci; pj = cj; }
      int32_t* o = mv_out + ((((static_cast<size_t>(g) * F + f) * nbh + bi) * nbw + bj) * 2);
      o[0] = pj - cj;
      o[1] = pi - ci;
    }
  }
}

}  // namespace

extern "C" int vcs_sad_search(const void* curs, const void* refs, void* mv_out,
                              int G, int F, int C, int H, int W, int bs,
                              int reach, int step, int static_threshold,
                              void* stream) {
  const int K = (2 * reach + step - 1) / step;       // ceil(2*reach / step)
  const int reach_span = step * (K - 1) > reach ? step * (K - 1) : reach;
  const int win = reach_span + bs;
  int sh = 0;
  while ((1 << sh) <= K * K + 1) ++sh;               // (K*K+1).bit_length()
  const int sent = (C * 255 * bs * bs + 1) << sh;
  int threads = ((K * K + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t shmem = sizeof(int) * C * bs * bs + static_cast<size_t>(C) * win * win;
  dim3 grid(W / bs, H / bs, G);
  sad_search_kernel<<<grid, threads, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(curs), static_cast<const uint8_t*>(refs),
      static_cast<int32_t*>(mv_out), F, C, H, W, bs, reach, step, K, win, sh,
      sent, static_threshold);
  return static_cast<int>(cudaGetLastError());
}
