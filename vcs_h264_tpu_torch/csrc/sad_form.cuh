// K2's search geometry and the form (kernel) that takes it, from the shape
// alone: shared by motion_sad.cu's launcher and its form query. Host code in
// plain C++, so that the CPU tests compile it with g++ and hold
// ops/motion_cuda.py:sad_search_form to it.
#pragma once

#include <array>
#include <cstddef>
#include <map>
#include <mutex>

namespace vcs_sad {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSharedBytes = 232448;   // dynamic shared memory a block may opt into

// Words between the shifted window copies: the least padding of c_words for
// which the candidates of each warp (consecutive flat indices, copy
// (step * kj) & 3, word row step * ki) fall on the fewest common banks.
// K*K*32 steps on the host (half a million at K = 128), so each answer is
// kept for the process.
inline int padded_copy_words(int c_words, int K, int step, int n_w) {
  static std::mutex mu;
  static std::map<std::array<int, 4>, int> known;
  const std::array<int, 4> key{c_words, K, step, n_w};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find(key);
  if (it != known.end()) return it->second;
  int best_pad = 0, best_cost = 1 << 30;
  for (int pad = 0; pad < 32; ++pad) {
    int cost = 0;
    for (int first = 0; first < K * K; first += 32) {
      int hits[32] = {0}, worst = 0;
      for (int cand = first; cand < K * K && cand < first + 32; ++cand) {
        const int col = step * (cand % K);
        const int bank = ((col & 3) * (c_words + pad) + step * (cand / K) * n_w + (col >> 2)) & 31;
        if (++hits[bank] > worst) worst = hits[bank];
      }
      cost += worst;
    }
    if (cost < best_cost) { best_cost = cost; best_pad = pad; }
  }
  known.emplace(key, c_words + best_pad);
  return c_words + best_pad;
}

enum SadForm { kFormWords = 0, kFormBytes = 1, kFormDirect = 2 };

// The search geometry and the form that takes it, from the shape alone.
struct SadPlan {
  int K, win, n_w, copy_w, sh, threads, form;
  size_t shmem;
};

inline SadPlan sad_search_form(int C, int bs, int reach, int step, bool aligned) {
  SadPlan p{};
  p.K = (2 * reach + step - 1) / step;                 // ceil(2*reach / step)
  const int reach_span = step * (p.K - 1) > reach ? step * (p.K - 1) : reach;
  p.win = reach_span + bs;
  while ((1 << p.sh) <= p.K * p.K + 1) ++p.sh;         // (K*K+1).bit_length()
  p.threads = ((p.K * p.K + 31) / 32) * 32;
  if (p.threads > kMaxThreads) p.threads = kMaxThreads;
  // The word kernel: 3 more bytes per row for the window's aligned start.
  p.n_w = (p.win + 3 + 3) / 4;
  const size_t block_words = 8u * C * bs * (bs / 4);
  const size_t copies = 16u * C * static_cast<size_t>(p.win) * p.n_w;
  if ((bs == 4 || bs == 8 || bs == 16) && aligned && block_words + copies <= kMaxSharedBytes) {
    p.copy_w = padded_copy_words(C * p.win * p.n_w, p.K, step, p.n_w);
    p.shmem = block_words + 16u * p.copy_w;
    if (p.shmem <= kMaxSharedBytes) {
      p.form = kFormWords;
      return p;
    }
  }
  p.copy_w = 0;
  p.shmem = static_cast<size_t>(C) * bs * bs + static_cast<size_t>(C) * p.win * p.win;
  if (p.shmem <= kMaxSharedBytes) {
    p.form = kFormBytes;
    return p;
  }
  p.shmem = 0;
  p.form = kFormDirect;
  return p;
}

}  // namespace vcs_sad
