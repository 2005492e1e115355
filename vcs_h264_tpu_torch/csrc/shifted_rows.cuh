// A run of 4, 8 or 16 bytes that starts at any byte of a uint8 tensor, cut
// out of the aligned 32-bit words around it: shared by K1 (motion_comp.cu)
// and K3/K4 (inter_fused.cu), whose compensated source rows start wherever
// the block's vector puts them.
//
// The tensor's own start must lie on a 4-byte boundary and its rows must be
// multiples of 4 long (the wrappers check). The word after the run's last
// full one is read only where the bytes reach into it, so nothing past the
// word that holds the run's last byte is touched: a run that ends with the
// tensor reads nothing past the tensor.
#pragma once

#include <cstdint>

// The 8 bytes that start at p.
__device__ __forceinline__ uint2 load_row8(const uint8_t* p) {
  const unsigned s = static_cast<unsigned>(reinterpret_cast<uintptr_t>(p) & 3u);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(p - s);
  const uint32_t a = w[0], b = w[1], c = s ? w[2] : 0u;
  return make_uint2(__funnelshift_r(a, b, 8 * s), __funnelshift_r(b, c, 8 * s));
}

__device__ __forceinline__ int byte_at(uint2 v, int k) {
  return static_cast<int>(((k < 4 ? v.x : v.y) >> (8 * (k & 3))) & 255u);
}

// The 4 * NW bytes that start s bytes (0..3) into the aligned word w[0], as
// NW words.
template <int NW>
__device__ __forceinline__ void load_shifted(const uint32_t* w, unsigned s, uint32_t* out) {
  uint32_t v[NW + 1];
#pragma unroll
  for (int i = 0; i < NW; ++i) v[i] = w[i];
  v[NW] = s ? w[NW] : 0u;
#pragma unroll
  for (int i = 0; i < NW; ++i) out[i] = __funnelshift_r(v[i], v[i + 1], 8 * s);
}
