// Where a motion-compensated block is read from, shared by K1
// (motion_comp.cu) and K3/K4 (inter_fused.cu) so that the kernels place a
// source block the same way.
#pragma once

// Start of a block's source along one axis, as lax.dynamic_slice places it
// in the JAX package's gather: a negative origin o = bs * b + d first gets
// the extent added, then it is clamped into [0, extent - bs]. The origin is
// 64-bit, as the plain PyTorch gather computes it, so no vector overflows.
__device__ __forceinline__ int place_origin(long long o, int extent, int bs) {
  if (o < 0) o += extent;
  return static_cast<int>(min(max(o, 0LL), static_cast<long long>(extent - bs)));
}
