// Shared device helpers for the port's kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define GEOA3_FULL_MASK 0xffffffffu

// Squared norm (x*x + y*y) + z*z with every product and sum rounded on its
// own (the __f*_rn intrinsics are never contracted into an FMA), so the
// value is bitwise the one the plain PyTorch version computes elementwise.
__device__ __forceinline__ float geoa3_sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__device__ __forceinline__ float geoa3_dot3(float ax, float ay, float az,
                                            float bx, float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// max((a2 + b2) - 2 ab, 0): the expansion of ops/knn.py's pairwise_sqdist,
// rounded step by step like the plain version.
__device__ __forceinline__ float geoa3_sqdist(float a2, float b2, float ab) {
  float d = __fsub_rn(__fadd_rn(a2, b2), __fmul_rn(2.0f, ab));
  return d > 0.0f ? d : 0.0f;
}

// Lexicographic (distance, index) key for a non-negative distance: the f32
// bit pattern of d >= 0 is monotone in d, the index breaks ties to the lowest.
// The +1 keeps 0 free as "nothing selected yet".
__device__ __forceinline__ unsigned long long geoa3_key(float d, int j) {
  return ((static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
          static_cast<unsigned int>(j)) + 1ull;
}

__device__ __forceinline__ unsigned long long geoa3_warp_min_u64(
    unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    unsigned long long o = __shfl_xor_sync(GEOA3_FULL_MASK, v, off);
    v = o < v ? o : v;
  }
  return v;
}

__device__ __forceinline__ float geoa3_warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(GEOA3_FULL_MASK, v, off);
  return v;
}
