// The row scatter of row 15's backward (ballquery_group.cu, dfeats) and of
// row 13 (scatter.cu, geoa3_scatter_add_nc): out[I[s], :] += D[s, :] for a
// group of rows, its first row and the rows equal to it summed in registers
// and added once, every other row by atomics (float4 where the rows allow).
#pragma once

#include "common.cuh"

namespace {

constexpr int kRows = 4;  // loads in flight a lane

__device__ __forceinline__ void add_to(float& a, float v) { a += v; }
__device__ __forceinline__ void add_to(float4& a, const float4& v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}

// out[I[s], :] += D[s, :] for a group's ns rows of w elements (float4 or
// float): the warp's lanes span the row, the slots in turn; the rows of
// `first` (slot 0 and its repeats) are summed in registers and added once.
// Indices outside [0, n) are dropped. No lane waits on another, so a warp
// may stop early.
template <class T>
__device__ __forceinline__ void scatter_rows(const int* __restrict__ I,
                                             const T* __restrict__ D, int ns,
                                             int w, int n, int first,
                                             T* __restrict__ out, int lane) {
  for (int q = lane; q - lane < w; q += 32) {
    const bool on = q < w;
    T acc{};
    for (int s0 = 0; s0 < ns; s0 += kRows) {
      int id[kRows];
      T v[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int s = s0 + u;
        id[u] = s < ns ? __ldg(I + s) : first;
        v[u] = s < ns && on ? __ldg(D + (size_t)s * w + q) : T{};
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (id[u] == first)
          add_to(acc, v[u]);
        else if (on && id[u] >= 0 && id[u] < n)
          atomicAdd(out + (size_t)id[u] * w + q, v[u]);
      }
    }
    if (on && first >= 0 && first < n) atomicAdd(out + (size_t)first * w + q, acc);
  }
}

}  // namespace
