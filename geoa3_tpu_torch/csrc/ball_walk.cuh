// One warp's ball query over a cloud staged in shared memory as float4
// (x, y, z, |x|^2), or read from device memory where it does not fit.
// ballquery_group.cu (row 15) runs it; a kernel that stages its cloud in
// that layout, |x|^2 by geoa3_sq3 (so every distance is bitwise the plain
// version's), can call geoa3_ball_walk<true> in the same way.
#pragma once

#include "common.cuh"

namespace geoa3 {
constexpr int kWalkChunks = 4;  // 32-point chunks tested before `cnt < ns`
}  // namespace geoa3

// Point j of P [n, 3] as (x, y, z, |x|^2): from the staged cloud, or from
// device memory.
template <bool kShared>
__device__ __forceinline__ float4 geoa3_cloud_point(const float4* cloud,
                                                    const float* P, int j) {
  if constexpr (kShared) {
    return cloud[j];
  } else {
    const float x = __ldg(P + (size_t)j * 3), y = __ldg(P + (size_t)j * 3 + 1),
                z = __ldg(P + (size_t)j * 3 + 2);
    return make_float4(x, y, z, geoa3_sq3(x, y, z));
  }
}

// Slot s < ns of the centre (cx, cy, cz) gets the (s+1)-th point of P, in
// index order, with d^2 < r2; an under-full ball repeats its first hit, an
// empty ball holds index 0. d^2 = max((|c|^2 + |x|^2) - 2 c.x, 0), every
// product and sum rounded on its own in ops/distance.py's association, so
// a centre that is a member of P hits itself at exactly 0. The walk reads a
// 32-point chunk with one load a lane and tests kWalkChunks chunks before
// the loop-carried check `cnt < ns`; it places hits by ballot and popcount
// in index order and drops positions >= ns. sidx [ns] is shared or device
// memory. Every lane of the warp calls it (warp-uniform control); it ends
// on __syncwarp.
template <bool kShared>
__device__ __forceinline__ void geoa3_ball_walk(
    const float4* cloud, const float* P, int n, float cx, float cy, float cz,
    float r2, int ns, int* sidx, int lane) {
  const float c2 = geoa3_sq3(cx, cy, cz);
  const unsigned below = (1u << lane) - 1u;
  int cnt = 0, first = -1;
  for (int base = 0; base < n && cnt < ns; base += 32 * geoa3::kWalkChunks) {
    unsigned mask[geoa3::kWalkChunks];
#pragma unroll
    for (int u = 0; u < geoa3::kWalkChunks; ++u) {
      const int j = base + u * 32 + lane;
      bool hit = false;
      if (j < n) {
        const float4 q = geoa3_cloud_point<kShared>(cloud, P, j);
        hit = geoa3_sqdist(c2, q.w, geoa3_dot3(cx, cy, cz, q.x, q.y, q.z)) < r2;
      }
      mask[u] = __ballot_sync(GEOA3_FULL_MASK, hit);
    }
    unsigned any = 0;
#pragma unroll
    for (int u = 0; u < geoa3::kWalkChunks; ++u) any |= mask[u];
    if (!any) continue;  // warp-uniform: most rounds of an under-full ball
#pragma unroll
    for (int u = 0; u < geoa3::kWalkChunks; ++u) {
      if ((mask[u] >> lane) & 1u) {
        const int pos = cnt + __popc(mask[u] & below);
        if (pos < ns) sidx[pos] = base + u * 32 + lane;
      }
      if (first < 0 && mask[u]) first = base + u * 32 + __ffs(mask[u]) - 1;
      cnt += __popc(mask[u]);
    }
  }
  if (cnt > ns) cnt = ns;
  if (first < 0) first = 0;  // empty ball: every slot holds index 0
  __syncwarp();
  for (int s = cnt + lane; s < ns; s += 32) sidx[s] = first;
  __syncwarp();
}
