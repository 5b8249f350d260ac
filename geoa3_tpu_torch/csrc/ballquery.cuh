// One warp's ball query, shared by ballquery_group.cu (ops.ball_query and the
// fused query + grouping) and sa_fused.cu (the whole set-abstraction scale),
// so both select bitwise the same points.
#pragma once

#include "common.cuh"

// Slot s < ns of the centre (cx, cy, cz) gets the (s+1)-th point of
// P [n, 3], in index order, with d^2 < r2 (reference ball_query_gpu.cu:9-54);
// an under-full ball repeats its first hit, an empty ball holds index 0.
// d^2 = max((|c|^2 + |x|^2) - 2 c.x, 0), every product and sum rounded on
// its own in ops/distance.py's association, so a centre that is a member of
// P hits itself at exactly 0. The warp walks the points 32 at a time,
// ballots the hits, places each by the popcount of the hits before it, and
// stops once ns are placed. sidx [ns] is shared or device memory. Every
// lane of the warp calls it (warp-uniform control); it ends on __syncwarp.
__device__ __forceinline__ void geoa3_ball_query_warp(
    const float* __restrict__ P, int n, float cx, float cy, float cz,
    float r2, int ns, int* sidx) {
  const int lane = threadIdx.x & 31;
  const float c2 = geoa3_sq3(cx, cy, cz);
  int cnt = 0, first = -1;
  for (int base = 0; base < n && cnt < ns; base += 32) {
    const int j = base + lane;
    bool hit = false;
    if (j < n) {
      const float x = P[j * 3], y = P[j * 3 + 1], z = P[j * 3 + 2];
      const float d = geoa3_sqdist(c2, geoa3_sq3(x, y, z),
                                   geoa3_dot3(cx, cy, cz, x, y, z));
      hit = d < r2;
    }
    const unsigned mask = __ballot_sync(GEOA3_FULL_MASK, hit);
    if (hit) {
      const int pos = cnt + __popc(mask & ((1u << lane) - 1u));
      if (pos < ns) sidx[pos] = j;
    }
    if (first < 0 && mask) first = base + __ffs(mask) - 1;
    cnt += __popc(mask);
  }
  if (cnt > ns) cnt = ns;
  if (first < 0) first = 0;  // empty ball: every slot holds index 0
  __syncwarp();
  for (int s = cnt + lane; s < ns; s += 32) sidx[s] = first;
  __syncwarp();
}
