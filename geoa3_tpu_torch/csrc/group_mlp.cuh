// The projections' tile: sa_fused.cu's project_kernel (P = xyz @ W1x +
// feats @ W1f and Yc = centres @ W1x, row 17's layer 1 taken once a point
// and once a centre) and backproject_kernel (dP and dYc mapped back by
// W1^T). Every other grouped-MLP kernel runs tile_loop.cuh.
//
// A block takes a tile of R = 64, 32 or 16 rows in float32: the input sits
// transposed in shared memory ([channel][row], so a thread reads its 4 rows
// as one float4), weights stream from L2 as float4 rows, and every thread
// holds a 4x4 output tile, summed with fmaf from 0, k ascending.
#pragma once

#include "common.cuh"

namespace geoa3 {

template <int R>
struct Tile {
  static constexpr int kThreads = R * 4;  // 16 column quads x R/4 row quads
  static constexpr int LD = R + 4;        // floats per channel row
};

// The tile height: the largest of 64 and 32 whose shared memory leaves room
// for two blocks on an SM, else the largest of 64, 32 and 16 that fits at
// all, else 0. (16 rows halve the reuse of every weight read, so they are
// taken only where 32 do not fit.)
inline int pick_rows(size_t smem64, size_t smem32, size_t smem16) {
  if (smem64 <= kSmemHalf) return 64;
  if (smem32 <= kSmemHalf) return 32;
  if (smem64 <= kSmemMax) return 64;
  if (smem32 <= kSmemMax) return 32;
  if (smem16 <= kSmemMax) return 16;
  return 0;
}

// acc[i][j] = sum_k inT[k][ty*4 + i] * W[k][j0 + j], k ascending.
template <int R>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ inT, int K,
                                          const float* __restrict__ W, int ldw,
                                          int j0, float (&acc)[4][4]) {
  constexpr int LD = Tile<R>::LD;
  const float* a = inT + (threadIdx.x >> 4) * 4;
  const float* w = W + j0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + (size_t)k * LD);
    const float4 wv =
        __ldg(reinterpret_cast<const float4*>(w + (size_t)k * ldw));
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], wr[j], acc[i][j]);
  }
}

// Stage rows [row0, row0 + nrows) of x [rows, 3] and f [rows, cf] as
// a0T[channel][row] (x in channels 0..2, f after); rows past nrows are 0.
template <int R>
__device__ void load_input(float* a0T, const float* __restrict__ x,
                           const float* __restrict__ f, long long row0,
                           int nrows, int cf) {
  constexpr int LD = Tile<R>::LD, T = Tile<R>::kThreads;
  const float* px = x + row0 * 3;
  for (int e = threadIdx.x; e < R * 3; e += T) {
    const int r = e / 3, k = e - r * 3;
    a0T[k * LD + r] = r < nrows ? px[e] : 0.0f;
  }
  if (cf > 0) {
    const float* pf = f + row0 * cf;
    for (int e = threadIdx.x; e < R * cf; e += T) {
      const int r = e / cf, k = e - r * cf;
      a0T[(3 + k) * LD + r] = r < nrows ? pf[e] : 0.0f;
    }
  }
}

}  // namespace geoa3
