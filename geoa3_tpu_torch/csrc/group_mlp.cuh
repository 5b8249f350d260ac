// The grouped-MLP building blocks of sa_fused.cu's forward (the whole
// set-abstraction scale, whose layer 1 is gathered from projected rows) and
// of its projections; its backward and group_mlp.cu run tile_loop.cuh.
//
// A block takes a tile of R = 64, 32 or 16 rows in float32: activations sit
// transposed in shared memory ([channel][row], so a thread reads its 4 rows
// as one float4), weights stream from L2 as float4 rows, and every thread
// holds a 4x4 output tile, summed with fmaf from 0, k ascending. Every
// kernel that recomputes an activation uses the same chain, so a backward's
// recompute is bitwise its forward's (`a3 == pooled` is exact, whatever the
// tile height).
#pragma once

#include "common.cuh"

namespace geoa3 {

template <int R>
struct Tile {
  static constexpr int kThreads = R * 4;  // 16 column quads x R/4 row quads
  static constexpr int LD = R + 4;        // floats per channel row
  static constexpr int LDC = 65;          // floats per row of a layer-3 chunk
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

// outT[c][row] = relu(sum_k inT[k][row] W[k][c] + bias[c]) for c < cout.
template <int R>
__device__ void dense_relu(const float* inT, int K, const float* W, int cout,
                           const float* __restrict__ bias, float* outT) {
  constexpr int LD = Tile<R>::LD;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[4][4];
  for (int j0 = tx * 4; j0 < cout; j0 += 64) {
    gemm_tile<R>(inT, K, W, cout, j0, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float bj = bias[j0 + j];
      float4 v;
      v.x = fmaxf(acc[0][j] + bj, 0.0f);
      v.y = fmaxf(acc[1][j] + bj, 0.0f);
      v.z = fmaxf(acc[2][j] + bj, 0.0f);
      v.w = fmaxf(acc[3][j] + bj, 0.0f);
      *reinterpret_cast<float4*>(outT + (size_t)(j0 + j) * LD + ty * 4) = v;
    }
  }
}

// Layer 3 over a tile (rows row0 .. row0 + nrows of the flattened
// [groups * ns] rows, layer 2's activations in a2T), made 64 columns at a
// time into `chunk` [R][LDC] and pooled at once: one thread per column walks
// the tile's rows in order, keeping each group's running (maximum, tie
// count) in pooled/cnt [groups, c3]. A group that began in an earlier tile
// of this block resumes from what that tile left. Every thread of the block
// calls it; it ends on a barrier.
template <int R>
__device__ void layer3_pool(const float* a2T, int c2, const float* w3,
                            const float* __restrict__ b3, int c3, float* chunk,
                            long long row0, int nrows, int ns, float* pooled,
                            int* cnt) {
  constexpr int LDC = Tile<R>::LDC;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int jc = 0; jc < c3; jc += 64) {
    const int j0 = jc + tx * 4;
    if (j0 < c3) {
      float acc[4][4];
      gemm_tile<R>(a2T, c2, w3, c3, j0, acc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float bj = b3[j0 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          chunk[(ty * 4 + i) * LDC + tx * 4 + j] = fmaxf(acc[i][j] + bj, 0.0f);
      }
    }
    __syncthreads();
    const int col = jc + (int)threadIdx.x;
    if (threadIdx.x < 64 && col < c3) {
      long long g_prev = -1;
      float mx = -1.0f;
      int ties = 0;
      for (int r = 0; r < nrows; ++r) {
        const long long row = row0 + r;
        const long long g = row / ns;
        if (g != g_prev) {
          if (g_prev >= 0) {
            pooled[g_prev * c3 + col] = mx;
            cnt[g_prev * c3 + col] = ties;
          }
          if (row - g * ns == 0) {
            mx = -1.0f;  // below every post-ReLU value
            ties = 0;
          } else {
            mx = pooled[g * c3 + col];
            ties = cnt[g * c3 + col];
          }
          g_prev = g;
        }
        const float v = chunk[r * LDC + threadIdx.x];
        if (v > mx) {
          mx = v;
          ties = 1;
        } else if (v == mx) {
          ++ties;
        }
      }
      if (g_prev >= 0) {
        pooled[g_prev * c3 + col] = mx;
        cnt[g_prev * c3 + col] = ties;
      }
    }
    __syncthreads();
  }
}

}  // namespace geoa3
