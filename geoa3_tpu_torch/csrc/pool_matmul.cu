// Folded-BN affine (1x1, or kernel-3 conv over points) fused with the global
// max over points, and its input gradient.
//
// Replaces geoa3_tpu/ops/pallas/pool_matmul_kernel.py:_fwd_kernel and
// _bwd_kernel for the global pool (seg = whole cloud):
//   z[b,p,c]      = sum_t sum_k x[b, p+t-1, k] w3[t,k,c] + bias[c]   (taps 3;
//                   zero rows outside [0,n); taps 1 uses x[b,p,k] alone)
//   pooled[b,c]   = max_p z[b,p,c]
//   dx            = sum over the rows tied at the max of g[b,c]/cnt[b,c] *
//                   w3[t,:,c], shifted by tap
//
// Bound on the H100: operations. At the main path's [32,1024,128] -> 1024
// with 3 taps the product is 25.8 GFLOP of float32 against 17 MB of input;
// the [b,n,1024] activation is never written. The forward is a tiled
// shared-memory f32 product (64 points x 64 channels per block, 4x4 outputs a
// thread, fmaf in a fixed (tap, k) order) whose epilogue takes the column
// maximum. One block walks every point tile of its 64 channels, so the max
// needs no second pass and no atomics, and while it scans it records each
// column's tie count and its first kMaxTies tied rows. The backward then
// needs no second product: a warp per column adds g/cnt * w3[t,:,c] into dx
// at the recorded rows (atomicAdd; sums vary in the last bits from run to
// run). A column with more than kMaxTies ties recomputes its z row by row
// with the forward's exact arithmetic, so it finds the same ties.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int BM = 64;  // points per tile
constexpr int BN = 64;  // output channels per block
constexpr int BK = 16;  // input channels per step
constexpr int kThreads = 256;
constexpr int kMaxTies = 4;
constexpr int kBwdWarps = 8;

__device__ __forceinline__ int tap_shift(int taps, int t) {
  return taps == 3 ? t - 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
pool_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w3,
                const float* __restrict__ bias, int n, int cin, int cout,
                int taps, float* __restrict__ pooled, int* __restrict__ cnt,
                int* __restrict__ rows) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ __align__(16) float Zs[BM][BN];
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const float* X = x + (size_t)b * n * cin;

  float bcol[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) bcol[j] = bias[c0 + tx * 4 + j];

  // column state, owned by threads tid < BN (column c0 + tid)
  float mx = -INFINITY;
  int count = 0;
  int tie[kMaxTies] = {0, 0, 0, 0};

  for (int p0 = 0; p0 < n; p0 += BM) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int t = 0; t < taps; ++t) {
      const int shift = tap_shift(taps, t);
      for (int k0 = 0; k0 < cin; k0 += BK) {
#pragma unroll
        for (int q = 0; q < (BM * BK) / kThreads; ++q) {
          const int idx = tid + q * kThreads;
          const int r = idx / BK, kk = idx % BK;
          const int p = p0 + r + shift;
          As[kk][r] = (p >= 0 && p < n) ? X[(size_t)p * cin + k0 + kk] : 0.0f;
        }
#pragma unroll
        for (int q = 0; q < (BK * BN) / kThreads; ++q) {
          const int idx = tid + q * kThreads;
          const int kk = idx / BN, cc = idx % BN;
          Bs[kk][cc] = w3[((size_t)t * cin + k0 + kk) * cout + c0 + cc];
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
          const float4 w = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 z;
      z.x = __fadd_rn(acc[i][0], bcol[0]);
      z.y = __fadd_rn(acc[i][1], bcol[1]);
      z.z = __fadd_rn(acc[i][2], bcol[2]);
      z.w = __fadd_rn(acc[i][3], bcol[3]);
      *reinterpret_cast<float4*>(&Zs[ty * 4 + i][tx * 4]) = z;
    }
    __syncthreads();
    if (tid < BN) {
      const int rmax = min(BM, n - p0);
      for (int r = 0; r < rmax; ++r) {
        const float z = Zs[r][tid];
        if (count == 0 || z > mx) {
          mx = z;
          count = 1;
          tie[0] = p0 + r;
        } else if (z == mx) {
#pragma unroll
          for (int q = 1; q < kMaxTies; ++q)
            if (count == q) tie[q] = p0 + r;
          ++count;
        }
      }
    }
    __syncthreads();
  }
  if (tid < BN) {
    const size_t o = (size_t)b * cout + c0 + tid;
    pooled[o] = mx;
    cnt[o] = count;
#pragma unroll
    for (int q = 0; q < kMaxTies; ++q) rows[o * kMaxTies + q] = tie[q];
  }
}

__global__ void pool_bwd_kernel(const float* __restrict__ w3t,
                                const float* __restrict__ g,
                                const int* __restrict__ cnt,
                                const int* __restrict__ rows,
                                const float* __restrict__ x,
                                const float* __restrict__ bias,
                                const float* __restrict__ pooled,
                                const float* __restrict__ w3, int n, int cin,
                                int cout, int taps, float* __restrict__ dx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int c = blockIdx.x * kBwdWarps + warp;
  if (c >= cout) return;
  const size_t o = (size_t)b * cout + c;
  const float gv = g[o];
  if (gv == 0.0f) return;
  const int ct = cnt[o];
  const float coef = gv / (float)ct;
  float* DX = dx + (size_t)b * n * cin;

  if (ct <= kMaxTies) {
    for (int q = 0; q < ct; ++q) {
      const int p = rows[o * kMaxTies + q];
      for (int t = 0; t < taps; ++t) {
        const int row = p + tap_shift(taps, t);
        if (row < 0 || row >= n) continue;
        const float* wr = w3t + ((size_t)t * cout + c) * cin;
        for (int k = lane; k < cin; k += 32)
          atomicAdd(DX + (size_t)row * cin + k, coef * wr[k]);
      }
    }
    return;
  }
  // more ties than were recorded: find them again, one row per lane
  const float* X = x + (size_t)b * n * cin;
  const float zmax = pooled[o];
  const float bc = bias[c];
  for (int p = lane; p < n; p += 32) {
    float acc = 0.0f;
    for (int t = 0; t < taps; ++t) {
      const int pr = p + tap_shift(taps, t);
      for (int k = 0; k < cin; ++k) {
        const float xv = (pr >= 0 && pr < n) ? X[(size_t)pr * cin + k] : 0.0f;
        acc = fmaf(xv, w3[((size_t)t * cin + k) * cout + c], acc);
      }
    }
    if (__fadd_rn(acc, bc) != zmax) continue;
    for (int t = 0; t < taps; ++t) {
      const int row = p + tap_shift(taps, t);
      if (row < 0 || row >= n) continue;
      const float* wr = w3t + ((size_t)t * cout + c) * cin;
      for (int k = 0; k < cin; ++k)
        atomicAdd(DX + (size_t)row * cin + k, coef * wr[k]);
    }
  }
}

}  // namespace

extern "C" int geoa3_pool_fwd(const float* x, const float* w3,
                              const float* bias, int B, int n, int cin,
                              int cout, int taps, float* pooled, int* cnt,
                              int* rows, void* stream) {
  dim3 grid(cout / BN, B);
  pool_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w3, bias, n, cin, cout, taps, pooled, cnt, rows);
  return (int)cudaGetLastError();
}

extern "C" int geoa3_pool_bwd(const float* w3t, const float* g, const int* cnt,
                              const int* rows, const float* x,
                              const float* bias, const float* pooled,
                              const float* w3, int B, int n, int cin, int cout,
                              int taps, float* dx, void* stream) {
  dim3 grid((cout + kBwdWarps - 1) / kBwdWarps, B);
  pool_bwd_kernel<<<grid, kBwdWarps * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      w3t, g, cnt, rows, x, bias, pooled, w3, n, cin, cout, taps, dx);
  return (int)cudaGetLastError();
}
