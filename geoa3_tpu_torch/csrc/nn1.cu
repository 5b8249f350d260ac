// Dual 1-NN, with or without payload copies, both Chamfer directions.
//
// Replaces geoa3_tpu/ops/pallas/nn1_kernel.py:_nn1_payload_kernel and
// :_nn1_dual_kernel (exact selection): the same two passes, with the payload
// and coordinate copies compiled out for the bare variant, so both select
// the same indices. For adv [b,n,3] and ori [b,m,3], with
// d_ij = max((|a_i|^2 + |o_j|^2) - 2 a_i.o_j, 0):
//   a2o[b,i]   = argmin_j d_ij   gp[b,p,i] = pay[b,p,a2o[b,i]]   (p < 8)
//   o2a[b,j]   = argmin_i d_ij   op[b,c,j] = adv[b,o2a[b,j],c]   (c < 3; rows 3..7 zero)
// ties to the lowest index in both directions. Every product and sum of d is
// rounded on its own, so d is bitwise the plain version's and so are the
// selected indices.
//
// Bound on the H100: operations (b*n*m distance evaluations, ~10 flops each,
// against a few MB of inputs and outputs). The TPU kernel folds the o2a
// column minima across row blocks in grid order; blocks here run in no order,
// so the two directions are two passes over the same distances: a2o with one
// warp per adv row (four rows per warp, ori staged in shared memory), o2a
// with one thread per ori column scanning all adv rows (adv staged in shared
// memory). Both keep a 64-bit (distance bits, index) key, whose minimum is
// the lowest-index argmin. The payload copies are plain loads at the winner.
#include "common.cuh"

namespace {

constexpr int kTile = 1024;     // points staged in shared memory per pass
constexpr int kWarps = 16;      // warps per a2o block
constexpr int kRowsPerWarp = 4; // adv rows per warp
constexpr int kO2aThreads = 256;

template <bool kPayload>
__global__ void nn1_a2o_kernel(const float* __restrict__ adv,
                               const float* __restrict__ ori,
                               const float* __restrict__ pay, int n, int m,
                               int* __restrict__ a2o, float* __restrict__ gp) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile], s2[kTile];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * kWarps + warp) * kRowsPerWarp;
  const float* A = adv + (size_t)b * n * 3;
  const float* O = ori + (size_t)b * m * 3;

  float ax[kRowsPerWarp], ay[kRowsPerWarp], az[kRowsPerWarp], a2[kRowsPerWarp];
  unsigned long long best[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = min(row0 + r, n - 1);
    ax[r] = A[i * 3];
    ay[r] = A[i * 3 + 1];
    az[r] = A[i * 3 + 2];
    a2[r] = geoa3_sq3(ax[r], ay[r], az[r]);
    best[r] = ~0ull;
  }
  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int cnt = min(kTile, m - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
      const float x = O[(t0 + j) * 3], y = O[(t0 + j) * 3 + 1],
                  z = O[(t0 + j) * 3 + 2];
      sx[j] = x;
      sy[j] = y;
      sz[j] = z;
      s2[j] = geoa3_sq3(x, y, z);
    }
    __syncthreads();
    for (int j = lane; j < cnt; j += 32) {
      const float x = sx[j], y = sy[j], z = sz[j], b2 = s2[j];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float d = geoa3_sqdist(a2[r], b2,
                                     geoa3_dot3(ax[r], ay[r], az[r], x, y, z));
        const unsigned long long key = geoa3_key(d, t0 + j);
        best[r] = key < best[r] ? key : best[r];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const unsigned long long w = geoa3_warp_min_u64(best[r]);
    const int i = row0 + r;
    if (i < n) {
      const int jb = (int)((w - 1ull) & 0xffffffffull);
      if (lane == 0) a2o[(size_t)b * n + i] = jb;
      if (kPayload && lane < 8)
        gp[((size_t)b * 8 + lane) * n + i] = pay[((size_t)b * 8 + lane) * m + jb];
    }
  }
}

template <bool kPayload>
__global__ void nn1_o2a_kernel(const float* __restrict__ adv,
                               const float* __restrict__ ori, int n, int m,
                               int* __restrict__ o2a, float* __restrict__ op) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile], s2[kTile];
  const int b = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const float* A = adv + (size_t)b * n * 3;
  const float* O = ori + (size_t)b * m * 3;
  const int jc = min(j, m - 1);
  const float bx = O[jc * 3], by = O[jc * 3 + 1], bz = O[jc * 3 + 2];
  const float b2 = geoa3_sq3(bx, by, bz);
  unsigned long long best = ~0ull;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int cnt = min(kTile, n - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      const float x = A[(t0 + i) * 3], y = A[(t0 + i) * 3 + 1],
                  z = A[(t0 + i) * 3 + 2];
      sx[i] = x;
      sy[i] = y;
      sz[i] = z;
      s2[i] = geoa3_sq3(x, y, z);
    }
    __syncthreads();
    for (int i = 0; i < cnt; ++i) {
      const float d =
          geoa3_sqdist(s2[i], b2, geoa3_dot3(sx[i], sy[i], sz[i], bx, by, bz));
      const unsigned long long key = geoa3_key(d, t0 + i);
      best = key < best ? key : best;
    }
  }
  if (j >= m) return;
  const int ib = (int)((best - 1ull) & 0xffffffffull);
  o2a[(size_t)b * m + j] = ib;
  if (!kPayload) return;
  float* P = op + (size_t)b * 8 * m;
#pragma unroll
  for (int c = 0; c < 3; ++c) P[(size_t)c * m + j] = A[ib * 3 + c];
#pragma unroll
  for (int c = 3; c < 8; ++c) P[(size_t)c * m + j] = 0.0f;
}

template <bool kPayload>
int launch_nn1(const float* adv, const float* ori, const float* pay, int b,
               int n, int m, int* a2o, int* o2a, float* gp, float* op,
               cudaStream_t s) {
  const int rows_per_block = kWarps * kRowsPerWarp;
  dim3 g1((n + rows_per_block - 1) / rows_per_block, b);
  nn1_a2o_kernel<kPayload><<<g1, kWarps * 32, 0, s>>>(adv, ori, pay, n, m, a2o,
                                                      gp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 g2((m + kO2aThreads - 1) / kO2aThreads, b);
  nn1_o2a_kernel<kPayload><<<g2, kO2aThreads, 0, s>>>(adv, ori, n, m, o2a, op);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int geoa3_nn1_payload(const float* adv, const float* ori,
                                 const float* pay, int b, int n, int m,
                                 int* a2o, int* o2a, float* gp, float* op,
                                 void* stream) {
  return launch_nn1<true>(adv, ori, pay, b, n, m, a2o, o2a, gp, op,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int geoa3_nn1_dual(const float* adv, const float* ori, int b, int n,
                              int m, int* a2o, int* o2a, void* stream) {
  return launch_nn1<false>(adv, ori, nullptr, b, n, m, a2o, o2a, nullptr,
                           nullptr, static_cast<cudaStream_t>(stream));
}
