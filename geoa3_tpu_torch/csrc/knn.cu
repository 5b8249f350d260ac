// Exact k nearest neighbours with indices and neighbour coordinates.
//
// Replaces geoa3_tpu/ops/pallas/knn_kernel.py:_knn_kernel (knn_pallas and
// knn_pallas_planes). For query [b,n,3] and points [b,m,3], with
// d_ij = max((|q_i|^2 + |p_j|^2) - 2 q_i.p_j, 0), each query row gets its k
// smallest distances in ascending order, ties to the lowest index, with the
// index and the three coordinates of each neighbour. A point's own column is
// not special: it competes like any other (the self-first rule belongs to
// the kappa kernels). Every product and sum of d is rounded on its own, so
// d, and with it the order, is bitwise the plain version's.
//
// The TPU kernel knocks the row minimum out of a VMEM-resident distance block
// k times and copies coordinates by one-hot masked sums, because it has no
// gather. Here one warp owns a query row (the design of kappa.cu's
// selection): the row's distances sit in shared memory, and round r takes the
// warp-wide minimum over 64-bit (distance bits, index) keys strictly above
// round r-1's key, then lane 0 writes that neighbour's distance, index and
// coordinates from the staged points.
//
// Bound on the H100: operations (b*n*m distance evaluations plus k passes of
// key comparisons over each row, against a few MB of inputs and outputs).
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;

__global__ void knn_kernel(const float* __restrict__ query,
                           const float* __restrict__ points, int n, int m,
                           int k, float* __restrict__ dists,
                           int* __restrict__ idx, float* __restrict__ nbrs) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + m;
  float* sz = sy + m;
  float* s2 = sz + m;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* drow = s2 + m + (size_t)warp * m;
  const int b = blockIdx.y;
  const float* P = points + (size_t)b * m * 3;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const float x = P[j * 3], y = P[j * 3 + 1], z = P[j * 3 + 2];
    sx[j] = x;
    sy[j] = y;
    sz[j] = z;
    s2[j] = geoa3_sq3(x, y, z);
  }
  __syncthreads();

  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int i = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp + rr;
    if (i >= n) break;  // warp-uniform
    const float* Q = query + ((size_t)b * n + i) * 3;
    const float qx = Q[0], qy = Q[1], qz = Q[2];
    const float q2 = geoa3_sq3(qx, qy, qz);
    for (int j = lane; j < m; j += 32)
      drow[j] = geoa3_sqdist(q2, s2[j], geoa3_dot3(qx, qy, qz, sx[j], sy[j], sz[j]));
    __syncwarp();

    const size_t out = ((size_t)b * n + i) * k;
    unsigned long long prev = 0ull;
    for (int r = 0; r < k; ++r) {
      unsigned long long best = ~0ull;
      for (int j = lane; j < m; j += 32) {
        const unsigned long long key = geoa3_key(drow[j], j);
        if (key > prev && key < best) best = key;
      }
      prev = geoa3_warp_min_u64(best);
      if (lane == 0) {
        const unsigned long long raw = prev - 1ull;
        const int j = (int)(raw & 0xffffffffull);
        dists[out + r] = __uint_as_float((unsigned int)(raw >> 32));
        idx[out + r] = j;
        float* nb = nbrs + (out + r) * 3;
        nb[0] = sx[j];
        nb[1] = sy[j];
        nb[2] = sz[j];
      }
    }
    __syncwarp();  // drow is rewritten for the next row
  }
}

}  // namespace

extern "C" int geoa3_knn(const float* query, const float* points, int b, int n,
                         int m, int k, float* dists, int* idx, float* nbrs,
                         void* stream) {
  const size_t smem = (size_t)(4 + kWarps) * m * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, b);
  knn_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      query, points, n, m, k, dists, idx, nbrs);
  return (int)cudaGetLastError();
}
