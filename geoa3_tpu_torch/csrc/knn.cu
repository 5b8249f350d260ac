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
// gather. Here the selection is select.cuh's streaming one (shared with the
// kappa selection): the block streams the points through shared memory in
// tiles of 1024, each warp keeps its four rows' k best keys sorted across its
// lanes (one key a lane for k <= 32, two for k <= 64), and lane p writes the
// row's p-th neighbour: distance, index and coordinates. m is bounded by
// nothing but the outputs.
//
// Bound on the H100: operations (b*n*m distance evaluations and key
// comparisons, against a few MB of inputs and outputs).
#include "select.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 4;  // rows a warp selects at once
constexpr int kRowsPerBlock = kWarps * kRows;

template <int kKPL>
__global__ void __launch_bounds__(kWarps * 32)
    knn_kernel(const float* __restrict__ query, const float* __restrict__ points,
               int n, int m, int k, float* __restrict__ dists,
               int* __restrict__ idx, float* __restrict__ nbrs) {
  __shared__ float4 tile[geoa3::kTile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const float* P = points + (size_t)b * m * 3;
  int row[kRows];
  float q[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = blockIdx.x * kRowsPerBlock + warp * kRows + r;
    row[r] = i < n ? i : -1;
    const float* Q = query + ((size_t)b * n + min(i, n - 1)) * 3;
    q[r][0] = Q[0];
    q[r][1] = Q[1];
    q[r][2] = Q[2];
    q[r][3] = geoa3_sq3(q[r][0], q[r][1], q[r][2]);
  }
  geoa3::WarpList<kKPL> list[kRows];
  geoa3::select_rows<kKPL, kRows, false>(P, m, tile, q, row, k, list);

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (row[r] < 0) continue;  // warp-uniform
    const size_t out = ((size_t)b * n + row[r]) * k;
#pragma unroll
    for (int s = 0; s < kKPL; ++s) {
      const int p = 32 * s + lane;
      if (p < k) {
        const unsigned long long key = list[r].v[s];
        const int j = list[r].index(s);
        dists[out + p] = __uint_as_float((unsigned int)(key >> 32));
        idx[out + p] = j;
        float* nb = nbrs + (out + p) * 3;
        const float* src = P + (size_t)j * 3;
        nb[0] = src[0];
        nb[1] = src[1];
        nb[2] = src[2];
      }
    }
  }
}

}  // namespace

extern "C" int geoa3_knn(const float* query, const float* points, int b, int n,
                         int m, int k, float* dists, int* idx, float* nbrs,
                         void* stream) {
  dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 32)
    knn_kernel<1><<<grid, kWarps * 32, 0, s>>>(query, points, n, m, k, dists,
                                               idx, nbrs);
  else
    knn_kernel<2><<<grid, kWarps * 32, 0, s>>>(query, points, n, m, k, dists,
                                               idx, nbrs);
  return (int)cudaGetLastError();
}
