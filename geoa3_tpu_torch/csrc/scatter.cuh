// C-channel scatter-add, shared by scatter.cu (ops.group_points' backward) and
// ballquery_group.cu (the fused query+group's backward): one device kernel.
#pragma once

#include "common.cuh"

// out[b, idx[b, s], c] += ct[b, s, c] for idx [b, S], ct [b, S, C], out
// [b, n, C] (zeroed by the caller). One thread per (source row, channel):
// neighbouring threads read neighbouring cotangents and add to neighbouring
// addresses of one output row. Indices outside [0, n) are dropped.
static __global__ void geoa3_scatter_nc_kernel(const int* __restrict__ idx,
                                               const float* __restrict__ ct,
                                               long long total, int S, int n,
                                               int C,
                                               float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long row = t / C;  // b * S + s
  const int c = (int)(t - row * C);
  const int i = idx[row];
  if (i < 0 || i >= n) return;
  const long long bb = row / S;
  atomicAdd(out + ((size_t)bb * n + i) * C + c, ct[t]);
}

static inline cudaError_t geoa3_launch_scatter_nc(const int* idx,
                                                  const float* ct, int b, int S,
                                                  int n, int C, float* out,
                                                  cudaStream_t stream) {
  const long long total = (long long)b * S * C;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  geoa3_scatter_nc_kernel<<<blocks, threads, 0, stream>>>(idx, ct, total, S, n,
                                                          C, out);
  return cudaGetLastError();
}
