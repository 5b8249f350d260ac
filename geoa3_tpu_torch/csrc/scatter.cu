// Scatter-adds: out[b, idx[b,s], c] += ct[b, s, c], for 3 channels
// (geoa3_scatter_add_3t, geoa3_scatter_add_3) and for C channels
// (geoa3_scatter_add_nc).
//
// Replaces geoa3_tpu/ops/pallas/scatter_kernel.py:_scatter3t_kernel, the
// backward of ops.o2a_coord_planes. The TPU builds a one-hot block and runs
// split-bf16 matrix products because it has no scattered stores; the H100
// has atomics in L2, so one thread per source row adds its three values with
// atomicAdd into the output the wrapper zeroed. Bound on the H100: bytes
// (under 1 MB at the main path's shapes); the launch itself dominates. The
// order of the additions varies from run to run, so sums of colliding rows
// differ in the last bits between runs. Indices outside [0, n) are dropped.
//
// geoa3_scatter_add_3 replaces scatter_kernel.py:_scatter3_kernel
// (scatter_add_pallas: idx [b, n, k], ct [b, n, k, 3] -> [b, m, 3], the
// backward of a k-neighbour gather). Its [b, n, k] rows are row 2's [b, S]
// rows with S = n * k, so it launches the same device kernel; the TPU's
// [TM, 3] output blocks are a layout of that machine. Bound: bytes.
//
// geoa3_scatter_add_nc replaces scatter_kernel.py:_scatter_nc_kernel, the
// backward of ops.group_points at C channels (the TPU tiles a one-hot product
// over source chunks). Its device kernel lives in scatter.cuh, one thread per
// (source row, channel). Bound on the H100: bytes (the cotangents read once,
// the output zeroed and written once); the atomics resolve in L2.
#include "common.cuh"
#include "scatter.cuh"

namespace {

__global__ void scatter3_kernel(const int* __restrict__ idx,
                                const float* __restrict__ ct, int b, int S,
                                int n, float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)b * S) return;
  const int bb = (int)(t / S);
  const int i = idx[t];
  if (i < 0 || i >= n) return;
  float* o = out + ((size_t)bb * n + i) * 3;
  atomicAdd(o, ct[t * 3]);
  atomicAdd(o + 1, ct[t * 3 + 1]);
  atomicAdd(o + 2, ct[t * 3 + 2]);
}

}  // namespace

extern "C" int geoa3_scatter_add_3t(const int* idx, const float* ct, int b,
                                    int S, int n, float* out, void* stream) {
  const long long total = (long long)b * S;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (blocks > 0)
    scatter3_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        idx, ct, b, S, n, out);
  return (int)cudaGetLastError();
}

// idx [b, n, k], ct [b, n, k, 3] -> out [b, m, 3] (zeroed by the caller).
extern "C" int geoa3_scatter_add_3(const int* idx, const float* ct, int b,
                                   int n, int k, int m, float* out,
                                   void* stream) {
  return geoa3_scatter_add_3t(idx, ct, b, n * k, m, out, stream);
}

extern "C" int geoa3_scatter_add_nc(const int* idx, const float* ct, int b,
                                    int S, int n, int C, float* out,
                                    void* stream) {
  return (int)geoa3_launch_scatter_nc(idx, ct, b, S, n, C, out,
                                      static_cast<cudaStream_t>(stream));
}
