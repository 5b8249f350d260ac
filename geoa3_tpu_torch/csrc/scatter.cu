// Scatter-adds: out[b, idx[b,s], c] += ct[b, s, c], for 3 channels
// (geoa3_scatter_add_3t, geoa3_scatter_add_3) and for C channels
// (geoa3_scatter_add_nc).
//
// Replaces geoa3_tpu/ops/pallas/scatter_kernel.py:_scatter3t_kernel, the
// backward of ops.o2a_coord_planes. The TPU builds a one-hot block and runs
// split-bf16 matrix products because it has no scattered stores. Bound on the
// H100: bytes (under 1 MB at the main path's shapes), so what a call costs is
// its launches and the host path around them. One launch writes the whole
// output, so the wrapper allocates it with torch.empty (no fill launch):
//
//  - shared route (3 n floats fit a block's shared memory, n <= 19370 on the
//    H100): one block a cloud zeroes the cloud's [n, 3] sums in shared
//    memory, walks its S sources with shared-memory atomicAdd, and after one
//    barrier stores the whole [n, 3] output with coalesced stores;
//  - global route (larger clouds): the output is zeroed on the stream
//    (cudaMemsetAsync) and one thread a source adds its three values with
//    atomicAdd in L2.
//
// The route is chosen by shape alone (kSharedRows). The cotangent is read
// through element strides (batch, source, channel), so the o2a backward
// passes the first three rows of its [b, 8, m] plane cotangent as they are,
// with no transposing copy. The order of the additions varies from run to
// run, so sums of colliding rows differ in the last bits between runs.
// Indices outside [0, n) are dropped.
//
// geoa3_scatter_add_3 replaces scatter_kernel.py:_scatter3_kernel
// (scatter_add_pallas: idx [b, n, k], ct [b, n, k, 3] -> [b, m, 3], the
// backward of a k-neighbour gather). Its [b, n, k] rows are row 2's [b, S]
// rows with S = n * k, so it launches the same device kernels; the TPU's
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

constexpr int kSharedMax = 232448;  // a block's opt-in shared memory, H100
constexpr int kSharedRows = kSharedMax / 12;  // clouds up to 19370 rows
constexpr int kSharedThreads = 1024;

struct CtStrides {
  long long b, s, c;  // elements between batches, sources, channels
};

__global__ void __launch_bounds__(kSharedThreads)
scatter3_kernel(const int* __restrict__ idx, const float* __restrict__ ct,
                CtStrides st, int S, int n, float* __restrict__ out) {
  extern __shared__ float sums[];  // [n, 3]
  const int bb = blockIdx.x;
  for (int j = threadIdx.x; j < 3 * n; j += blockDim.x) sums[j] = 0.0f;
  __syncthreads();
  const int* I = idx + (size_t)bb * S;
  const float* C = ct + bb * st.b;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int i = I[s];
    if (i < 0 || i >= n) continue;
    const float* c = C + s * st.s;
    atomicAdd(&sums[3 * i], c[0]);
    atomicAdd(&sums[3 * i + 1], c[st.c]);
    atomicAdd(&sums[3 * i + 2], c[2 * st.c]);
  }
  __syncthreads();
  float* O = out + (size_t)bb * n * 3;
  for (int j = threadIdx.x; j < 3 * n; j += blockDim.x) O[j] = sums[j];
}

__global__ void scatter3_global_kernel(const int* __restrict__ idx,
                                       const float* __restrict__ ct,
                                       CtStrides st, int b, int S, int n,
                                       float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)b * S) return;
  const int bb = (int)(t / S);
  const int s = (int)(t - (long long)bb * S);
  const int i = idx[t];
  if (i < 0 || i >= n) return;
  const float* c = ct + bb * st.b + s * st.s;
  float* o = out + ((size_t)bb * n + i) * 3;
  atomicAdd(o, c[0]);
  atomicAdd(o + 1, c[st.c]);
  atomicAdd(o + 2, c[2 * st.c]);
}

cudaError_t launch_scatter3(const int* idx, const float* ct, CtStrides st,
                            int b, int S, int n, float* out,
                            cudaStream_t stream) {
  if (b == 0 || n == 0) return cudaSuccess;
  if (n <= kSharedRows) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        scatter3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSharedMax);
    if (attr != cudaSuccess) return attr;
    scatter3_kernel<<<b, kSharedThreads, (size_t)n * 12, stream>>>(
        idx, ct, st, S, n, out);
    return cudaGetLastError();
  }
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)b * n * 12, stream);
  if (e != cudaSuccess) return e;
  const long long total = (long long)b * S;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  scatter3_global_kernel<<<blocks, threads, 0, stream>>>(idx, ct, st, b, S, n,
                                                         out);
  return cudaGetLastError();
}

}  // namespace

// idx [b, S], ct [b, S, 3] read at element strides (sb, ss, sc) -> out
// [b, n, 3], written whole (no zeroing by the caller).
extern "C" int geoa3_scatter_add_3t(const int* idx, const float* ct, int b,
                                    int S, int n, long long sb, long long ss,
                                    long long sc, float* out, void* stream) {
  return (int)launch_scatter3(idx, ct, CtStrides{sb, ss, sc}, b, S, n, out,
                              static_cast<cudaStream_t>(stream));
}

// idx [b, n, k], ct [b, n, k, 3] contiguous -> out [b, m, 3], written whole.
extern "C" int geoa3_scatter_add_3(const int* idx, const float* ct, int b,
                                   int n, int k, int m, float* out,
                                   void* stream) {
  const long long S = (long long)n * k;
  return (int)launch_scatter3(idx, ct, CtStrides{3 * S, 3, 1}, b, (int)S, m,
                              out, static_cast<cudaStream_t>(stream));
}

extern "C" int geoa3_scatter_add_nc(const int* idx, const float* ct, int b,
                                    int S, int n, int C, float* out,
                                    void* stream) {
  return (int)geoa3_launch_scatter_nc(idx, ct, b, S, n, C, out,
                                      static_cast<cudaStream_t>(stream));
}
