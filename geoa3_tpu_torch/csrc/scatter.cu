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
// over source chunks), and of every other row gather with C != 3. Bound on
// the H100: bytes (the cotangents read once, the output zeroed and written
// once); the adds resolve in L2. The entry zeroes the output on the stream
// (cudaMemsetAsync) and launches `scatter_nc_rows`: a warp owns a
// group of g consecutive sources of one cloud (g the gather's last
// dimension: a ball's ns, a kNN's k, three_interpolate's 3) and runs row
// 15's `scatter_rows` (scatter_rows.cuh) on it: the lanes span the
// channels, float4 atomics where C % 4 == 0 and the pointers are 16-byte
// aligned, scalars otherwise; the group's first index and its repeats (an
// under-full ball's padding) are summed in registers and added once. S need
// not be a multiple of g: a cloud's last group is short. A row narrower
// than a warp leaves lanes idle: two groups a warp at C = 64 ran within 1%
// of this on the H100 (`chip_smoke.py --times 13`), so a warp owns one.
#include "common.cuh"
#include "scatter_rows.cuh"

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
  extern __shared__ float smem[];  // [n, 3] sums
  const int bb = blockIdx.x;
  for (int j = threadIdx.x; j < 3 * n; j += blockDim.x) smem[j] = 0.0f;
  __syncthreads();
  const int* I = idx + (size_t)bb * S;
  const float* C = ct + bb * st.b;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int i = I[s];
    if (i < 0 || i >= n) continue;
    const float* c = C + s * st.s;
    atomicAdd(&smem[3 * i], c[0]);
    atomicAdd(&smem[3 * i + 1], c[st.c]);
    atomicAdd(&smem[3 * i + 2], c[2 * st.c]);
  }
  __syncthreads();
  float* O = out + (size_t)bb * n * 3;
  for (int j = threadIdx.x; j < 3 * n; j += blockDim.x) O[j] = smem[j];
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

constexpr int kNcThreads = 256;

// float4 rows where C allows and ct and out are 16-byte aligned
bool nc_vec(int C, bool aligned) { return C % 4 == 0 && aligned; }

// out[b, idx[b, s], :] += ct[b, s, :] (rows of w elements of T): warp t
// owns sources [s0, s0 + g) of cloud t / groups, cut at S.
template <class T>
__global__ void __launch_bounds__(kNcThreads)
    scatter_nc_rows(const int* __restrict__ idx, const T* __restrict__ ct,
                    int S, int n, int w, int g, long long warps,
                    T* __restrict__ out) {
  const long long warp = ((long long)blockIdx.x * kNcThreads + threadIdx.x) / 32;
  if (warp >= warps) return;
  const int groups = (S + g - 1) / g;  // a cloud's groups
  const long long bb = warp / groups;
  const int s0 = (int)(warp - bb * groups) * g;
  const int len = S - s0 < g ? S - s0 : g;
  const int* I = idx + (size_t)bb * S + s0;
  scatter_rows(I, ct + ((size_t)bb * S + s0) * w, len, w, n, __ldg(I),
               out + (size_t)bb * n * w, threadIdx.x & 31);
}

template <class T>
cudaError_t launch_nc(const int* idx, const T* ct, int b, int S, int n, int w,
                      int g, T* out, cudaStream_t stream) {
  const long long warps = (long long)b * ((S + g - 1) / g);
  const long long blocks = (warps * 32 + kNcThreads - 1) / kNcThreads;
  scatter_nc_rows<<<(unsigned)blocks, kNcThreads, 0, stream>>>(
      idx, ct, S, n, w, g, warps, out);
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

// idx [b, S], ct [b, S, C] contiguous -> out [b, n, C], zeroed here; g
// (>= 1) the sources a warp owns.
extern "C" int geoa3_scatter_add_nc(const int* idx, const float* ct, int b,
                                    int S, int n, int C, int g, float* out,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      cudaMemsetAsync(out, 0, (size_t)b * n * C * sizeof(float), s);
  if (e != cudaSuccess || b == 0 || S == 0 || n == 0 || C == 0) return (int)e;
  if (nc_vec(C, (((uintptr_t)ct | (uintptr_t)out) & 15) == 0))
    return (int)launch_nc(idx, reinterpret_cast<const float4*>(ct), b, S, n,
                          C / 4, g, reinterpret_cast<float4*>(out), s);
  return (int)launch_nc(idx, ct, b, S, n, C, g, out, s);
}
