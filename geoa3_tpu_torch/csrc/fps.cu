// Greedy farthest-point sampling: xyz [b, n, 3] -> idx [b, m] int32.
//
// Replaces geoa3_tpu/ops/pallas/fps_kernel.py:_fps_kernel (fps_pallas). The
// first pick is start[b] (or index 0); every later pick is the point whose
// running minimum squared distance to the picks so far is largest, lowest
// index on ties. The running minimum starts at 1e10. With `skip` set, points
// with |p|^2 <= 1e-3 never become candidates (they score -1; if every point
// is skipped the answer is index 0, as an argmax over all -1 gives).
//
// The TPU kernel walks the whole batch as [b, n] vector passes and reads the
// last pick's coordinates by a masked row sum; here one block owns one cloud,
// the cloud and its running minimum sit in shared memory, and each of the
// m-1 rounds is a distance update and a block-wide maximum over 64-bit keys
// (minimum-distance bits high, ~index low), so the lowest index wins a tie.
// Distances are >= 0, so their bit patterns order as the floats do. Every
// product and sum is rounded on its own, in the plain version's order: a
// fused multiply-add would move a running minimum by an ulp, and one changed
// pick changes every later one.
//
// Bound on the H100: by the roofline rule bytes (the cloud read once, the
// indices written once), but that bound is empty here: the work is m-1
// dependent rounds, each a block-wide reduction, on b of the 132 SMs.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ unsigned long long warp_max_u64(
    unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    unsigned long long o = __shfl_xor_sync(GEOA3_FULL_MASK, v, off);
    v = o > v ? o : v;
  }
  return v;
}

__global__ void fps_kernel(const float* __restrict__ xyz,
                           const int* __restrict__ start, int n, int m,
                           int skip, int* __restrict__ idx) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  float* smin = sz + n;  // running minimum, or -1 for a skipped point
  __shared__ unsigned long long swarp[kWarps];
  __shared__ int slast;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* P = xyz + (size_t)b * n * 3;
  for (int j = tid; j < n; j += kThreads) {
    const float x = P[j * 3], y = P[j * 3 + 1], z = P[j * 3 + 2];
    sx[j] = x;
    sy[j] = y;
    sz[j] = z;
    const bool ok = !skip || geoa3_sq3(x, y, z) > 1e-3f;
    smin[j] = ok ? 1e10f : -1.0f;
  }
  if (tid == 0) {
    int s = start ? start[b] : 0;
    s = s < 0 ? 0 : (s >= n ? n - 1 : s);
    slast = s;
    idx[(size_t)b * m] = s;
  }
  __syncthreads();

  for (int r = 1; r < m; ++r) {
    const int last = slast;
    const float lx = sx[last], ly = sy[last], lz = sz[last];
    unsigned long long best = 0ull;
    for (int j = tid; j < n; j += kThreads) {
      const float dx = __fsub_rn(sx[j], lx), dy = __fsub_rn(sy[j], ly),
                  dz = __fsub_rn(sz[j], lz);
      const float d = geoa3_sq3(dx, dy, dz);
      float cur = smin[j];
      unsigned long long key;
      if (cur < 0.0f) {  // skipped: below every candidate, lowest index first
        key = (unsigned long long)(~(unsigned int)j);
      } else {
        cur = d < cur ? d : cur;
        smin[j] = cur;
        key = ((unsigned long long)(__float_as_uint(cur) + 1u) << 32) |
              (unsigned long long)(~(unsigned int)j);
      }
      best = key > best ? key : best;
    }
    best = warp_max_u64(best);
    if (lane == 0) swarp[warp] = best;
    __syncthreads();  // also: every thread has read slast
    if (warp == 0) {
      unsigned long long v = lane < kWarps ? swarp[lane] : 0ull;
      v = warp_max_u64(v);
      if (lane == 0) {
        const int pick = (int)(~(unsigned int)(v & 0xffffffffull));
        slast = pick;
        idx[(size_t)b * m + r] = pick;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// start may be null (every cloud starts at index 0).
extern "C" int geoa3_fps(const float* xyz, const int* start, int b, int n,
                         int m, int skip, int* idx, void* stream) {
  if (b == 0 || m == 0) return 0;
  const size_t smem = (size_t)4 * n * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fps_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xyz, start, n, m, skip, idx);
  return (int)cudaGetLastError();
}
