// A CPU stand-in for the CUDA runtime, enough to compile a kernel source of
// geoa3_tpu_torch/csrc with g++ and run it: one std::thread a CUDA thread,
// std::barrier for __syncthreads and for the warp shuffles, plain loads for
// __ldg. It defines GEOA3_EMU, under which a source leaves out its inline
// PTX: cp.async is the synchronous 16- or 4-byte copy below. A kernel's
// `extern __shared__ float smem[]` names the `smem` array below, which each
// block finds filled with NaN. The test that uses it rewrites each
// `kernel<<<grid, block, bytes, stream>>>(args)` of the source into an
// emu_launch of the blocks one after another, since g++ cannot parse the
// launch syntax. Timing and the memory model are not emulated; the index
// arithmetic, the barriers' placement, the shuffles, ballots and redux
// reductions, the atomics (under one lock) and the floating-point
// operations are (fmaf is the C library's, exact).
#pragma once

#define GEOA3_EMU 1

#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <tuple>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__
#define __align__(x)

struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
struct uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
struct int4 {
  int x, y, z, w;
};
struct dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim, gridDim;
inline std::barrier<>* g_block_barrier = nullptr;
inline std::barrier<>* g_warp_barrier[32];
inline uint64_t g_lanes[1024];
inline int g_sms = 1;  // what cudaDevAttrMultiProcessorCount reads

template <class T>
T __ldg(const T* p) {
  return *p;
}
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline unsigned __float_as_uint(float f) {
  unsigned u;
  memcpy(&u, &f, 4);
  return u;
}
inline int __float_as_int(float f) {
  int i;
  memcpy(&i, &f, 4);
  return i;
}
inline void __syncthreads() { g_block_barrier->arrive_and_wait(); }
inline unsigned atomicOr(unsigned* p, unsigned v) {
  return __atomic_fetch_or(p, v, __ATOMIC_RELAXED);
}
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline void __syncwarp() { g_warp_barrier[threadIdx.x / 32]->arrive_and_wait(); }

// atomics on device memory, under one lock
inline std::mutex g_atomic_mu;
inline float atomicAdd(float* p, float v) {
  std::lock_guard<std::mutex> hold(g_atomic_mu);
  const float old = *p;
  *p = old + v;
  return old;
}
inline float4 atomicAdd(float4* p, float4 v) {
  std::lock_guard<std::mutex> hold(g_atomic_mu);
  const float4 old = *p;
  *p = {old.x + v.x, old.y + v.y, old.z + v.z, old.w + v.w};
  return old;
}

// every lane of the warp must call it, as the kernels do
template <class T>
T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  const int t = threadIdx.x;
  uint64_t u = 0;
  memcpy(&u, &v, sizeof(T));
  g_lanes[t] = u;
  g_warp_barrier[t / 32]->arrive_and_wait();
  const uint64_t r = g_lanes[t ^ lane_mask];
  g_warp_barrier[t / 32]->arrive_and_wait();
  T out;
  memcpy(&out, &r, sizeof(T));
  return out;
}

// every lane of the warp must call it
inline unsigned __ballot_sync(unsigned, bool pred) {
  const int t = threadIdx.x;
  g_lanes[t] = pred ? 1u : 0u;
  g_warp_barrier[t / 32]->arrive_and_wait();
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= (unsigned)g_lanes[(t & ~31) + l] << l;
  g_warp_barrier[t / 32]->arrive_and_wait();
  return m;
}

// redux.sync: every lane of the warp must call it, as the kernels do
template <class T, class Op>
T emu_warp_reduce(T v, Op op) {
  const int t = threadIdx.x;
  uint64_t u = 0;
  memcpy(&u, &v, sizeof(T));
  g_lanes[t] = u;
  g_warp_barrier[t / 32]->arrive_and_wait();
  T r = v;
  for (int l = 0; l < 32; ++l) {
    T o;
    memcpy(&o, &g_lanes[(t & ~31) + l], sizeof(T));
    r = op(r, o);
  }
  g_warp_barrier[t / 32]->arrive_and_wait();
  return r;
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  return emu_warp_reduce(v, [](unsigned a, unsigned b) { return a > b ? a : b; });
}
inline int __reduce_max_sync(unsigned, int v) {
  return emu_warp_reduce(v, [](int a, int b) { return a > b ? a : b; });
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  return emu_warp_reduce(v, [](unsigned a, unsigned b) { return a < b ? a : b; });
}
inline int __reduce_min_sync(unsigned, int v) {
  return emu_warp_reduce(v, [](int a, int b) { return a < b ? a : b; });
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
constexpr int kEmuSmemMax = 232448;  // a block's shared memory on Hopper

// the dynamic shared memory a kernel declares as `extern __shared__ float
// smem[]` (a block-scope extern in the source's unnamed namespace names this
// array, declared in the same unnamed namespace of the translation unit)
namespace {
alignas(16) float smem[kEmuSmemMax / sizeof(float)];
}

inline void cp_async16(void* dst, const void* src) { memcpy(dst, src, 16); }
inline void cp_async4(void* dst, const void* src) { memcpy(dst, src, 4); }
inline void cp_async_commit() {}
template <int N>
void cp_async_wait() {}

template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int bytes) {
  return bytes > kEmuSmemMax ? cudaErrorInvalidValue : cudaSuccess;
}
// blocks an SM holds: two where each takes at most half an SM's shared
// memory (the emulation runs blocks one after another whatever it says)
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t smem) {
  *n = smem <= 113 * 1024 ? 2 : 1;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  memset(p, v, n);
  return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = g_sms;
  return cudaSuccess;
}

// Runs `kernel` as grid x threads CUDA threads, one block after another.
template <class Config>
void emu_launch(Config cfg, const std::function<void()>& kernel) {
  const unsigned grid = (unsigned)std::get<0>(cfg);
  const unsigned threads = (unsigned)std::get<1>(cfg);
  gridDim.x = grid;
  blockDim.x = threads;
  for (unsigned b = 0; b < grid; ++b) {
    blockIdx.x = b;
    std::fill(std::begin(smem), std::end(smem), NAN);  // unwritten reads show
    std::barrier<> block(threads);
    g_block_barrier = &block;
    std::vector<std::barrier<>*> warps;
    for (unsigned w = 0; w < (threads + 31) / 32; ++w)
      warps.push_back(g_warp_barrier[w] = new std::barrier<>(32));
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < threads; ++t)
      ts.emplace_back([t, &kernel] {
        threadIdx.x = t;
        kernel();
      });
    for (auto& th : ts) th.join();
    for (auto* w : warps) delete w;
  }
}
