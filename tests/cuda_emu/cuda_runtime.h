// A CPU stand-in for the CUDA runtime, enough to compile a kernel source of
// geoa3_tpu_torch/csrc with g++ and run it: one std::thread a CUDA thread,
// std::barrier for __syncthreads and for the warp shuffles, plain loads for
// __ldg. It defines GEOA3_EMU, under which a source leaves out its inline
// PTX: cp.async is the synchronous 16- or 4-byte copy below. A kernel's
// `extern __shared__ float smem[]` names the `smem` array below, which each
// block finds filled with NaN. The test that uses it rewrites each
// `kernel<<<grid, block, bytes, stream>>>(args)` of the source into an
// emu_launch of the blocks one after another, since g++ cannot parse the
// launch syntax (a grid may be a dim3 of x and y blocks). Timing and the
// memory model are not emulated; the index arithmetic, the barriers'
// placement, the shuffles, ballots (of a warp or a half-warp), matches and
// redux reductions, the atomics (under one lock) and the floating-point
// operations are (fmaf is the C library's, exact). The 1D bulk copy (TMA)
// is a synchronous copy that checks its alignment, stays inside the
// launch's dynamic shared memory and, where a test program sets g_bulk_lo /
// g_bulk_hi or g_bulk_ranges, reads nothing outside them; mbarriers count
// arrivals and bytes under one lock, and a wait sleeps until its phase has
// completed.
// ldmatrix, mma.sync m16n8k16 bf16 and the bf16 conversions are stand-ins
// with the PTX ISA's fragment layouts: they check the fragments' indices,
// not the tensor cores' rounding (the mma sums its terms k ascending).
// wgmma.mma_async (A from registers, B from shared memory by descriptor) is
// asynchronous as on the card: an op reads A and B and writes D when
// wgmma_wait retires its group, so a fragment rewritten or an accumulator
// read before then shows; named barriers count their own threads, and
// setmaxnreg and the operand fences are no-ops.
#pragma once

#define GEOA3_EMU 1

#include <algorithm>
#include <barrier>
#include <condition_variable>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <functional>
#include <map>
#include <mutex>
#include <thread>
#include <tuple>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __restrict__
#define __shared__
#define __align__(x)
#define __grid_constant__

using std::max;
using std::min;

struct float2 {
  float x, y;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
struct float3 {
  float x, y, z;
};
inline float3 make_float3(float a, float b, float c) { return {a, b, c}; }
struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
struct uint2 {
  unsigned x, y;
};
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
struct uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
struct int4 {
  int x, y, z, w;
};
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
struct dim3 {
  unsigned x = 0, y = 0, z = 0;
  dim3() = default;
  dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
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
inline float __uint_as_float(unsigned u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
// 0xff in each byte where a and b differ
inline unsigned __vcmpne4(unsigned a, unsigned b) {
  unsigned r = 0;
  for (int i = 0; i < 32; i += 8)
    if (((a >> i) & 255u) != ((b >> i) & 255u)) r |= 255u << i;
  return r;
}
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
inline float2 atomicAdd(float2* p, float2 v) {
  std::lock_guard<std::mutex> hold(g_atomic_mu);
  const float2 old = *p;
  *p = {old.x + v.x, old.y + v.y};
  return old;
}
inline int atomicAdd(int* p, int v) {
  std::lock_guard<std::mutex> hold(g_atomic_mu);
  const int old = *p;
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

// every lane of the warp must call them: lane `src`'s v, and lane
// (lane - delta)'s (a lane's own below delta)
template <class T>
T emu_shfl_from(T v, int from) {
  const int t = threadIdx.x;
  uint64_t u = 0;
  memcpy(&u, &v, sizeof(T));
  g_lanes[t] = u;
  g_warp_barrier[t / 32]->arrive_and_wait();
  const uint64_t r = g_lanes[(t & ~31) + from];
  g_warp_barrier[t / 32]->arrive_and_wait();
  T out;
  memcpy(&out, &r, sizeof(T));
  return out;
}
// (within segments of `width` lanes, as on the card)
template <class T>
T __shfl_sync(unsigned, T v, int src, int width = 32) {
  return emu_shfl_from(v, ((int)(threadIdx.x & 31) & ~(width - 1)) + (src & (width - 1)));
}
template <class T>
T __shfl_up_sync(unsigned, T v, unsigned delta, int width = 32) {
  const int lane = threadIdx.x & 31;
  return emu_shfl_from(v, (lane & (width - 1)) < (int)delta ? lane : lane - (int)delta);
}

// every lane of the warp must call it, or, with the mask of one half-warp
// (0x0000ffff, 0xffff0000: the float32 pool's tie scan), every lane of that
// half, whatever the other half does meanwhile
inline std::barrier<>* g_half_barrier[64];
inline unsigned __ballot_sync(unsigned mask, bool pred) {
  const int t = threadIdx.x;
  std::barrier<>* bar = g_warp_barrier[t / 32];
  int lo = t & ~31, hi = lo + 32;
  if (mask != ~0u) {
    if (mask != 0xffffu << (t & 16)) {
      fprintf(stderr, "__ballot_sync: mask %08x is neither the warp nor lane %d's half\n",
              mask, t & 31);
      std::abort();
    }
    bar = g_half_barrier[t / 16];
    lo = t & ~15, hi = lo + 16;
  }
  g_lanes[t] = pred ? 1u : 0u;
  bar->arrive_and_wait();
  unsigned m = 0;
  for (int l = lo; l < hi; ++l) m |= (unsigned)g_lanes[l] << (l & 31);
  bar->arrive_and_wait();
  return m;
}

// every lane of the warp must call it: the lanes whose v equals this lane's
inline unsigned __match_any_sync(unsigned, int v) {
  const int t = threadIdx.x;
  g_lanes[t] = (uint64_t)(uint32_t)v;
  g_warp_barrier[t / 32]->arrive_and_wait();
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= (g_lanes[(t & ~31) + l] == g_lanes[t] ? 1u : 0u) << l;
  g_warp_barrier[t / 32]->arrive_and_wait();
  return m;
}

inline bool __any_sync(unsigned m, bool pred) { return __ballot_sync(m, pred) != 0; }
inline bool __all_sync(unsigned m, bool pred) { return __ballot_sync(m, pred) == ~0u; }

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

inline size_t g_smem_bytes = 0;  // the running launch's dynamic shared memory

// bf16 as its 16 bits: float -> bf16 rounds to nearest even (NaN stays a
// quiet NaN), as cvt.rn.bf16x2.f32 does; the pair packs lo in the low half
inline uint32_t emu_bf16_bits(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (u >> 16) | 0x40u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}
inline uint32_t cvt_rn_bf16x2(float lo, float hi) {
  return emu_bf16_bits(lo) | (emu_bf16_bits(hi) << 16);
}
inline float emu_bf16_half(uint32_t v, int hi) {
  const uint32_t u = hi ? (v & 0xffff0000u) : (v << 16);
  float f;
  memcpy(&f, &u, 4);
  return f;
}

// ldmatrix.sync.aligned.m8n8.x4[.trans].shared.b16: every lane of the warp
// must call it, as the kernels do. Lanes 8 i .. 8 i + 7 give the rows of
// matrix i (16 bytes each, 16-byte aligned, inside the launch's dynamic
// shared memory, else the program aborts); lane l receives in r[i] matrix
// i's row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 (low half first), or
// with .trans its rows 2 (l % 4) and 2 (l % 4) + 1 of column l / 4.
inline void emu_ldmatrix(uint32_t (&r)[4], const void* p, bool trans) {
  const int t = threadIdx.x, base = t & ~31, lane = t & 31;
  const char* lo = reinterpret_cast<const char*>(smem);
  const char* row = static_cast<const char*>(p);
  if (reinterpret_cast<uintptr_t>(row) % 16 || row < lo ||
      row + 16 > lo + g_smem_bytes) {
    fprintf(stderr, "ldmatrix row out of shared memory or misaligned: +%td\n",
            row - lo);
    std::abort();
  }
  g_lanes[t] = reinterpret_cast<uintptr_t>(p);
  g_warp_barrier[t / 32]->arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    const uint16_t* a;
    const uint16_t* b;
    int col;
    if (trans) {
      a = reinterpret_cast<const uint16_t*>(g_lanes[base + 8 * i + 2 * (lane % 4)]);
      b = reinterpret_cast<const uint16_t*>(g_lanes[base + 8 * i + 2 * (lane % 4) + 1]);
      col = lane / 4;
      r[i] = a[col] | ((uint32_t)b[col] << 16);
    } else {
      a = reinterpret_cast<const uint16_t*>(g_lanes[base + 8 * i + lane / 4]);
      col = 2 * (lane % 4);
      r[i] = a[col] | ((uint32_t)a[col + 1] << 16);
    }
  }
  g_warp_barrier[t / 32]->arrive_and_wait();
}
inline void ldmatrix_x4(uint32_t (&r)[4], const void* p) { emu_ldmatrix(r, p, false); }
inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) { emu_ldmatrix(r, p, true); }

// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, d += a b: every lane
// of the warp must call it. The PTX ISA's fragments, g = lane / 4, q = lane
// % 4: a0 = A[g][2q..2q+1], a1 = A[g+8][2q..], a2 = A[g][2q+8..], a3 =
// A[g+8][2q+8..]; b0 = B[2q..2q+1][g], b1 = B[2q+8..2q+9][g]; d0, d1 =
// D[g][2q..2q+1], d2, d3 = D[g+8][2q..]. Each output is summed from its
// accumulator with k ascending, one fmaf a term (the products of bf16
// values are exact): an order of this emulation, not the tensor cores'
// rounding, which no CPU oracle reproduces.
inline uint32_t g_mma[1024][6];
inline void mma_m16n8k16_bf16(float (&d)[4], const uint32_t (&a)[4],
                              uint32_t b0, uint32_t b1) {
  const int t = threadIdx.x, base = t & ~31, lane = t & 31;
  for (int i = 0; i < 4; ++i) g_mma[t][i] = a[i];
  g_mma[t][4] = b0;
  g_mma[t][5] = b1;
  g_warp_barrier[t / 32]->arrive_and_wait();
  auto A = [&](int r, int k) {
    const int src = base + (r % 8) * 4 + (k % 8) / 2;
    return emu_bf16_half(g_mma[src][(r >= 8 ? 1 : 0) + (k >= 8 ? 2 : 0)], k & 1);
  };
  auto B = [&](int k, int n) {
    const int src = base + n * 4 + (k % 8) / 2;
    return emu_bf16_half(g_mma[src][k >= 8 ? 5 : 4], k & 1);
  };
  float out[4];
  for (int i = 0; i < 4; ++i) {
    const int r = lane / 4 + (i >= 2 ? 8 : 0), n = 2 * (lane % 4) + (i & 1);
    float acc = d[i];
    for (int k = 0; k < 16; ++k) acc = fmaf(A(r, k), B(k, n), acc);
    out[i] = acc;
  }
  g_warp_barrier[t / 32]->arrive_and_wait();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}

// wgmma.mma_async.sync.aligned.m64nNk16.f32.bf16.bf16 with A from
// registers and B from shared memory (wgmma_m64n64k16_bf16, and
// wgmma_bf16<N> at N = 64, 128 and 256): each of the
// warpgroup's 128 threads queues the op with its A fragment and its
// accumulators (by address), wgmma_commit closes a group, and
// wgmma_wait<K> runs the oldest groups until at most K remain, every thread
// of the warpgroup in step (the kernels call them warpgroup-uniformly).
// Warp w of the warpgroup holds A rows 16 w .. 16 w + 15 as mma.sync's A
// fragment; thread (w, lane) holds D[16 w + g + 8 h][8 j + 2 q + e] in
// d[4 j + 2 h + e] (g = lane / 4, q = lane % 4). B is decoded from the
// descriptor by the PTX ISA's canonical no-swizzle layouts (bits 0-13 the
// start >> 4, 16-29 the leading byte offset >> 4, 32-45 the stride byte
// offset >> 4; base offset and swizzle must be 0), K-major (imm-trans-b 0):
// B[k][n] at start + (n / 8) SBO + (k / 8) LBO + (n % 8) 16 + (k % 8) 2,
// every byte inside the launch's dynamic shared memory. The
// descriptor must be the same on every thread. Each output is summed from
// its accumulator (0 where scale-d is 0) with k ascending, one fmaf a term,
// as the mma.sync stand-in sums.
inline std::barrier<>* g_wg_barrier[8];
inline uint32_t g_wga[1024][4];
inline uint64_t g_wgdesc[1024];
struct EmuWgmma {
  float* d;
  const uint32_t* a;
  uint64_t desc;
  int n;
  bool scale_d;
};
inline thread_local std::vector<EmuWgmma> g_wg_open;
inline thread_local std::vector<std::vector<EmuWgmma>> g_wg_groups;

inline unsigned smem_addr(const void* p) {
  return (unsigned)(static_cast<const char*>(p) - reinterpret_cast<const char*>(smem));
}

inline void emu_wgmma_run(const EmuWgmma& op) {
  const int t = threadIdx.x, base = t & ~127, w = (t & 127) / 32, lane = t & 31;
  for (int i = 0; i < 4; ++i) g_wga[t][i] = op.a[i];
  g_wgdesc[t] = op.desc;
  std::barrier<>* bar = g_wg_barrier[t / 128];
  bar->arrive_and_wait();
  const uint64_t desc = g_wgdesc[base];
  for (int u = base; u < base + 128; ++u)
    if (g_wgdesc[u] != desc) {
      fprintf(stderr, "wgmma descriptor differs across the warpgroup\n");
      std::abort();
    }
  const size_t start = (desc & 0x3FFF) << 4, lbo = ((desc >> 16) & 0x3FFF) << 4;
  const size_t sbo = ((desc >> 32) & 0x3FFF) << 4;
  if ((desc >> 49) & 7 || desc >> 62) {
    fprintf(stderr, "wgmma descriptor: only the no-swizzle layout is emulated\n");
    std::abort();
  }
  const char* lo = reinterpret_cast<const char*>(smem);
  auto B = [&](int k, int c) {
    const size_t at = start + (c / 8) * sbo + (k / 8) * lbo + (c % 8) * 16 + (k % 8) * 2;
    if (at + 2 > g_smem_bytes) {
      fprintf(stderr, "wgmma B read past the launch's shared memory: +%zu\n", at);
      std::abort();
    }
    uint16_t h;
    memcpy(&h, lo + at, 2);
    return emu_bf16_half(h, 0);
  };
  auto A = [&](int r, int k) {
    const int src = base + (r / 16) * 32 + (r % 8) * 4 + (k % 8) / 2;
    return emu_bf16_half(g_wga[src][((r % 16) >= 8 ? 1 : 0) + (k >= 8 ? 2 : 0)], k & 1);
  };
  std::vector<float> out(op.n / 2);
  for (int i = 0; i < op.n / 2; ++i) {
    const int j = i / 4, h = (i / 2) % 2, e = i % 2;
    const int r = 16 * w + lane / 4 + 8 * h, c = 8 * j + 2 * (lane % 4) + e;
    float acc = op.scale_d ? op.d[i] : 0.0f;
    for (int k = 0; k < 16; ++k) acc = fmaf(A(r, k), B(k, c), acc);
    out[i] = acc;
  }
  bar->arrive_and_wait();
  for (int i = 0; i < op.n / 2; ++i) op.d[i] = out[i];
}

// wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 with B K-major
// (imm-trans-b 0); d's old value is added where scale_d != 0
inline void wgmma_m64n64k16_bf16(float (&d)[32], const uint32_t (&a)[4],
                                 uint64_t desc, int scale_d) {
  g_wg_open.push_back({d, a, desc, 64, scale_d != 0});
}
// m64nNk16 (csrc/wgmma.cuh's wgmma_bf16<N>, N = 64, 128 or 256): the same
// op N columns wide
template <int N>
void wgmma_bf16(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  g_wg_open.push_back({d, a, desc, N, scale_d != 0});
}
inline void wgmma_fence() {}
inline void wgmma_commit() {
  g_wg_groups.push_back(std::move(g_wg_open));
  g_wg_open.clear();
}
template <int K>
void wgmma_wait() {
  while ((int)g_wg_groups.size() > K) {
    for (const EmuWgmma& op : g_wg_groups.front()) emu_wgmma_run(op);
    g_wg_groups.erase(g_wg_groups.begin());
  }
}
inline void fence_operand(float&) {}
inline void fence_operand(uint32_t&) {}
inline void fence_proxy_async() {}
template <int R>
void setmaxnreg_inc() {}
template <int R>
void setmaxnreg_dec() {}

// bar.sync id, count: the first thread to arrive sets the count
inline std::mutex g_named_mu;
inline std::map<int, std::barrier<>*> g_named;
inline void named_bar_sync(int id, int count) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> hold(g_named_mu);
    std::barrier<>*& slot = g_named[id];
    if (slot == nullptr) slot = new std::barrier<>(count);
    b = slot;
  }
  b->arrive_and_wait();
}

// mbarriers (see the header); a phase completes when its arrivals and its
// expected bytes have all come in
struct EmuBarrier {
  unsigned count, pending;
  long long tx;
  unsigned phase;
};
inline std::mutex g_bar_mu;
inline std::condition_variable g_bar_cv;  // notified when a phase completes
inline std::map<const void*, EmuBarrier> g_bars;
inline void emu_bar_step(EmuBarrier& b) {
  if (b.pending == 0 && b.tx == 0) {
    b.phase ^= 1u;
    b.pending = b.count;
    g_bar_cv.notify_all();
  }
}
inline void mbar_init(uint64_t* bar, unsigned count) {
  std::lock_guard<std::mutex> hold(g_bar_mu);
  g_bars[bar] = {count, count, 0, 0};
}
inline void mbar_fence_init() {}
inline void mbar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> hold(g_bar_mu);
  EmuBarrier& b = g_bars.at(bar);
  --b.pending;
  emu_bar_step(b);
}
inline void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  std::lock_guard<std::mutex> hold(g_bar_mu);
  EmuBarrier& b = g_bars.at(bar);
  b.tx += bytes;
  --b.pending;
  emu_bar_step(b);
}
inline void mbar_wait(uint64_t* bar, unsigned parity) {
  std::unique_lock<std::mutex> hold(g_bar_mu);
  EmuBarrier& b = g_bars.at(bar);
  g_bar_cv.wait(hold, [&] { return b.phase != parity; });
}

// the device bytes a bulk copy may read, where a test program sets them:
// one range, or a list of ranges (a copy inside one of them)
inline const char* g_bulk_lo = nullptr;
inline const char* g_bulk_hi = nullptr;
inline std::vector<std::pair<const char*, const char*>> g_bulk_ranges;

inline bool emu_bulk_src_ok(const char* s, unsigned bytes) {
  if (g_bulk_lo != nullptr && (s < g_bulk_lo || s + bytes > g_bulk_hi)) return false;
  if (g_bulk_ranges.empty()) return true;
  for (const auto& [lo, hi] : g_bulk_ranges)
    if (s >= lo && s + bytes <= hi) return true;
  return false;
}

inline void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  const char* base = reinterpret_cast<const char*>(smem);
  if (bytes % 16 || reinterpret_cast<uintptr_t>(s) % 16 ||
      reinterpret_cast<uintptr_t>(d) % 16 || d < base ||
      d + bytes > base + g_smem_bytes || !emu_bulk_src_ok(s, bytes)) {
    fprintf(stderr, "bulk copy out of bounds or misaligned: %u bytes at +%zu\n",
            bytes, (size_t)(d - base));
    std::abort();
  }
  memcpy(d, s, bytes);
  std::lock_guard<std::mutex> hold(g_bar_mu);
  EmuBarrier& b = g_bars.at(bar);
  b.tx -= bytes;
  emu_bar_step(b);
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
  const dim3 grid = std::get<0>(cfg);
  const unsigned threads = (unsigned)std::get<1>(cfg);
  if constexpr (std::tuple_size_v<Config> > 2)
    g_smem_bytes = (size_t)std::get<2>(cfg);
  else
    g_smem_bytes = 0;
  gridDim = grid;
  blockDim.x = threads;
  for (unsigned b = 0; b < grid.x * grid.y; ++b) {
    blockIdx.x = b % grid.x;
    blockIdx.y = b / grid.x;
    std::fill(std::begin(smem), std::end(smem), NAN);  // unwritten reads show
    std::barrier<> block(threads);
    g_block_barrier = &block;
    std::vector<std::barrier<>*> warps;
    for (unsigned w = 0; w < (threads + 31) / 32; ++w)
      warps.push_back(g_warp_barrier[w] = new std::barrier<>(32));
    for (unsigned h = 0; h < (threads + 15) / 16; ++h)
      warps.push_back(g_half_barrier[h] = new std::barrier<>(16));
    for (unsigned w = 0; w < threads / 128; ++w)
      warps.push_back(g_wg_barrier[w] = new std::barrier<>(128));
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < threads; ++t)
      ts.emplace_back([t, &kernel] {
        threadIdx.x = t;
        kernel();
      });
    for (auto& th : ts) th.join();
    for (auto* w : warps) delete w;
    for (auto& [id, b] : g_named) delete b;
    g_named.clear();
  }
}
