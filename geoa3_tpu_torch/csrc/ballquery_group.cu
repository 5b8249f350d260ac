// Ball query with the reference's first-hit semantics, fused with the
// centred coordinate gather and the feature gather; and its backward.
//
// Replaces geoa3_tpu/ops/pallas/ballquery_group_kernel.py:_fwd_kernel and
// :_bwd_kernel (ball_query_group_planes). For centres [b, m, 3] in xyz
// [b, n, 3]: slot s of centre c holds the (s+1)-th point, in index order,
// with d^2 < r^2; an under-full ball repeats its first hit, an empty ball
// holds index 0. d^2 = max((|c|^2 + |x|^2) - 2 c.x, 0), every product and
// sum rounded on its own in ops/distance.py's association, so a centre that
// is a member of xyz hits itself at exactly 0 and the plain version selects
// bitwise the same points. Outputs: idx [b, m, ns] int32, gx [b, m, ns, 3] =
// xyz[idx] - centre, gf [b, m, ns, cf] = feats[idx]. With the gathers
// compiled out (kGather = false) this is ops.ball_query. The backward is the
// scatter of dgx and dgf over idx, with dcentre = -sum_s dgx.
//
// The TPU kernel ranks hits with a lower-triangular-ones product and gathers
// with one-hot products, because it has neither a prefix count nor a gather.
// Bound on the H100: bytes. The forward writes gf (134 MB of the 147 MB at
// SSG SA2, cf = 128); its distance tests, at most b*m*n*10 operations, stop
// where a ball is full. The backward reads dgf once and adds it into dfeats.
//
// Forward (`ballquery_fwd<kGather, kShared>`, one launch): a block of 8
// warps owns 8 consecutive centres of one cloud, one warp a centre. Where
// the cloud fits beside the warps' index rows in half an SM's shared memory
// (`bq_plan`: every engine path's n <= 2048), the block first stages it as
// float4 (x, y, z, |x|^2), |x|^2 by geoa3_sq3, so every distance, and so
// every hit, is bitwise the plain version's. The walk (ball_walk.cuh) reads
// a 32-point chunk with one load a lane and tests 4 chunks before the
// loop-carried check `cnt < ns`; it places hits by ballot and popcount in
// index order, drops positions >= ns and keeps the first hit, as
// ballquery.cuh's walk (which row 17 keeps) does. gx comes from the staged
// cloud; gf is copied by float4 loads and stores where cf % 4 == 0 and the
// pointers allow it, kRows float4s (or floats) in flight a lane. Past the
// plan the same walk reads the points from device memory, so any n runs.
// cudaFuncSetAttribute runs once an instantiation.
//
// Backward (`ballquery_bwd`, one launch after the outputs' memsets): a warp
// owns a centre (where cf == 0 and ns <= 16, a group of the warp's lanes
// does). Its lanes read dgx coalesced, one (slot, channel) entry a lane in
// memory order, and sum dcentre = -sum_s dgx by a fixed-order shuffle tree,
// written directly. A slot s >= 1 with idx[s] == idx[0] is a padding repeat
// of the first hit (real hits are strictly ascending), so slot 0 and its
// repeats are summed in registers and sent as one row; every other slot
// sends its own row: scalar atomics into dxyz from the same lanes (a warp
// instruction covers ~11 neighbouring rows), and for the features the
// lanes span the channels, a 128-channel row being one float4 atomicAdd a
// lane (scalar atomics where cf % 4 != 0; `scatter_rows`, scatter_rows.cuh,
// which row 13 runs too). An empty ball is one row into point 0. Indices
// outside [0, n) are dropped.
#include <stdint.h>

#include "ball_walk.cuh"
#include "common.cuh"
#include "scatter_rows.cuh"  // kRows, scatter_rows (shared with row 13)

namespace {

constexpr int kWarps = 8;  // a block: 8 warps, 8 centres (forward)

struct BqPlan {
  bool shared;  // the cloud staged in shared memory
  size_t smem;  // the warps' index rows, then the cloud where shared
};

// Stage the cloud wherever it fits beside the index rows in half an SM's
// shared memory (two blocks an SM at least).
BqPlan bq_plan(int n, int ns) {
  const size_t rows = (size_t)kWarps * ns * sizeof(int);
  const size_t cloud = (size_t)n * sizeof(float4);
  if (rows + cloud <= geoa3::kSmemHalf) return {true, rows + cloud};
  return {false, rows};
}

// G[s, :] = F[sidx[s], :] for the warp's ns rows of w elements (float4 or
// float), the rows flattened over the lanes, kRows loads in flight a lane.
template <class T>
__device__ __forceinline__ void copy_rows(const T* __restrict__ F,
                                          const int* sidx, int ns, int w,
                                          T* __restrict__ G, int lane) {
  const int total = ns * w;
  for (int t0 = 0; t0 < total; t0 += 32 * kRows) {
    T v[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int t = t0 + u * 32 + lane;
      if (t < total) {
        const int s = t / w;
        v[u] = __ldg(F + (size_t)sidx[s] * w + (t - s * w));
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int t = t0 + u * 32 + lane;
      if (t < total) G[t] = v[u];
    }
  }
}

template <bool kGather, bool kShared>
__global__ void __launch_bounds__(kWarps * 32)
    ballquery_fwd(const float* __restrict__ xyz,
                  const float* __restrict__ centres,
                  const float* __restrict__ feats, int n, int m, int ns,
                  int cf, int vec, float r2, int* __restrict__ idx,
                  float* __restrict__ gx, float* __restrict__ gf) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int blocks_a_cloud = (m + kWarps - 1) / kWarps;
  const int b = blockIdx.x / blocks_a_cloud;
  const int c = (blockIdx.x - b * blocks_a_cloud) * kWarps + warp;
  const float* P = xyz + (size_t)b * n * 3;
  int* sidx = reinterpret_cast<int*>(smem) + warp * ns;
  float4* cloud = reinterpret_cast<float4*>(smem + kWarps * ns);
  if constexpr (kShared) {
    for (int j = threadIdx.x; j < n; j += kWarps * 32) {
      const float x = __ldg(P + (size_t)j * 3), y = __ldg(P + (size_t)j * 3 + 1),
                  z = __ldg(P + (size_t)j * 3 + 2);
      cloud[j] = make_float4(x, y, z, geoa3_sq3(x, y, z));
    }
    __syncthreads();  // the block's only barrier
  }
  if (c >= m) return;  // warp-uniform
  const size_t ball = (size_t)b * m + c;
  const float cx = centres[ball * 3], cy = centres[ball * 3 + 1],
              cz = centres[ball * 3 + 2];
  geoa3_ball_walk<kShared>(cloud, P, n, cx, cy, cz, r2, ns, sidx, lane);
  const size_t slot0 = ball * ns;
  for (int s = lane; s < ns; s += 32) idx[slot0 + s] = sidx[s];
  if constexpr (!kGather) return;
  for (int t = lane; t < ns * 3; t += 32) {
    const int s = t / 3, k = t - s * 3;
    const float ck = k == 0 ? cx : (k == 1 ? cy : cz);
    float v;
    if constexpr (kShared)
      v = reinterpret_cast<const float*>(cloud)[sidx[s] * 4 + k];
    else
      v = __ldg(P + (size_t)sidx[s] * 3 + k);
    gx[slot0 * 3 + t] = v - ck;
  }
  if (cf == 0) return;
  if (vec)  // float4 rows: cf % 4 == 0, feats and gf 16-byte aligned
    copy_rows(reinterpret_cast<const float4*>(feats) + (size_t)b * n * (cf >> 2),
              sidx, ns, cf >> 2, reinterpret_cast<float4*>(gf) + slot0 * (cf >> 2),
              lane);
  else
    copy_rows(feats + (size_t)b * n * cf, sidx, ns, cf, gf + slot0 * cf, lane);
}

template <bool kGather, bool kShared>
cudaError_t launch_fwd(const BqPlan& plan, const float* xyz,
                       const float* centres, const float* feats, int b, int n,
                       int m, int ns, int cf, float r2, int* idx, float* gx,
                       float* gf, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ballquery_fwd<kGather, kShared>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geoa3::kSmemHalf);
  if (attr != cudaSuccess) return attr;
  const int vec = cf % 4 == 0 &&
                  (((uintptr_t)feats | (uintptr_t)gf) & 15) == 0;
  const unsigned blocks = (unsigned)b * ((m + kWarps - 1) / kWarps);
  ballquery_fwd<kGather, kShared><<<blocks, kWarps * 32, plan.smem, s>>>(
      xyz, centres, feats, n, m, ns, cf, vec, r2, idx, gx, gf);
  return cudaGetLastError();
}

template <bool kGather>
int launch_ballquery(const float* xyz, const float* centres,
                     const float* feats, int b, int n, int m, int ns, int cf,
                     float r2, int* idx, float* gx, float* gf,
                     cudaStream_t s) {
  if (b == 0 || m == 0) return 0;
  const BqPlan plan = bq_plan(n, ns);
  return (int)(plan.shared
                   ? launch_fwd<kGather, true>(plan, xyz, centres, feats, b, n,
                                               m, ns, cf, r2, idx, gx, gf, s)
                   : launch_fwd<kGather, false>(plan, xyz, centres, feats, b,
                                                n, m, ns, cf, r2, idx, gx, gf,
                                                s));
}

// L lanes a centre (a power of two; 32 / L centres a warp, L == 32 where
// cf > 0). Every lane of the warp runs the shuffles.
__global__ void __launch_bounds__(kWarps * 32)
    ballquery_bwd(const int* __restrict__ idx, const float* __restrict__ dgx,
                  const float* __restrict__ dgf, long long balls, int n,
                  int m, int ns, int cf, int L, int vec,
                  float* __restrict__ dxyz, float* __restrict__ dcentre,
                  float* __restrict__ dfeats) {
  const int lane = threadIdx.x & 31, sub = lane & (L - 1);
  const long long ball =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * (32 / L) +
      lane / L;
  const bool valid = ball < balls;
  const int* I = idx + (size_t)ball * ns;
  const long long bn = valid ? ball / m * n : 0;  // the cloud's first point
  const int first = valid ? __ldg(I) : 0;
  const bool first_in = first >= 0 && first < n;
  // dgx: an entry a lane, (slot, channel) in memory order, so a warp's
  // loads and atomics cover ~11 neighbouring rows; the centre's sum, and
  // slot 0 with its repeats, by channel
  float sum[3] = {0.0f, 0.0f, 0.0f}, rep[3] = {0.0f, 0.0f, 0.0f};
  if (valid) {
    const float* D = dgx + (size_t)ball * ns * 3;
    for (int t0 = sub; t0 < ns * 3; t0 += kRows * L) {  // kRows loads in flight
      int id[kRows];
      float v[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int t = t0 + u * L;
        id[u] = t < ns * 3 ? __ldg(I + t / 3) : first;
        v[u] = t < ns * 3 ? __ldg(D + t) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int t = t0 + u * L, k = t % 3;
        const bool r = id[u] == first;
        if (k == 0) {
          sum[0] += v[u];
          if (r) rep[0] += v[u];
        } else if (k == 1) {
          sum[1] += v[u];
          if (r) rep[1] += v[u];
        } else {
          sum[2] += v[u];
          if (r) rep[2] += v[u];
        }
        if (!r && id[u] >= 0 && id[u] < n)
          atomicAdd(dxyz + (bn + id[u]) * 3 + k, v[u]);
      }
    }
  }
  for (int off = L >> 1; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      sum[k] += __shfl_xor_sync(GEOA3_FULL_MASK, sum[k], off);
      rep[k] += __shfl_xor_sync(GEOA3_FULL_MASK, rep[k], off);
    }
  if (valid && sub == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dcentre[(size_t)ball * 3 + k] = -sum[k];
      if (first_in) atomicAdd(dxyz + (bn + first) * 3 + k, rep[k]);
    }
  }
  if (cf == 0 || !valid) return;  // warp-uniform: L == 32 where cf > 0
  // dgf: the lanes span the channels, the slots in turn
  if (vec)
    scatter_rows(I, reinterpret_cast<const float4*>(dgf) + (size_t)ball * ns * (cf >> 2),
                 ns, cf >> 2, n, first,
                 reinterpret_cast<float4*>(dfeats) + (size_t)bn * (cf >> 2), lane);
  else
    scatter_rows(I, dgf + (size_t)ball * ns * cf, ns, cf, n, first,
                 dfeats + (size_t)bn * cf, lane);
}

}  // namespace

// feats and gf may be null when cf == 0.
extern "C" int geoa3_ballquery_group_fwd(const float* xyz,
                                         const float* centres,
                                         const float* feats, int b, int n,
                                         int m, int ns, int cf, float r2,
                                         int* idx, float* gx, float* gf,
                                         void* stream) {
  return launch_ballquery<true>(xyz, centres, feats, b, n, m, ns, cf, r2, idx,
                                gx, gf, static_cast<cudaStream_t>(stream));
}

extern "C" int geoa3_ball_query(const float* xyz, const float* centres, int b,
                                int n, int m, int ns, float r2, int* idx,
                                void* stream) {
  return launch_ballquery<false>(xyz, centres, nullptr, b, n, m, ns, 0, r2,
                                 idx, nullptr, nullptr,
                                 static_cast<cudaStream_t>(stream));
}

// idx [b, m, ns]; dgx [b, m, ns, 3]; dgf [b, m, ns, cf] (null when cf == 0)
// -> dxyz [b, n, 3], dcentre [b, m, 3], dfeats [b, n, cf] (null when
// cf == 0). The entry zeroes dxyz and dfeats; one kernel launch.
extern "C" int geoa3_ballquery_group_bwd(const int* idx, const float* dgx,
                                         const float* dgf, int b, int n, int m,
                                         int ns, int cf, float* dxyz,
                                         float* dcentre, float* dfeats,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(dxyz, 0, (size_t)b * n * 3 * sizeof(float), s);
  if (e == cudaSuccess && cf > 0)
    e = cudaMemsetAsync(dfeats, 0, (size_t)b * n * cf * sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  const long long balls = (long long)b * m;
  if (balls == 0) return 0;
  // lanes a centre: where cf == 0, the power of two >= ns (on an H100,
  // MSG SA1's ns = 16 backward takes 0.0108 ms with two centres a warp,
  // 0.0150 with one)
  int L = 32;
  while (cf == 0 && L > 1 && L / 2 >= ns) L >>= 1;
  const int vec = cf % 4 == 0 &&
                  (((uintptr_t)dgf | (uintptr_t)dfeats) & 15) == 0;
  const long long warps = (balls + 32 / L - 1) / (32 / L);
  ballquery_bwd<<<(unsigned)((warps + kWarps - 1) / kWarps), kWarps * 32, 0,
                  s>>>(idx, dgx, dgf, balls, n, m, ns, cf, L, vec, dxyz,
                       dcentre, dfeats);
  return (int)cudaGetLastError();
}
