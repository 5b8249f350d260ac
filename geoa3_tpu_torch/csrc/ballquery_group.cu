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
// compiled out (kGather = false) this is ops.ball_query.
//
// The TPU kernel ranks hits with a lower-triangular-ones product and gathers
// with one-hot products, because it has neither a prefix count nor a gather.
// Here one warp owns a centre: it walks the points 32 at a time, ballots the
// hits, places each by the popcount of the hits before it until ns are
// taken (ballquery.cuh, which sa_fused.cu shares), then copies rows
// (feature rows coalesced over cf). The backward
// does not rank again: the forward saved idx, so it is the C-channel scatter
// of scatter.cuh over idx (for xyz and for the features) and one sum over
// the slots for the centres, dcentre = -sum_s dgx.
//
// Bound on the H100: bytes (gf written once is the largest term at cf = 128;
// the distance tests are b*m*n*10 operations at most and stop early).
#include "ballquery.cuh"
#include "common.cuh"
#include "scatter.cuh"

namespace {

constexpr int kWarps = 8;

template <bool kGather>
__global__ void ballquery_kernel(const float* __restrict__ xyz,
                                 const float* __restrict__ centres,
                                 const float* __restrict__ feats, int n, int m,
                                 int ns, int cf, float r2,
                                 int* __restrict__ idx, float* __restrict__ gx,
                                 float* __restrict__ gf) {
  extern __shared__ int sidx_all[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + warp;
  const int b = blockIdx.y;
  if (c >= m) return;  // warp-uniform; no block-wide barrier below
  int* sidx = sidx_all + (size_t)warp * ns;
  const float* P = xyz + (size_t)b * n * 3;
  const float* C = centres + ((size_t)b * m + c) * 3;
  const float cx = C[0], cy = C[1], cz = C[2];
  geoa3_ball_query_warp(P, n, cx, cy, cz, r2, ns, sidx);
  const size_t slot0 = ((size_t)b * m + c) * ns;
  for (int s = lane; s < ns; s += 32) idx[slot0 + s] = sidx[s];
  if (!kGather) return;
  __syncwarp();
  for (int t = lane; t < ns * 3; t += 32) {
    const int s = t / 3, k = t - s * 3;
    const float ck = k == 0 ? cx : (k == 1 ? cy : cz);
    gx[slot0 * 3 + t] = P[sidx[s] * 3 + k] - ck;
  }
  if (cf > 0) {
    const float* F = feats + (size_t)b * n * cf;
    for (int s = 0; s < ns; ++s) {
      const float* src = F + (size_t)sidx[s] * cf;
      float* dst = gf + (slot0 + s) * cf;
      for (int k = lane; k < cf; k += 32) dst[k] = src[k];
    }
  }
}

// dcentre[b, c, k] = -sum_s dgx[b, c, s, k]: one thread per (centre, k),
// the slots summed in order.
__global__ void centre_grad_kernel(const float* __restrict__ dgx,
                                   long long total, int ns,
                                   float* __restrict__ dcentre) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long centre = t / 3;
  const int k = (int)(t - centre * 3);
  const float* g = dgx + (size_t)centre * ns * 3 + k;
  float acc = 0.0f;
  for (int s = 0; s < ns; ++s) acc += g[(size_t)s * 3];
  dcentre[t] = -acc;
}

template <bool kGather>
int launch_ballquery(const float* xyz, const float* centres,
                     const float* feats, int b, int n, int m, int ns, int cf,
                     float r2, int* idx, float* gx, float* gf,
                     cudaStream_t s) {
  if (b == 0 || m == 0) return 0;
  const size_t smem = (size_t)kWarps * ns * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      ballquery_kernel<kGather>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((m + kWarps - 1) / kWarps, b);
  ballquery_kernel<kGather><<<grid, kWarps * 32, smem, s>>>(
      xyz, centres, feats, n, m, ns, cf, r2, idx, gx, gf);
  return (int)cudaGetLastError();
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

// idx [b, m, ns]; dgx [b, m, ns, 3]; dgf [b, m, ns, cf] (null when cf == 0);
// dxyz [b, n, 3] and dfeats [b, n, cf] zeroed by the caller; dcentre [b, m, 3].
extern "C" int geoa3_ballquery_group_bwd(const int* idx, const float* dgx,
                                         const float* dgf, int b, int n, int m,
                                         int ns, int cf, float* dxyz,
                                         float* dcentre, float* dfeats,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = geoa3_launch_scatter_nc(idx, dgx, b, m * ns, n, 3, dxyz, s);
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)b * m * 3;
  if (total > 0) {
    const int threads = 256;
    centre_grad_kernel<<<(unsigned)((total + threads - 1) / threads), threads,
                         0, s>>>(dgx, total, ns, dcentre);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (cf > 0) e = geoa3_launch_scatter_nc(idx, dgf, b, m * ns, n, cf, dfeats, s);
  return (int)e;
}
