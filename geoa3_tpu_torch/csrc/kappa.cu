// Self-kNN selection and the curvature (kappa) statistic.
//
// Replaces five kernels of geoa3_tpu/ops/pallas/kappa_kernel.py (exact
// selection only):
//   _kappa_selmask_kernel      -> kappa_select_kernel<false>
//   _kappa_fwd_kernel          -> kappa_select_kernel<true>
//   _curv_term_frommask_kernel -> curv_term_kernel
//   _kappa_frommask_kernel     -> kappa_frommask_kernel
//   _kappa_bwd_kernel          -> kappa_bwd_kernel<Radius>
//
// Selection (shared by the first two, as the TPU's _select_maskf is): row i
// takes itself plus the k nearest other points by
// d_ij = max((|p_i|^2 + |p_j|^2) - 2 p_i.p_j, 0), ties to the lowest index.
// One warp owns a row: its distances sit in shared memory, and k rounds of a
// warp-wide minimum over 64-bit (distance bits, index) keys strictly above
// the previous round's key find the k-th neighbour's key; the row's members
// are then exactly the columns whose key is at most that one. Products and
// sums of d are rounded one by one, so the mask is bitwise the plain
// version's.
//
// kappa_i = sum_{j in mask, j != i} |unit(p_j - p_i) . n_i| / k with the
// direct difference, as ops.knn_kappa composes it.
//
// The curvature term follows the composed path of ops.curv_term_from_mask:
// a_ij = |n_i.p_j - n_i.p_i| / max(r_ij, 1e-12) with r_ij = sqrt(d_ij) for
// d_ij > 0 and 0 otherwise, kappa_i = sum_j mask_ij a_ij / k,
// curv = mean_i (kappa_i - ref_i)^2, and the gradient of curv with respect to
// the cloud in the same pass (the cotangent of kappa_i is row-local), so the
// backward is a per-instance scalar multiply. Only the k+1 columns set in a
// mask row do work. Centre-side gradients are summed per row; neighbour-side
// gradients go to the neighbour's row by atomicAdd, so their sums vary in
// the last bits from run to run.
//
// kappa_frommask_kernel is the curvature term's forward half: it writes
// kappa_i itself. kappa_bwd_kernel contracts d kappa / d cloud with a
// cotangent g [b,n] from the mask alone, with the curvature term's gradient
// arithmetic and the row weight g_i / k. The TPU shares one backward between
// its two forwards because both take the radius from the distance expansion.
// The forwards here differ (kappa_fwd: |p_j - p_i| from the direct
// difference; kappa_frommask and curv_term: sqrt of the expansion), so the
// backward takes the radius as a template parameter and each forward gets the
// gradient of its own arithmetic. In both, |x|'(0) = 0 (self column,
// coincident points) and the radius carries no gradient at or below the
// 1e-12 clamp.
//
// Bound on the H100: bytes, the [b,n,n] int8 mask written (selection) or read
// (curvature term): 32 MB at the main path's [32,1024,1024]. The design keeps
// everything else on chip: each block stages its instance's cloud in shared
// memory once for 32 rows.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr float kEps = 1e-12f;

// Stage cloud b as planes + squared norms: sx, sy, sz, s2 (n each).
__device__ void stage_cloud(const float* __restrict__ P, int n, float* sx,
                            float* sy, float* sz, float* s2) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float x = P[j * 3], y = P[j * 3 + 1], z = P[j * 3 + 2];
    sx[j] = x;
    sy[j] = y;
    sz[j] = z;
    s2[j] = geoa3_sq3(x, y, z);
  }
}

// The selection shared by the selection-only and the fused kappa kernels:
// returns the key of row i's k-th nearest non-self neighbour (0 for k == 0).
// Row i's members are i itself and every j != i with key(d_ij, j) <= it.
__device__ unsigned long long select_kth_key(const float* drow, int n, int i,
                                             int k, int lane) {
  unsigned long long prev = 0ull;
  for (int r = 0; r < k; ++r) {
    unsigned long long best = ~0ull;
    for (int j = lane; j < n; j += 32) {
      if (j == i) continue;
      const unsigned long long key = geoa3_key(drow[j], j);
      if (key > prev && key < best) best = key;
    }
    prev = geoa3_warp_min_u64(best);
  }
  return prev;
}

template <bool kWithKappa>
__global__ void kappa_select_kernel(const float* __restrict__ cloud,
                                    const float* __restrict__ normal, int n,
                                    int k, float* __restrict__ kappa,
                                    int8_t* __restrict__ mask) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  float* s2 = sz + n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* drow = s2 + n + (size_t)warp * n;
  const int b = blockIdx.y;
  stage_cloud(cloud + (size_t)b * n * 3, n, sx, sy, sz, s2);
  __syncthreads();

  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int i = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp + rr;
    if (i >= n) break;  // warp-uniform
    const float px = sx[i], py = sy[i], pz = sz[i], p2 = s2[i];
    for (int j = lane; j < n; j += 32)
      drow[j] = geoa3_sqdist(p2, s2[j], geoa3_dot3(px, py, pz, sx[j], sy[j], sz[j]));
    __syncwarp();
    const unsigned long long last = select_kth_key(drow, n, i, k, lane);

    int8_t* mrow = mask + ((size_t)b * n + i) * n;
    float acc = 0.0f;
    float nx = 0.0f, ny = 0.0f, nz = 0.0f;
    if (kWithKappa) {
      const float* N = normal + ((size_t)b * n + i) * 3;
      nx = N[0];
      ny = N[1];
      nz = N[2];
    }
    for (int j = lane; j < n; j += 32) {
      const bool member = (j == i) || geoa3_key(drow[j], j) <= last;
      mrow[j] = member ? 1 : 0;
      if (kWithKappa && member && j != i) {
        const float vx = __fsub_rn(sx[j], px), vy = __fsub_rn(sy[j], py),
                    vz = __fsub_rn(sz[j], pz);
        const float den = fmaxf(sqrtf(geoa3_sq3(vx, vy, vz)), kEps);
        acc += fabsf(geoa3_dot3(vx / den, vy / den, vz / den, nx, ny, nz));
      }
    }
    if (kWithKappa) {
      acc = geoa3_warp_sum(acc);
      if (lane == 0) kappa[(size_t)b * n + i] = acc / (float)k;
    }
    __syncwarp();  // drow is rewritten for the next row
  }
}

// a_ij and its pieces for one (row i, column j) pair.
struct PairTerm {
  float s;  // the signed numerator: n_i.p_j - n_i.p_i, or unit(p_j - p_i).n_i
  float r;  // the radius: sqrt(d_ij) where d_ij > 0, else 0; or |p_j - p_i|
  float R;  // max(r, eps)
  float a;  // the pair's term of kappa_i (before the 1/k)
};

// Which forward a gradient belongs to.
enum class Radius { kExpansion, kDirect };

// One row's constants, loaded once by its warp.
struct RowCtx {
  float px, py, pz, p2;  // p_i and |p_i|^2
  float nx, ny, nz;      // n_i
  float sdiag;           // n_i.p_i
};

__device__ __forceinline__ RowCtx load_row(const float* sx, const float* sy,
                                           const float* sz, const float* s2,
                                           const float* __restrict__ N, int i) {
  RowCtx c;
  c.px = sx[i];
  c.py = sy[i];
  c.pz = sz[i];
  c.p2 = s2[i];
  c.nx = N[0];
  c.ny = N[1];
  c.nz = N[2];
  c.sdiag = geoa3_dot3(c.nx, c.ny, c.nz, c.px, c.py, c.pz);
  return c;
}

// The curvature term's and kappa_frommask's pair: a = |s| / max(r, eps) with
// s = n_i.p_j - n_i.p_i and r from the distance expansion.
__device__ __forceinline__ PairTerm pair_term(const RowCtx& c, float qx,
                                              float qy, float qz, float q2) {
  PairTerm t;
  t.s = __fsub_rn(geoa3_dot3(c.nx, c.ny, c.nz, qx, qy, qz), c.sdiag);
  const float d =
      geoa3_sqdist(c.p2, q2, geoa3_dot3(c.px, c.py, c.pz, qx, qy, qz));
  t.r = d > 0.0f ? sqrtf(d) : 0.0f;
  t.R = fmaxf(t.r, kEps);
  t.a = fabsf(t.s) / t.R;
  return t;
}

// kappa_fwd's pair: a = |unit(p_j - p_i) . n_i| with the direct difference.
__device__ __forceinline__ PairTerm pair_term_direct(const RowCtx& c, float qx,
                                                     float qy, float qz) {
  PairTerm t;
  const float vx = __fsub_rn(qx, c.px), vy = __fsub_rn(qy, c.py),
              vz = __fsub_rn(qz, c.pz);
  t.r = sqrtf(geoa3_sq3(vx, vy, vz));
  t.R = fmaxf(t.r, kEps);
  t.s = geoa3_dot3(vx / t.R, vy / t.R, vz / t.R, c.nx, c.ny, c.nz);
  t.a = fabsf(t.s);
  return t;
}

// kappa_i * k from a mask row: the sum of the row's pair terms (expansion
// radius), over the columns the mask sets.
__device__ __forceinline__ float row_term_sum(const RowCtx& c,
                                              const int8_t* __restrict__ mrow,
                                              const float* sx, const float* sy,
                                              const float* sz, const float* s2,
                                              int n, int lane) {
  float acc = 0.0f;
  for (int j = lane; j < n; j += 32) {
    if (!mrow[j]) continue;
    acc += pair_term(c, sx[j], sy[j], sz[j], s2[j]).a;
  }
  return geoa3_warp_sum(acc);
}

// Row i's share of the gradient for the weight w = d loss / d (sum_j a_ij):
// the neighbour-side vectors go to their rows of G by atomicAdd, the
// centre-side sum to row i.
// da/ds = sign(s)/R (or sign(s) for the direct pair, whose s is already
// divided by R); da/dr = -a/R above the clamp only, dr/dp_j = (p_j - p_i)/r:
// the pair's gradient on p_j is c n_i + e (p_j - p_i), and its negative on p_i.
template <Radius kRadius>
__device__ __forceinline__ void row_grad(const RowCtx& c,
                                         const int8_t* __restrict__ mrow,
                                         const float* sx, const float* sy,
                                         const float* sz, const float* s2,
                                         int n, int i, int lane, float w,
                                         float* __restrict__ G) {
  float cx = 0.0f, cy = 0.0f, cz = 0.0f;
  for (int j = lane; j < n; j += 32) {
    if (!mrow[j]) continue;
    const float qx = sx[j], qy = sy[j], qz = sz[j];
    const PairTerm t = kRadius == Radius::kDirect
                           ? pair_term_direct(c, qx, qy, qz)
                           : pair_term(c, qx, qy, qz, s2[j]);
    const float sg = t.s > 0.0f ? 1.0f : (t.s < 0.0f ? -1.0f : 0.0f);
    const float cc = w * sg / t.R;
    const float e = t.r > kEps ? -w * t.a / (t.r * t.r) : 0.0f;
    const float vx = cc * c.nx + e * (qx - c.px);
    const float vy = cc * c.ny + e * (qy - c.py);
    const float vz = cc * c.nz + e * (qz - c.pz);
    if (j != i) {
      atomicAdd(G + j * 3, vx);
      atomicAdd(G + j * 3 + 1, vy);
      atomicAdd(G + j * 3 + 2, vz);
    }
    cx -= vx;
    cy -= vy;
    cz -= vz;
  }
  cx = geoa3_warp_sum(cx);
  cy = geoa3_warp_sum(cy);
  cz = geoa3_warp_sum(cz);
  if (lane == 0) {
    atomicAdd(G + i * 3, cx);
    atomicAdd(G + i * 3 + 1, cy);
    atomicAdd(G + i * 3 + 2, cz);
  }
}

// Shared-memory layout of the mask-consuming kernels: the instance's cloud.
struct Staged {
  float *sx, *sy, *sz, *s2;
};

__device__ __forceinline__ Staged stage_instance(const float* __restrict__ cloud,
                                                 int b, int n, float* smem) {
  Staged s{smem, smem + n, smem + 2 * n, smem + 3 * n};
  stage_cloud(cloud + (size_t)b * n * 3, n, s.sx, s.sy, s.sz, s.s2);
  __syncthreads();
  return s;
}

__global__ void curv_term_kernel(const float* __restrict__ cloud,
                                 const float* __restrict__ normal,
                                 const float* __restrict__ ref,
                                 const int8_t* __restrict__ mask, int n, int k,
                                 float* __restrict__ curv,
                                 float* __restrict__ grad) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const Staged s = stage_instance(cloud, b, n, smem);
  float* G = grad + (size_t)b * n * 3;

  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int i = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp + rr;
    if (i >= n) break;  // warp-uniform
    const RowCtx c =
        load_row(s.sx, s.sy, s.sz, s.s2, normal + ((size_t)b * n + i) * 3, i);
    const int8_t* mrow = mask + ((size_t)b * n + i) * n;
    const float kap =
        row_term_sum(c, mrow, s.sx, s.sy, s.sz, s.s2, n, lane) / (float)k;
    const float diff = kap - ref[(size_t)b * n + i];
    if (lane == 0) atomicAdd(curv + b, diff * diff / (float)n);
    // d curv / d kappa_i = 2 diff / n; d kappa_i / d a_ij = 1 / k
    const float w = 2.0f * diff / (float)n / (float)k;
    row_grad<Radius::kExpansion>(c, mrow, s.sx, s.sy, s.sz, s.s2, n, i, lane, w,
                                 G);
  }
}

// kappa from a cached mask: the curvature term's forward half.
__global__ void kappa_frommask_kernel(const float* __restrict__ cloud,
                                      const float* __restrict__ normal,
                                      const int8_t* __restrict__ mask, int n,
                                      int k, float* __restrict__ kappa) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const Staged s = stage_instance(cloud, b, n, smem);

  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int i = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp + rr;
    if (i >= n) break;  // warp-uniform
    const RowCtx c =
        load_row(s.sx, s.sy, s.sz, s.s2, normal + ((size_t)b * n + i) * 3, i);
    const int8_t* mrow = mask + ((size_t)b * n + i) * n;
    const float sum = row_term_sum(c, mrow, s.sx, s.sy, s.sz, s.s2, n, lane);
    if (lane == 0) kappa[(size_t)b * n + i] = sum / (float)k;
  }
}

// grad[b, :, :] += sum_i g[b, i] d kappa_i / d cloud, from the mask; the
// wrapper zeroes grad.
template <Radius kRadius>
__global__ void kappa_bwd_kernel(const float* __restrict__ cloud,
                                 const float* __restrict__ normal,
                                 const int8_t* __restrict__ mask,
                                 const float* __restrict__ g, int n, int k,
                                 float* __restrict__ grad) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const Staged s = stage_instance(cloud, b, n, smem);
  float* G = grad + (size_t)b * n * 3;

  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int i = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp + rr;
    if (i >= n) break;  // warp-uniform
    const RowCtx c =
        load_row(s.sx, s.sy, s.sz, s.s2, normal + ((size_t)b * n + i) * 3, i);
    const int8_t* mrow = mask + ((size_t)b * n + i) * n;
    const float w = g[(size_t)b * n + i] / (float)k;
    row_grad<kRadius>(c, mrow, s.sx, s.sy, s.sz, s.s2, n, i, lane, w, G);
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <bool kWithKappa>
int launch_select(const float* cloud, const float* normal, int b, int n, int k,
                  float* kappa, int8_t* mask, cudaStream_t s) {
  const size_t smem = (size_t)(4 + kWarps) * n * sizeof(float);
  cudaError_t e = set_smem(kappa_select_kernel<kWithKappa>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, b);
  kappa_select_kernel<kWithKappa><<<grid, kWarps * 32, smem, s>>>(
      cloud, normal, n, k, kappa, mask);
  return (int)cudaGetLastError();
}

// Launch a mask-consuming kernel: one block per 32 rows of an instance, the
// instance's cloud staged in shared memory.
template <typename Kernel, typename... Args>
int launch_rows(Kernel kernel, int b, int n, void* stream, Args... args) {
  const size_t smem = (size_t)4 * n * sizeof(float);
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, b);
  kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int geoa3_kappa_selmask(const float* cloud, int b, int n, int k,
                                   int8_t* mask, void* stream) {
  return launch_select<false>(cloud, nullptr, b, n, k, nullptr, mask,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int geoa3_kappa_fwd(const float* cloud, const float* normal, int b,
                               int n, int k, float* kappa, int8_t* mask,
                               void* stream) {
  return launch_select<true>(cloud, normal, b, n, k, kappa, mask,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int geoa3_curv_term(const float* cloud, const float* normal,
                               const float* ref, const int8_t* mask, int b,
                               int n, int k, float* curv, float* grad,
                               void* stream) {
  return launch_rows(curv_term_kernel, b, n, stream, cloud, normal, ref, mask,
                     n, k, curv, grad);
}

extern "C" int geoa3_kappa_frommask(const float* cloud, const float* normal,
                                    const int8_t* mask, int b, int n, int k,
                                    float* kappa, void* stream) {
  return launch_rows(kappa_frommask_kernel, b, n, stream, cloud, normal, mask,
                     n, k, kappa);
}

// direct != 0: the gradient of geoa3_kappa_fwd's kappa; else the gradient of
// geoa3_kappa_frommask's.
extern "C" int geoa3_kappa_bwd(const float* cloud, const float* normal,
                               const int8_t* mask, const float* g, int b, int n,
                               int k, int direct, float* grad, void* stream) {
  if (direct)
    return launch_rows(kappa_bwd_kernel<Radius::kDirect>, b, n, stream, cloud,
                       normal, mask, g, n, k, grad);
  return launch_rows(kappa_bwd_kernel<Radius::kExpansion>, b, n, stream, cloud,
                     normal, mask, g, n, k, grad);
}
