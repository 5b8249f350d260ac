// One whole set-abstraction scale: ball query, grouping, three folded-
// BatchNorm affine+ReLU layers and the maximum over each ball; and its
// backward with respect to the points, the centres and the features.
//
// Replaces geoa3_tpu/ops/pallas/sa_fused_kernel.py:_fwd_kernel and
// :_bwd_kernel (sa_query_group_mlp). Layer 1 is linear, so it is projected
// once a point and once a centre instead of once a grouped row:
//   P = xyz @ W1x (+ feats @ W1f)   [b, n, c1]   (two fmaf chains, added)
//   Yc = centres @ W1x              [b, m, c1]
//   z1[g, s] = (P[idx[g, s]] - Yc[g]) + b1
// then two more affine+ReLU layers (group_mlp.cuh's tile) and the maximum
// over the ns slots, ties split evenly and ReLU'(0) = 0. idx is the ball
// query of ballquery.cuh, bitwise ops.ball_query's selection. The grouped
// rows never reach device memory, and a row gathers c1 floats instead of
// 3 + cf (64 or 128 instead of 323 at MSG SA2).
//
// The TPU kernel ranks hits with a triangular product and gathers with
// one-hot products in split bf16, having neither a prefix count nor a
// gather. Here: (a) `project_kernel` makes P and Yc with group_mlp.cuh's
// float32 tile; (b) `sa_fwd_kernel`: a block owns whole balls (as many as
// fill its R-row tile, or one larger ball walked tile by tile), its warps
// run the ball queries into shared memory, then each tile gathers layer 1
// from P and Yc, runs layers 2-3 and pools, leaving pooled, each maximum's
// tie count, and idx for the backward; (c) `sa_bwd_kernel` recomputes a tile
// from the saved idx (bitwise the forward's activations), takes the chain
// to dz1 from group_mlp.cuh, then each thread walks its columns of dz1 down
// the tile: it merges runs of one point (an under-full ball repeats its
// first hit) into one atomicAdd to dP [b, n, c1], and sums each ball's rows
// for dYc = -sum_s dz1 without atomics; (d) `backproject_kernel` maps dP and
// dYc back once: dxyz = dP @ W1x^T, dfeats = dP @ W1f^T,
// dcentres = dYc @ W1x^T.
//
// Bound on the H100: operations. Forward 2 (b n (3 + cf) c1 + b m 3 c1)
// for the projections plus 2 b m ns (c1 c2 + c2 c3) for layers 2-3; the
// backward twice the layers' share (the recompute and one dz @ w^T product
// a layer) plus the back-projection; the bytes (the clouds, features, P, Yc
// and the outputs) are a few tens of MB at MSG SA2.
#include "ballquery.cuh"
#include "common.cuh"
#include "group_mlp.cuh"

namespace {

using geoa3::BwdLayout;
using geoa3::Tile;

struct SADims {
  long long rows;  // b * m * ns: the flattened grouped rows
  int b, n, m, ns, cf, c0p, c1, c2, c3;
  float r2;
};

// out[row, :c1] = x[row] @ w1[:3] (+ f[row] @ w1[3:]): two fmaf chains
// (k ascending from 0), added last. x [rows, 3], f [rows, cf].
template <int R>
__global__ void __launch_bounds__(Tile<R>::kThreads)
    project_kernel(const float* __restrict__ x, const float* __restrict__ f,
                   long long rows, int cf, const float* w1, int c1,
                   float* __restrict__ out) {
  constexpr int LD = Tile<R>::LD;
  extern __shared__ __align__(16) float smem[];
  const long long row0 = (long long)blockIdx.x * R;
  const int nrows = (int)(rows - row0 < R ? rows - row0 : R);
  geoa3::load_input<R>(smem, x, f, row0, nrows, cf);
  __syncthreads();
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[4][4], accf[4][4];
  for (int j0 = tx * 4; j0 < c1; j0 += 64) {
    geoa3::gemm_tile<R>(smem, 3, w1, c1, j0, acc);
    if (cf > 0) {
      geoa3::gemm_tile<R>(smem + 3 * LD, cf, w1 + (size_t)3 * c1, c1, j0,
                          accf);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += accf[i][j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      if (r < nrows)
        *reinterpret_cast<float4*>(out + (row0 + r) * c1 + j0) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// Layer 1 of a tile, gathered: a1T[c][r] = relu((P[idx_r, c] - Yc[g_r, c])
// + b1[c]) for the tile's rows (sidx holds their point indices); rows past
// nrows are 0.
template <int R>
__device__ void gather_layer1(float* a1T, const float* __restrict__ P,
                              const float* __restrict__ Yc,
                              const float* __restrict__ b1, const int* sidx,
                              long long row0, int nrows, const SADims& d) {
  constexpr int LD = Tile<R>::LD, T = Tile<R>::kThreads;
  for (int e = threadIdx.x; e < R * d.c1; e += T) {
    const int r = e / d.c1, c = e - r * d.c1;
    float v = 0.0f;
    if (r < nrows) {
      const long long centre = (row0 + r) / d.ns;
      const long long pt = (centre / d.m) * d.n + sidx[r];
      v = fmaxf((P[pt * d.c1 + c] - Yc[centre * d.c1 + c]) + b1[c], 0.0f);
    }
    a1T[(size_t)c * LD + r] = v;
  }
}

// The block's first row and row count: whole balls, rows_per_block a
// multiple of ns.
__device__ __forceinline__ long long block_rows(const SADims& d,
                                                int rows_per_block,
                                                long long* row_end) {
  const long long row_begin = (long long)blockIdx.x * rows_per_block;
  *row_end = row_begin + rows_per_block < d.rows ? row_begin + rows_per_block
                                                 : d.rows;
  return row_begin;
}

template <int R>
size_t fwd_smem(const SADims& d, int rows_per_block) {
  return ((size_t)(d.c1 + d.c2) * Tile<R>::LD + (size_t)R * Tile<R>::LDC) *
             sizeof(float) +
         (size_t)rows_per_block * sizeof(int);
}

template <int R>
__global__ void __launch_bounds__(Tile<R>::kThreads)
    sa_fwd_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ centres,
                  const float* __restrict__ P, const float* __restrict__ Yc,
                  const float* b1, const float* w2, const float* b2,
                  const float* w3, const float* b3, SADims d,
                  int rows_per_block, int* __restrict__ idx, float* pooled,
                  int* cnt) {
  constexpr int LD = Tile<R>::LD, T = Tile<R>::kThreads;
  extern __shared__ __align__(16) float smem[];
  float* a1T = smem;
  float* a2T = a1T + (size_t)d.c1 * LD;
  float* chunk = a2T + (size_t)d.c2 * LD;
  int* sidx = reinterpret_cast<int*>(chunk + R * Tile<R>::LDC);

  long long row_end;
  const long long row_begin = block_rows(d, rows_per_block, &row_end);
  // the block's balls, one warp a centre
  const long long g0 = row_begin / d.ns;
  const int groups = (int)((row_end - row_begin) / d.ns);
  for (int g = threadIdx.x >> 5; g < groups; g += T / 32) {
    const long long centre = g0 + g;
    const float* C = centres + centre * 3;
    int* s = sidx + g * d.ns;
    geoa3_ball_query_warp(xyz + (centre / d.m) * d.n * 3, d.n, C[0], C[1],
                          C[2], d.r2, d.ns, s);
    for (int k = threadIdx.x & 31; k < d.ns; k += 32)
      idx[centre * d.ns + k] = s[k];
  }
  __syncthreads();
  for (long long row0 = row_begin; row0 < row_end; row0 += R) {
    const int nrows = (int)(row_end - row0 < R ? row_end - row0 : R);
    gather_layer1<R>(a1T, P, Yc, b1, sidx + (row0 - row_begin), row0, nrows,
                     d);
    __syncthreads();
    geoa3::dense_relu<R>(a1T, d.c1, w2, d.c2, b2, a2T);
    __syncthreads();
    geoa3::layer3_pool<R>(a2T, d.c2, w3, b3, d.c3, chunk, row0, nrows, d.ns,
                          pooled, cnt);
  }
}

template <int R>
size_t bwd_smem(const SADims& d, int rows_per_block) {
  return (size_t)geoa3::bwd_layout<R>(0, d.c1, d.c2).total * sizeof(float) +
         (size_t)rows_per_block * sizeof(int) + (size_t)d.c1 * sizeof(float);
}

// dP [b, n, c1] (zeroed by the caller) += the scatter of dz1 over idx;
// dYc [b, m, c1] = -sum_s dz1.
template <int R>
__global__ void __launch_bounds__(Tile<R>::kThreads)
    sa_bwd_kernel(const float* __restrict__ P, const float* __restrict__ Yc,
                  const int* __restrict__ idx, const float* b1,
                  const float* w2, const float* b2, const float* w3,
                  const float* b3, const float* w2t, const float* w3t,
                  const float* __restrict__ pooled,
                  const int* __restrict__ cnt, const float* __restrict__ gout,
                  SADims d, int rows_per_block, BwdLayout l,
                  float* __restrict__ dP, float* __restrict__ dYc) {
  constexpr int LD = Tile<R>::LD, T = Tile<R>::kThreads;
  extern __shared__ __align__(16) float smem[];
  float* a1T = smem + l.a1;
  float* a2T = smem + l.a2;
  float* d1T = smem + l.d1;
  int* sidx = reinterpret_cast<int*>(smem + l.total);
  float* gsum = smem + l.total + rows_per_block;  // a ball's running sum

  long long row_end;
  const long long row_begin = block_rows(d, rows_per_block, &row_end);
  for (int e = threadIdx.x; e < (int)(row_end - row_begin); e += T)
    sidx[e] = idx[row_begin + e];  // the flat idx is indexed by row
  for (int c = threadIdx.x; c < d.c1; c += T) gsum[c] = 0.0f;
  __syncthreads();
  for (long long row0 = row_begin; row0 < row_end; row0 += R) {
    const int nrows = (int)(row_end - row0 < R ? row_end - row0 : R);
    const int* ts = sidx + (row0 - row_begin);
    gather_layer1<R>(a1T, P, Yc, b1, ts, row0, nrows, d);
    __syncthreads();
    geoa3::dense_relu<R>(a1T, d.c1, w2, d.c2, b2, a2T);
    __syncthreads();
    geoa3::backward_to_dz1<R>(a1T, a2T, smem + l.d2, smem + l.ch, d1T, w2t,
                              w3, b3, w3t, d.c1, d.c2, d.c3, pooled, cnt,
                              gout, row0, nrows, d.ns);
    // a thread owns columns of dz1 and walks the tile's rows in order
    for (int c = threadIdx.x; c < d.c1; c += T) {
      float gs = gsum[c];
      long long run_pt = -1;
      float run = 0.0f;
      for (int r = 0; r < nrows; ++r) {
        const long long row = row0 + r;
        const long long centre = row / d.ns;
        const int s = (int)(row - centre * d.ns);
        const float v = d1T[(size_t)c * LD + r];
        gs = s == 0 ? v : gs + v;
        if (s == d.ns - 1) dYc[centre * d.c1 + c] = -gs;
        const long long pt = (centre / d.m) * d.n + ts[r];
        if (pt != run_pt) {
          if (run != 0.0f) atomicAdd(dP + run_pt * d.c1 + c, run);
          run_pt = pt;
          run = v;
        } else {
          run += v;
        }
      }
      if (run != 0.0f) atomicAdd(dP + run_pt * d.c1 + c, run);
      gsum[c] = gs;
    }
    __syncthreads();
  }
}

// dv [rows, c1] @ w1t [c1, c0p], its first `cols` columns (a multiple of
// 4): columns 0..2 into dx [rows, 3], 3..3+cf into df [rows, cf].
template <int R>
__global__ void __launch_bounds__(Tile<R>::kThreads)
    backproject_kernel(const float* __restrict__ dv, long long rows, int c1,
                       const float* w1t, int c0p, int cols, int cf,
                       float* __restrict__ dx, float* __restrict__ df) {
  constexpr int LD = Tile<R>::LD, T = Tile<R>::kThreads;
  extern __shared__ __align__(16) float smem[];
  const long long row0 = (long long)blockIdx.x * R;
  const int nrows = (int)(rows - row0 < R ? rows - row0 : R);
  for (int e = threadIdx.x; e < R * c1; e += T) {
    const int r = e / c1, k = e - r * c1;
    smem[(size_t)k * LD + r] = r < nrows ? dv[(row0 + r) * c1 + k] : 0.0f;
  }
  __syncthreads();
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[4][4];
  for (int jx = tx * 4; jx < cols; jx += 64) {
    geoa3::gemm_tile<R>(smem, c1, w1t, c0p, jx, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      if (r >= nrows) continue;
      const long long row = row0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = jx + j;
        if (c < 3)
          dx[row * 3 + c] = acc[i][j];
        else if (c < 3 + cf)
          df[row * cf + (c - 3)] = acc[i][j];
      }
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int rows_per_block_for(int R, int ns) { return ns <= R ? (R / ns) * ns : ns; }

template <int R>
int launch_project(const float* x, const float* f, long long rows, int cf,
                   const float* w1, int c1, float* out, cudaStream_t s) {
  const size_t smem = (size_t)(3 + cf) * Tile<R>::LD * sizeof(float);
  cudaError_t e = allow_smem(project_kernel<R>, smem);
  if (e != cudaSuccess) return (int)e;
  project_kernel<R><<<(unsigned)((rows + R - 1) / R), Tile<R>::kThreads, smem,
                      s>>>(x, f, rows, cf, w1, c1, out);
  return (int)cudaGetLastError();
}

int project(const float* x, const float* f, long long rows, int cf,
            const float* w1, int c1, float* out, cudaStream_t s) {
  if (rows == 0) return 0;
  const size_t per = (size_t)(3 + cf) * sizeof(float);
  switch (geoa3::pick_rows(per * Tile<64>::LD, per * Tile<32>::LD,
                           per * Tile<16>::LD)) {
    case 64: return launch_project<64>(x, f, rows, cf, w1, c1, out, s);
    case 32: return launch_project<32>(x, f, rows, cf, w1, c1, out, s);
    case 16: return launch_project<16>(x, f, rows, cf, w1, c1, out, s);
  }
  return (int)cudaErrorInvalidConfiguration;
}

template <int R>
int launch_backproject(const float* dv, long long rows, int c1,
                       const float* w1t, int c0p, int cols, int cf, float* dx,
                       float* df, cudaStream_t s) {
  const size_t smem = (size_t)c1 * Tile<R>::LD * sizeof(float);
  cudaError_t e = allow_smem(backproject_kernel<R>, smem);
  if (e != cudaSuccess) return (int)e;
  backproject_kernel<R><<<(unsigned)((rows + R - 1) / R), Tile<R>::kThreads,
                          smem, s>>>(dv, rows, c1, w1t, c0p, cols, cf, dx, df);
  return (int)cudaGetLastError();
}

int backproject(const float* dv, long long rows, int c1, const float* w1t,
                int c0p, int cols, int cf, float* dx, float* df,
                cudaStream_t s) {
  if (rows == 0) return 0;
  const size_t per = (size_t)c1 * sizeof(float);
  switch (geoa3::pick_rows(per * Tile<64>::LD, per * Tile<32>::LD,
                           per * Tile<16>::LD)) {
    case 64:
      return launch_backproject<64>(dv, rows, c1, w1t, c0p, cols, cf, dx, df,
                                    s);
    case 32:
      return launch_backproject<32>(dv, rows, c1, w1t, c0p, cols, cf, dx, df,
                                    s);
    case 16:
      return launch_backproject<16>(dv, rows, c1, w1t, c0p, cols, cf, dx, df,
                                    s);
  }
  return (int)cudaErrorInvalidConfiguration;
}

template <int R>
int launch_fwd(const float* xyz, const float* centres, const float* P,
               const float* Yc, const float* b1, const float* w2,
               const float* b2, const float* w3, const float* b3,
               const SADims& d, int* idx, float* pooled, int* cnt,
               cudaStream_t s) {
  const int rpb = rows_per_block_for(R, d.ns);
  const size_t smem = fwd_smem<R>(d, rpb);
  cudaError_t e = allow_smem(sa_fwd_kernel<R>, smem);
  if (e != cudaSuccess) return (int)e;
  sa_fwd_kernel<R><<<(unsigned)((d.rows + rpb - 1) / rpb), Tile<R>::kThreads,
                     smem, s>>>(xyz, centres, P, Yc, b1, w2, b2, w3, b3, d,
                                rpb, idx, pooled, cnt);
  return (int)cudaGetLastError();
}

template <int R>
int launch_bwd(const float* P, const float* Yc, const int* idx,
               const float* b1, const float* w2, const float* b2,
               const float* w3, const float* b3, const float* w2t,
               const float* w3t, const float* pooled, const int* cnt,
               const float* gout, const SADims& d, float* dP, float* dYc,
               cudaStream_t s) {
  const int rpb = rows_per_block_for(R, d.ns);
  const size_t smem = bwd_smem<R>(d, rpb);
  cudaError_t e = allow_smem(sa_bwd_kernel<R>, smem);
  if (e != cudaSuccess) return (int)e;
  sa_bwd_kernel<R><<<(unsigned)((d.rows + rpb - 1) / rpb), Tile<R>::kThreads,
                     smem, s>>>(P, Yc, idx, b1, w2, b2, w3, b3, w2t, w3t,
                                pooled, cnt, gout, d, rpb,
                                geoa3::bwd_layout<R>(0, d.c1, d.c2), dP, dYc);
  return (int)cudaGetLastError();
}

SADims make_dims(int b, int n, int m, int ns, int cf, int c1, int c2, int c3,
                 float r2) {
  SADims d;
  d.rows = (long long)b * m * ns;
  d.b = b;
  d.n = n;
  d.m = m;
  d.ns = ns;
  d.cf = cf;
  d.c0p = (3 + cf + 3) / 4 * 4;
  d.c1 = c1;
  d.c2 = c2;
  d.c3 = c3;
  d.r2 = r2;
  return d;
}

bool dims_ok(const SADims& d) {
  return d.ns > 0 && d.cf >= 0 && d.c1 > 0 && d.c2 > 0 && d.c3 > 0 &&
         d.c1 % 4 == 0 && d.c2 % 4 == 0 && d.c3 % 4 == 0;
}

}  // namespace

// xyz [b, n, 3], centres [b, m, 3], feats [b, n, cf] (null when cf == 0);
// w1 [3 + cf, c1], w2 [c1, c2], w3 [c2, c3] row-major with their biases.
// Writes the projections P [b, n, c1] and Yc [b, m, c1] (kept for the
// backward), idx [b, m, ns], pooled [b, m, c3] and each maximum's tie count
// cnt [b, m, c3]. Widths must be multiples of 4 and every pointer 16-byte
// aligned.
extern "C" int geoa3_sa_fused_fwd(const float* xyz, const float* centres,
                                  const float* feats, const float* w1,
                                  const float* b1, const float* w2,
                                  const float* b2, const float* w3,
                                  const float* b3, int b, int n, int m, int ns,
                                  int cf, int c1, int c2, int c3, float r2,
                                  float* P, float* Yc, int* idx, float* pooled,
                                  int* cnt, void* stream) {
  const SADims d = make_dims(b, n, m, ns, cf, c1, c2, c3, r2);
  if (!dims_ok(d) || n <= 0) return (int)cudaErrorInvalidValue;
  if (d.rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e = project(xyz, feats, (long long)b * n, cf, w1, c1, P, s);
  if (e) return e;
  e = project(centres, nullptr, (long long)b * m, 0, w1, c1, Yc, s);
  if (e) return e;
  const int r64 = rows_per_block_for(64, ns), r32 = rows_per_block_for(32, ns),
            r16 = rows_per_block_for(16, ns);
  switch (geoa3::pick_rows(fwd_smem<64>(d, r64), fwd_smem<32>(d, r32),
                           fwd_smem<16>(d, r16))) {
    case 64:
      return launch_fwd<64>(xyz, centres, P, Yc, b1, w2, b2, w3, b3, d, idx,
                            pooled, cnt, s);
    case 32:
      return launch_fwd<32>(xyz, centres, P, Yc, b1, w2, b2, w3, b3, d, idx,
                            pooled, cnt, s);
    case 16:
      return launch_fwd<16>(xyz, centres, P, Yc, b1, w2, b2, w3, b3, d, idx,
                            pooled, cnt, s);
  }
  return (int)cudaErrorInvalidConfiguration;
}

// P, Yc, idx, pooled and cnt from the forward; w1t [c1, c0p] (w1 transposed,
// its 3 + cf columns zero-padded to a multiple of 4), w2t [c2, c1], w3t
// [c3, c2]; gout [b, m, c3]. Scratch dP [b, n, c1] zeroed by the caller and
// dYc [b, m, c1]. Writes dxyz [b, n, 3], dcentres [b, m, 3] and dfeats
// [b, n, cf] (null when cf == 0).
extern "C" int geoa3_sa_fused_bwd(
    const float* P, const float* Yc, const int* idx, const float* b1,
    const float* w2, const float* b2, const float* w3, const float* b3,
    const float* w1t, const float* w2t, const float* w3t, const float* pooled,
    const int* cnt, const float* gout, int b, int n, int m, int ns, int cf,
    int c1, int c2, int c3, float* dP, float* dYc, float* dxyz,
    float* dcentres, float* dfeats, void* stream) {
  const SADims d = make_dims(b, n, m, ns, cf, c1, c2, c3, 0.0f);
  if (!dims_ok(d) || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d.rows > 0) {
    const int r64 = rows_per_block_for(64, ns),
              r32 = rows_per_block_for(32, ns),
              r16 = rows_per_block_for(16, ns);
    int e = (int)cudaErrorInvalidConfiguration;
    switch (geoa3::pick_rows(bwd_smem<64>(d, r64), bwd_smem<32>(d, r32),
                             bwd_smem<16>(d, r16))) {
      case 64:
        e = launch_bwd<64>(P, Yc, idx, b1, w2, b2, w3, b3, w2t, w3t, pooled,
                           cnt, gout, d, dP, dYc, s);
        break;
      case 32:
        e = launch_bwd<32>(P, Yc, idx, b1, w2, b2, w3, b3, w2t, w3t, pooled,
                           cnt, gout, d, dP, dYc, s);
        break;
      case 16:
        e = launch_bwd<16>(P, Yc, idx, b1, w2, b2, w3, b3, w2t, w3t, pooled,
                           cnt, gout, d, dP, dYc, s);
        break;
    }
    if (e) return e;
  }
  int e = backproject(dP, (long long)b * n, c1, w1t, d.c0p, d.c0p, cf, dxyz,
                      dfeats, s);
  if (e) return e;
  return backproject(dYc, (long long)b * m, c1, w1t, d.c0p, 4, 0, dcentres,
                     nullptr, s);
}
