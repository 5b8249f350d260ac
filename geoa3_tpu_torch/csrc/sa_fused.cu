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
// then two more affine+ReLU layers and the maximum over the ns slots, ties
// split evenly and ReLU'(0) = 0. idx is the ball query of ballquery.cuh,
// bitwise ops.ball_query's selection. The grouped rows never reach device
// memory, and a row gathers c1 floats instead of 3 + cf (64 or 128 instead
// of 323 at MSG SA2).
//
// The TPU kernel ranks hits with a triangular product and gathers with
// one-hot products in split bf16, having neither a prefix count nor a
// gather. Here: (a) `project_kernel` makes P and Yc with group_mlp.cuh's
// float32 tile; (b) `sa_query_kernel` runs every ball query at once, one
// warp a centre, into idx (which the backward reads too); (c)
// `sa_fwd_tiles` runs tile_loop.cuh's forward (row 16's: persistent
// blocks, 8x8 register tiles, a cp.async weight ring, the pool by
// shuffles) over tiles of whole balls, or of one R-row part of a larger
// ball: its staging hook, gather_a1, reads the tile's rows' idx and
// gathers a1 = relu((P[idx] - Yc) + b1) into shared memory, then w2 (relu)
// and w3 (the pool) run on the ring; split balls' partials are merged by
// `sa_fwd_finish`; (d) `sa_bwd_tiles` runs the same loop with the same
// hook, then four layers on the ring: w2 (relu), w3 (dz3: the pooled
// cotangent split over the ties, where a3 == pooled > 0), w3t masked by
// a2 > 0 (off the ring over hit bits where ns >= 64, as row 16's) and w2t
// masked by a1 > 0, whose epilogue takes dz1 straight from registers: each
// thread adds its 8 rows x 4 or 8 columns into dP [b, n, c1] by float4
// atomics (Hopper's vector atomicAdd), rows of one point merged first (an
// under-full ball repeats its first hit), and the lanes of a ball's slot
// sum dYc = -sum_s dz1 by shuffles (a ball split over tiles adds its
// parts' sums by atomics into a zeroed dYc); (e)
// `backproject_kernel` maps dP and dYc back once: dxyz = dP @ W1x^T,
// dfeats = dP @ W1f^T, dcentres = dYc @ W1x^T. The forward's tiles and the
// backward's recompute share the gather and the loop, so `a3 == pooled` is
// exact by construction.
//
// Bound on the H100: operations. Forward 2 (b n (3 + cf) c1 + b m 3 c1)
// for the projections plus 2 b m ns (c1 c2 + c2 c3) for layers 2-3; the
// backward the recompute of layers 2-3, 2 c2 for each nonzero entry of dz3,
// 2 c2 c1 for each row that carries a cotangent, the back-projection and
// one add a scattered entry; the bytes (the clouds, features, P, Yc and the
// outputs) are a few tens of MB at MSG SA2.
#include "ballquery.cuh"
#include "common.cuh"
#include "group_mlp.cuh"
#include "tile_loop.cuh"

namespace {

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

// The backward's staging hook at a tile's first step: each row's point
// (its row of P and dP; -1 on rows outside the balls) into `sidx`, then
// a1[c][row] = relu((P[point, c] - Yc[ball, c]) + b1[c]) into layer 0's
// input, 0 on rows outside the balls. The forward's hook too.
template <int R>
__device__ __forceinline__ void gather_a1(long long gbase, int part,
                                          const float* __restrict__ P,
                                          const float* __restrict__ Yc,
                                          const int* __restrict__ idx,
                                          const float* __restrict__ b1,
                                          const SADims& sd, const Dims& d,
                                          const Plan& p) {
  extern __shared__ __align__(16) float smem[];
  int* sidx = reinterpret_cast<int*>(smem + p.aux);
  float* a1 = smem + p.lay[0].in;
  for (int rt = threadIdx.x; rt < R; rt += kThreads) {
    const long long ball = gbase + (rt >> p.psh);
    const int rr = part * p.P + (rt & (p.P - 1));
    sidx[rt] = ball < p.groups && rr < d.ns
                   ? (int)((ball / sd.m) * sd.n + __ldg(idx + ball * d.ns + rr))
                   : -1;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < d.c1 / 4 * R; e += kThreads) {
    const int q = e / R, rt = e - q * R;
    const int pt = sidx[rt];
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (pt >= 0) {
      const long long ball = gbase + (rt >> p.psh);
      const float4 x =
          __ldg(reinterpret_cast<const float4*>(P + (size_t)pt * d.c1) + q);
      const float4 y =
          __ldg(reinterpret_cast<const float4*>(Yc + ball * d.c1) + q);
      const float4 c = __ldg(reinterpret_cast<const float4*>(b1) + q);
      v = make_float4(fmaxf((x.x - y.x) + c.x, 0.0f),
                      fmaxf((x.y - y.y) + c.y, 0.0f),
                      fmaxf((x.z - y.z) + c.z, 0.0f),
                      fmaxf((x.w - y.w) + c.w, 0.0f));
    }
    float* o = a1 + (size_t)4 * q * R + rt;
    o[0] = v.x;
    o[R] = v.y;
    o[2 * R] = v.z;
    o[3 * R] = v.w;
  }
}

// The ball query of every centre, one warp a centre: idx [b, m, ns].
__global__ void __launch_bounds__(kThreads)
    sa_query_kernel(const float* __restrict__ xyz,
                    const float* __restrict__ centres, SADims sd,
                    int* __restrict__ idx) {
  const long long ball =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (ball >= (long long)sd.b * sd.m) return;  // warp-uniform
  const float* C = centres + ball * 3;
  geoa3_ball_query_warp(xyz + (ball / sd.m) * sd.n * 3, sd.n, C[0], C[1],
                        C[2], sd.r2, sd.ns, idx + ball * sd.ns);
}

// The forward's plan at R rows: region X (a2), region B (a1, gathered), the
// ring and R ints of the rows' points. Weights: w2, w3. The projections
// took layer 1, so there is no input region and nothing to slice.
Plan sa_fwd_make(const Dims& d, int R) {
  Plan p = tile_groups(d, R, kBK);
  const int X = 0, B = d.c2 * R;
  p.lay[0] = make_layer(R, kBK, d.c1, d.c2, B, X, 0, kRelu);
  p.lay[1] = make_layer(R, kBK, d.c2, d.c3, X, -1, 1, kPool);
  p.nl = 2;
  place_ring(p, d, R, (d.c2 + d.c1) * R, false, R);
  return p;
}

// tile_loop.cuh's pick_fwd at one level.
Plan sa_fwd_plan(const Dims& d, int* R) {
  return pick_fwd([&](int rows, int, size_t) { return sa_fwd_make(d, rows); },
                  1, R);
}

// The forward's tiles: tile_loop.cuh's fwd_tiles with gather_a1 as the
// hook. pooled, cnt [b, m, c3] (or, where balls are split, the parts'
// partials for sa_fwd_finish).
template <int R>
__global__ void __launch_bounds__(kThreads, R <= 32 ? 1 : 2)
    sa_fwd_tiles(const float* __restrict__ P, const float* __restrict__ Yc,
                 const int* __restrict__ idx, const float* __restrict__ b1,
                 Weights wt, const float* __restrict__ b3, SADims sd, Dims d,
                 Plan p, float* __restrict__ pooled, int* __restrict__ cnt,
                 float* __restrict__ part_max, int* __restrict__ part_cnt) {
  fwd_tiles<R>(
      wt, p, d, b3,
      [&](int L, int r, int sl, int, long long gbase, int part) {
        if ((L | r | sl) != 0) return false;
        gather_a1<R>(gbase, part, P, Yc, idx, b1, sd, d, p);
        return true;
      },
      pooled, cnt, part_max, part_cnt);
}

// Row 17's split balls from their parts' partials (tile_loop.cuh).
__global__ void sa_fwd_finish(const float* __restrict__ part_max,
                              const int* __restrict__ part_cnt, long long n,
                              int parts, int c3, float* __restrict__ pooled,
                              int* __restrict__ cnt) {
  fwd_finish(part_max, part_cnt, n, parts, c3, pooled, cnt);
}

// q[0..3] += v[0..3] into device memory by one float4 atomic, unless v is 0.
template <int CW>
__device__ __forceinline__ void add4(float* q, const float (&v)[CW], int j0) {
  if (v[j0] == 0.0f && v[j0 + 1] == 0.0f && v[j0 + 2] == 0.0f &&
      v[j0 + 3] == 0.0f)
    return;
  atomicAdd(reinterpret_cast<float4*>(q),
            make_float4(v[j0], v[j0 + 1], v[j0 + 2], v[j0 + 3]));
}

// The last layer's epilogue: dz1 = (d2 @ w2t) where a1 > 0 (ReLU'(0) = 0)
// for the thread's 8 rows x CW columns, added into dP [b, n, c1] from
// registers (the rows in tile order, each run of rows holding one point
// merged into one float4 atomic a 4 columns), and each ball's -sum over
// its rows into dYc [b, m, c1]: the thread's 8 rows, then the `lanes`
// lanes of its slot by shuffles; the slot's first lane writes it, or adds
// it by an atomic where the ball is split over tiles (dYc zeroed first).
// Every lane of the warp calls it (`ok`: the thread's columns lie inside
// the layer). Built with GEOA3_SA_BWD_NO_SCATTER (a timing variant of
// chip_smoke.py's, never the package's), it writes nothing: the time
// without this epilogue.
template <int R, int CW>
__device__ __forceinline__ void scatter_dz1(
    const float (&acc)[8][8], int col, bool ok, const Lane& ln,
    long long ball, int lanes, const Dims& d, const Plan& p,
    const float* a1T, const int* sidx, float* __restrict__ dP,
    float* __restrict__ dYc) {
  float v[8][CW];  // dz1, rows in tile order (8 rg + t)
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    float4 a0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), a4 = a0;
    if (ok) {
      a0 = *reinterpret_cast<const float4*>(a1T + (size_t)(col + j) * R +
                                            8 * ln.rg);
      a4 = *reinterpret_cast<const float4*>(a1T + (size_t)(col + j) * R +
                                            8 * ln.rg + 4);
    }
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a4.x, a4.y, a4.z, a4.w};
#pragma unroll
    for (int t = 0; t < 8; ++t)
      v[t][j] = a[t] > 0.0f ? (ln.sw ? acc[t ^ 4][j] : acc[t][j]) : 0.0f;
  }
#ifdef GEOA3_SA_BWD_NO_SCATTER
  float any = 0.0f;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int j = 0; j < CW; ++j) any += v[t][j];
  if (any != any) dP[0] = any;  // never: keeps the products alive
  return;
#endif
  if (ok) {
    const int4 s0 = *reinterpret_cast<const int4*>(sidx + 8 * ln.rg);
    const int4 s4 = *reinterpret_cast<const int4*>(sidx + 8 * ln.rg + 4);
    const int pts[8] = {s0.x, s0.y, s0.z, s0.w, s4.x, s4.y, s4.z, s4.w};
    float run[CW];
    int at = pts[0];
#pragma unroll
    for (int j = 0; j < CW; ++j) run[j] = v[0][j];
#pragma unroll
    for (int t = 1; t <= 8; ++t) {
      if (t < 8 && pts[t] == at) {
#pragma unroll
        for (int j = 0; j < CW; ++j) run[j] += v[t][j];
        continue;
      }
      if (at >= 0)
#pragma unroll
        for (int j0 = 0; j0 < CW; j0 += 4)
          add4<CW>(dP + (size_t)at * d.c1 + col + j0, run, j0);
      if (t < 8) {
        at = pts[t];
#pragma unroll
        for (int j = 0; j < CW; ++j) run[j] = v[t][j];
      }
    }
  }
  float sum[CW];
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    float s = 0.0f;
#pragma unroll
    for (int t = 0; t < 8; ++t) s += v[t][j];
    for (int o = 1; o < lanes; o <<= 1)
      s += __shfl_xor_sync(GEOA3_FULL_MASK, s, o);
    sum[j] = -s;
  }
  if (!ok || ln.rg % lanes != 0 || ball >= p.groups) return;
#pragma unroll
  for (int j0 = 0; j0 < CW; j0 += 4) {
    float4* q = reinterpret_cast<float4*>(dYc + ball * d.c1 + col + j0);
    const float4 s4 =
        make_float4(sum[j0], sum[j0 + 1], sum[j0 + 2], sum[j0 + 3]);
    if (p.parts == 1)
      *q = s4;
    else
      atomicAdd(q, s4);
  }
}

// The backward's plan at R rows and depth bk: region X (a2, then d2 in
// place, and where dz3 @ w3t runs on the ring, dz3 after it), region B
// (a1, gathered), the ring, the hit bits and shares where dz3 is sparse,
// and R ints of the rows' points. Weights: w2, w3, w3t, w2t.
Plan sa_bwd_make(const Dims& d, int R, int bk, bool sparse) {
  Plan p = tile_groups(d, R, bk);
  const int top = sparse ? d.c2 : d.c2 + d.c3;
  const int X = 0, B = top * R, Z = d.c2 * R;
  int n = 0;
  p.lay[n++] = make_layer(R, bk, d.c1, d.c2, B, X, 0, kRelu);
  p.lay[n] = make_layer(R, bk, d.c2, d.c3, X, sparse ? -1 : Z, 1, kDz3);
  if (sparse) {
    p.lay[n++].then = kSparse;
    p.sparse = make_layer(R, bk, d.c3, d.c2, -1, X, 2, kMask);
  } else {
    ++n;
    p.lay[n++] = make_layer(R, bk, d.c3, d.c2, Z, X, 2, kMask);
  }
  p.lay[n++] = make_layer(R, bk, d.c2, d.c1, X, B, 3, kScatter);
  p.nl = n;
  place_ring(p, d, R, (top + d.c1) * R, sparse, R);
  return p;
}

// tile_loop.cuh's pick_bwd: dz3 as hit bits where ns >= 64 or from level 2
// on (level 1 is level 0: there is no input to slice).
Plan sa_bwd_plan(const Dims& d, int* R) {
  return pick_bwd(
      [&](int rows, int bk, int level) {
        return sa_bwd_make(d, rows, bk, d.ns >= 64 || level >= 2);
      },
      R);
}

// One block an SM, as row 16's backward. dP [b, n, c1] (zeroed by the
// caller) += the scatter of dz1 over idx; dYc [b, m, c1] = -sum_s dz1.
template <int R, int BK>
__global__ void __launch_bounds__(kThreads, 1)
    sa_bwd_tiles(const float* __restrict__ P, const float* __restrict__ Yc,
                 const int* __restrict__ idx, const float* __restrict__ b1,
                 Weights wt, const float* __restrict__ b3, SADims sd, Dims d,
                 Plan p, const float* __restrict__ pooled,
                 const int* __restrict__ cnt, const float* __restrict__ gout,
                 float* __restrict__ dP, float* __restrict__ dYc) {
  extern __shared__ __align__(16) float smem[];
  const Lane ln = lane<R>();
  const int lanes = p.P / 8 < R / 8 ? p.P / 8 : R / 8;  // lanes sharing a slot
  run_tiles<R, 1, true, BK>(
      wt, p,
      [&](int L, int r, int sl, int, long long gbase, int part) {
        if ((L | r | sl) != 0) return false;
        gather_a1<R>(gbase, part, P, Yc, idx, b1, sd, d, p);
        return true;
      },
      [&](const Layer& l, int r, const float(&acc)[8][8], int col, bool ok,
          long long gbase, int part) {
        const int rr0 = part * p.P + ((8 * ln.rg) & (p.P - 1));
        const long long ball = gbase + ((8 * ln.rg) >> p.psh);
        if (l.epi == kScatter) {
          const int* sidx = reinterpret_cast<const int*>(smem + p.aux);
          if (R > 16 && l.cw == 8)
            scatter_dz1<R, 8>(acc, col, ok, ln, ball, lanes, d, p,
                              smem + l.out, sidx, dP, dYc);
          else
            scatter_dz1<R, 4>(acc, col, ok, ln, ball, lanes, d, p,
                              smem + l.out, sidx, dP, dYc);
          return;
        }
        if (ok && R > 16 && l.cw == 8) {
          if (l.epi == kDz3)
            dz3_store<R, 8>(l, acc, col, ln, ball, rr0, d, p, b3, pooled, cnt,
                            gout, smem);
          else
            mask_store<R, 8>(acc, col, ln, smem + l.out);
        } else if (ok) {
          if (l.epi == kDz3)
            dz3_store<R, 4>(l, acc, col, ln, ball, rr0, d, p, b3, pooled, cnt,
                            gout, smem);
          else
            mask_store<R, 4>(acc, col, ln, smem + l.out);
        }
        if (l.then == kSparse && r == l.rounds - 1) {
          __syncthreads();  // the hit bits and shares are whole
          if (R > 16 && p.sparse.cw == 8)
            sparse_layer<R, 8>(p.sparse, d, p, ln, wt.w[p.sparse.w], smem);
          else
            sparse_layer<R, 4>(p.sparse, d, p, ln, wt.w[p.sparse.w], smem);
        }
      });
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

// The tiles, then, where balls are split, the finishing kernel.
template <int R>
int launch_fwd(const Plan& p, const float* P, const float* Yc, const int* idx,
               const float* b1, const Weights& wt, const float* b3,
               const SADims& sd, const Dims& d, float* pooled, int* cnt,
               void* scratch, cudaStream_t s) {
  if (p.parts > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(sa_fwd_tiles<R>, p.smem);
  if (e != cudaSuccess) return (int)e;
  float* part_max = static_cast<float*>(scratch);
  int* part_cnt = reinterpret_cast<int*>(
      part_max + (p.parts > 1 ? (size_t)p.groups * p.parts * d.c3 : 0));
  sa_fwd_tiles<R><<<tile_grid(sa_fwd_tiles<R>, p), kThreads, p.smem, s>>>(
      P, Yc, idx, b1, wt, b3, sd, d, p, pooled, cnt, part_max, part_cnt);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.parts == 1) return (int)e;
  const long long n = p.groups * d.c3;
  sa_fwd_finish<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      part_max, part_cnt, n, p.parts, d.c3, pooled, cnt);
  return (int)cudaGetLastError();
}

template <int R, int BK>
int launch_bwd(const Plan& p, const float* P, const float* Yc, const int* idx,
               const float* b1, const Weights& wt, const float* b3,
               const SADims& sd, const Dims& d, const float* pooled,
               const int* cnt, const float* gout, float* dP, float* dYc,
               cudaStream_t s) {
  cudaError_t e = allow_smem(sa_bwd_tiles<R, BK>, p.smem);
  if (e != cudaSuccess) return (int)e;
  sa_bwd_tiles<R, BK><<<tile_grid(sa_bwd_tiles<R, BK>, p), kThreads, p.smem,
                        s>>>(P, Yc, idx, b1, wt, b3, sd, d, p, pooled, cnt,
                             gout, dP, dYc);
  return (int)cudaGetLastError();
}

// The plan's depth: 2 kBK or kBK above 16 rows, kBK or kBK / 2 at 16.
template <int R>
int launch_bwd_rows(const Plan& p, const float* P, const float* Yc,
                    const int* idx, const float* b1, const Weights& wt,
                    const float* b3, const SADims& sd, const Dims& d,
                    const float* pooled, const int* cnt, const float* gout,
                    float* dP, float* dYc, cudaStream_t s) {
  if (p.bk == kBK)
    return launch_bwd<R, kBK>(p, P, Yc, idx, b1, wt, b3, sd, d, pooled, cnt,
                              gout, dP, dYc, s);
  return launch_bwd<R, (R > 16 ? 2 * kBK : kBK / 2)>(
      p, P, Yc, idx, b1, wt, b3, sd, d, pooled, cnt, gout, dP, dYc, s);
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
// cnt [b, m, c3]. scratch: where the plan splits a ball into parts =
// ceil(ns / R) > 1 (R the tile height, sa_fused_kernel.fwd_plan), 2 * b * m
// * parts * c3 four-byte words for their partials (else unused, may be
// null). Widths must be multiples of 4 and every pointer 16-byte aligned.
// Refused (cudaErrorInvalidConfiguration) where even a 16-row tile does not
// fit a block's shared memory: where c1 + c2 > 2095, whatever ns.
extern "C" int geoa3_sa_fused_fwd(const float* xyz, const float* centres,
                                  const float* feats, const float* w1,
                                  const float* b1, const float* w2,
                                  const float* b2, const float* w3,
                                  const float* b3, int b, int n, int m, int ns,
                                  int cf, int c1, int c2, int c3, float r2,
                                  float* P, float* Yc, int* idx, float* pooled,
                                  int* cnt, void* scratch, void* stream) {
  const SADims sd = make_dims(b, n, m, ns, cf, c1, c2, c3, r2);
  if (!dims_ok(sd) || n <= 0) return (int)cudaErrorInvalidValue;
  if (sd.rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e = project(xyz, feats, (long long)b * n, cf, w1, c1, P, s);
  if (e) return e;
  e = project(centres, nullptr, (long long)b * m, 0, w1, c1, Yc, s);
  if (e) return e;
  const long long balls = (long long)b * m;
  sa_query_kernel<<<(unsigned)((balls + kThreads / 32 - 1) / (kThreads / 32)),
                    kThreads, 0, s>>>(xyz, centres, sd, idx);
  e = (int)cudaGetLastError();
  if (e) return e;
  const Dims d = make_dims(balls, ns, cf, c1, c2, c3);
  const Weights wt = {{w2, w3, nullptr, nullptr, nullptr, nullptr},
                      {b2, nullptr}};
  int R = 0;
  const Plan p = sa_fwd_plan(d, &R);
  switch (R) {
    case 128:
      return launch_fwd<128>(p, P, Yc, idx, b1, wt, b3, sd, d, pooled, cnt,
                             scratch, s);
    case 64:
      return launch_fwd<64>(p, P, Yc, idx, b1, wt, b3, sd, d, pooled, cnt,
                            scratch, s);
    case 32:
      return launch_fwd<32>(p, P, Yc, idx, b1, wt, b3, sd, d, pooled, cnt,
                            scratch, s);
    case 16:
      return launch_fwd<16>(p, P, Yc, idx, b1, wt, b3, sd, d, pooled, cnt,
                            scratch, s);
  }
  return (int)cudaErrorInvalidConfiguration;
}

// P, Yc, idx, pooled and cnt from the forward; w1t [c1, c0p] (w1 transposed,
// its 3 + cf columns zero-padded to a multiple of 4), w2t [c2, c1], w3t
// [c3, c2]; gout [b, m, c3]. Scratch dP [b, n, c1] zeroed by the caller and
// dYc [b, m, c1]. Writes dxyz [b, n, 3], dcentres [b, m, 3] and dfeats
// [b, n, cf] (null when cf == 0). Refused (cudaErrorInvalidConfiguration)
// where even a 16-row tile with 8-row ring stages and hit bits does not fit
// (sa_fused_kernel.bwd_plan): never at widths of at most 1024.
extern "C" int geoa3_sa_fused_bwd(
    const float* P, const float* Yc, const int* idx, const float* b1,
    const float* w2, const float* b2, const float* w3, const float* b3,
    const float* w1t, const float* w2t, const float* w3t, const float* pooled,
    const int* cnt, const float* gout, int b, int n, int m, int ns, int cf,
    int c1, int c2, int c3, float* dP, float* dYc, float* dxyz,
    float* dcentres, float* dfeats, void* stream) {
  const SADims sd = make_dims(b, n, m, ns, cf, c1, c2, c3, 0.0f);
  if (!dims_ok(sd) || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sd.rows > 0) {
    const Dims d = make_dims((long long)b * m, ns, cf, c1, c2, c3);
    const Weights wt = {{w2, w3, w3t, w2t, nullptr, nullptr}, {b2, nullptr}};
    int R = 0;
    const Plan p = sa_bwd_plan(d, &R);
    if (R == 0) return (int)cudaErrorInvalidConfiguration;
    int e = 0;
    if (p.parts > 1)  // split balls add their parts' sums
      e = (int)cudaMemsetAsync(dYc, 0, (size_t)b * m * c1 * sizeof(float), s);
    if (e) return e;
    switch (R) {
      case 256:
        e = launch_bwd_rows<256>(p, P, Yc, idx, b1, wt, b3, sd, d, pooled,
                                 cnt, gout, dP, dYc, s);
        break;
      case 128:
        e = launch_bwd_rows<128>(p, P, Yc, idx, b1, wt, b3, sd, d, pooled,
                                 cnt, gout, dP, dYc, s);
        break;
      case 64:
        e = launch_bwd_rows<64>(p, P, Yc, idx, b1, wt, b3, sd, d, pooled, cnt,
                                gout, dP, dYc, s);
        break;
      case 32:
        e = launch_bwd_rows<32>(p, P, Yc, idx, b1, wt, b3, sd, d, pooled, cnt,
                                gout, dP, dYc, s);
        break;
      case 16:
        e = launch_bwd_rows<16>(p, P, Yc, idx, b1, wt, b3, sd, d, pooled, cnt,
                                gout, dP, dYc, s);
        break;
    }
    if (e) return e;
  }
  int e = backproject(dP, (long long)b * n, c1, w1t, sd.c0p, sd.c0p, cf, dxyz,
                      dfeats, s);
  if (e) return e;
  return backproject(dYc, (long long)b * m, c1, w1t, sd.c0p, 4, 0, dcentres,
                     nullptr, s);
}
