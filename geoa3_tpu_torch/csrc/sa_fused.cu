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
// gather. Here: (a) `project_kernel` makes P and Yc in one launch (below);
// (b) `sa_query_kernel` runs every ball query at once, one
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
// `backproject_kernel` maps dP and dYc back in one launch: dxyz = dP @
// W1x^T, dfeats = dP @ W1f^T, dcentres = dYc @ W1x^T. The forward's tiles
// and the backward's recompute share the gather and the loop, so `a3 ==
// pooled` is exact by construction.
//
// The projections (a, e) are dense products with no gather: a block takes
// an output tile of BM rows x TQ column quads (4 columns a quad), each of
// 256 threads TM rows x QT quads in registers (8 x 8 where the layer is
// wide), each output one fmaf chain from 0, k ascending. The rows' inputs
// stay row-major in shared memory ([BM][kPK + 4], read 4 k at a time as
// float4; the padding puts consecutive rows on distinct bank groups) and
// the weights [kPK][4 TQ] beside them, both streamed in slices of kPK k
// through a ring of kPStages cp.async stages (16-byte copies where the
// rows are 16-byte aligned, 4-byte ones else), so the next slices' copies
// overlap the FMAs and any K fits. The tile's width follows the layer's
// (32, 16, 8 or 1 quads, the largest whose last column tile is more than
// half busy), its height keeps 256 threads; the 8 x 8 tiles are built for
// one block an SM (no register cap: at two they spill and ran ~17% slower
// on the H100), the others for two. P = (x @ W1x) + (f @ W1f): the
// feats chain on the ring, the 3-term xyz chain in the epilogue, added
// last; Yc's tiles (the blocks past P's) run the epilogue alone. The
// back-projection reads W1's rows as w1t's columns (w1t stays row 16's
// layout) shifted by one: column quad 0 is (0, x, y, z), so quad 1 + q is
// dfeats' columns 4q..4q+3 and dfeats is stored by float4 where its rows
// are 16-byte aligned; dfeats' tiles come first, then 1-quad tiles of dP's
// rows (dxyz) and of dYc's (dcentres).
//
// Bound on the H100: operations. Forward 2 (b n (3 + cf) c1 + b m 3 c1)
// for the projections plus 2 b m ns (c1 c2 + c2 c3) for layers 2-3; the
// backward the recompute of layers 2-3, 2 c2 for each nonzero entry of dz3,
// 2 c2 c1 for each row that carries a cotangent, the back-projection and
// one add a scattered entry; the bytes (the clouds, features, P, Yc and the
// outputs) are a few tens of MB at MSG SA2.
#include "ballquery.cuh"
#include "common.cuh"
#include "tile_loop.cuh"

namespace {

struct SADims {
  long long rows;  // b * m * ns: the flattened grouped rows
  int b, n, m, ns, cf, c0p, c1, c2, c3;
  float r2;
};

// ---- The projections and back-projections ------------------------------

constexpr int kPThreads = 256;
constexpr int kPK = 16;           // k a ring stage
constexpr int kPLD = kPK + 4;     // floats a staged input row (5 float4s)
constexpr int kPStages = 3;       // ring depth

// A tile's shape: each of the 256 threads holds TM rows x QT quads (4
// columns a quad); CG column groups x RG row groups. A warp is 32 / CW row
// groups x CW column groups, so its A reads cover consecutive rows (on
// distinct bank groups) and its stores whole 32-byte sectors. A thread's
// rows are rg + RG i, its quads cg + CG q. MB: blocks an SM the kernels
// are built for (1 leaves a thread all the registers an 8 x 8 tile wants).
template <int TM_, int QT_, int CG_, int MB_>
struct PCfg {
  static constexpr int TM = TM_, QT = QT_, CG = CG_, MB = MB_;
  static constexpr int RG = kPThreads / CG;
  static constexpr int BM = TM * RG;  // rows a tile
  static constexpr int TQ = QT * CG;  // quads a tile
  static constexpr int CW = CG < 4 ? CG : 4;
  static constexpr int kStage = BM * kPLD + kPK * 4 * TQ;  // floats
};
using PWide = PCfg<8, 2, 16, 1>;   // 128 rows x 32 quads
using PMid = PCfg<8, 1, 16, 2>;    // 128 x 16
using PNarrow = PCfg<8, 1, 8, 2>;  // 256 x 8
using POne = PCfg<1, 1, 1, 2>;     // 256 x 1

// The quads a tile takes for a layer of nq quads: the largest of 32, 16 and
// 8 that divides nq or whose last column tile is more than half busy, else
// 1. Tiles past the layer's end compute on zeros and store nothing.
int tile_quads(int nq) {
  const int tq[3] = {32, 16, 8};
  for (int t : tq)
    if (nq % t == 0 || nq % t > t / 2) return t;
  return 1;
}

// A thread's row and column groups in its tile.
struct PLane {
  int rg, cg;
};

template <class C>
__device__ __forceinline__ PLane plane() {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int WC = C::CG / C::CW;  // warps across the columns
  PLane t;
  t.cg = (warp % WC) * C::CW + lane % C::CW;
  t.rg = (warp / WC) * (32 / C::CW) + lane / C::CW;
  return t;
}

#ifndef GEOA3_EMU
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
#endif

// Slice k0 of A [M][lda] (rows row0 .. row0 + BM, k < K) into As
// [BM][kPLD], zeros outside: 16-byte copies where `vec` (lda, K and A's
// address multiples of 4), 4-byte ones else.
template <class C>
__device__ __forceinline__ void stage_rows(float* As, const float* A,
                                           long long lda, long long row0,
                                           long long M, int K, int k0,
                                           bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < C::BM * (kPK / 4); e += kPThreads) {
      const int r = e / (kPK / 4), k = k0 + 4 * (e % (kPK / 4));
      float* d = As + r * kPLD + (k - k0);
      if (row0 + r < M && k < K)
        cp_async16(d, A + (row0 + r) * lda + k);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    for (int e = threadIdx.x; e < C::BM * kPK; e += kPThreads) {
      const int r = e / kPK, k = k0 + e % kPK;
      float* d = As + r * kPLD + (k - k0);
      if (row0 + r < M && k < K)
        cp_async4(d, A + (row0 + r) * lda + k);
      else
        *d = 0.0f;
    }
  }
}

// acc[i][4q + j] = fmaf(A[row i][k], B[k][quad q, column j], acc) for the
// slice's nk steps of k, ascending (whole quads of k: the staged zeros past
// K leave a chain as it is). kFull: nk = kPK, no branch between the steps.
template <class C, bool kFull>
__device__ __forceinline__ void proj_fma(const float* As, const float* Bs,
                                         int nk, const PLane& t,
                                         float (&acc)[C::TM][4 * C::QT]) {
#pragma unroll
  for (int k4 = 0; k4 < kPK; k4 += 4) {
    if (!kFull && k4 >= nk) break;
    float a[C::TM][4];
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(
          As + (t.rg + C::RG * i) * kPLD + k4);
      a[i][0] = v.x;
      a[i][1] = v.y;
      a[i][2] = v.z;
      a[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float b[4 * C::QT];
#pragma unroll
      for (int q = 0; q < C::QT; ++q) {
        const float4 w = *reinterpret_cast<const float4*>(
            Bs + (k4 + kk) * 4 * C::TQ + 4 * (t.cg + C::CG * q));
        b[4 * q] = w.x;
        b[4 * q + 1] = w.y;
        b[4 * q + 2] = w.z;
        b[4 * q + 3] = w.w;
      }
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int j = 0; j < 4 * C::QT; ++j)
          acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
    }
  }
}

// The chains of one tile over K: rows row0 .. of A, weight slices staged by
// stage_w(Bs, k0) (kPK rows of the tile's 4 TQ columns, zeros outside),
// through the ring at smem[0 ..). One barrier a slice.
template <class C, class StageW>
__device__ __forceinline__ void proj_chains(const float* A, long long lda,
                                            long long row0, long long M,
                                            int K, bool vec, StageW stage_w,
                                            const PLane& t,
                                            float (&acc)[C::TM][4 * C::QT]) {
  extern __shared__ __align__(16) float smem[];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < 4 * C::QT; ++j) acc[i][j] = 0.0f;
  const int slices = (K + kPK - 1) / kPK;
  auto load = [&](int sl) {
    float* As = smem + (sl % kPStages) * C::kStage;
    stage_rows<C>(As, A, lda, row0, M, K, sl * kPK, vec);
    stage_w(As + C::BM * kPLD, sl * kPK);
  };
  for (int sl = 0; sl < kPStages - 1; ++sl) {
    if (sl < slices) load(sl);
    cp_async_commit();
  }
  for (int sl = 0; sl < slices; ++sl) {
    cp_async_wait<kPStages - 2>();
    __syncthreads();  // slice sl is whole; slice sl - 1's stage is free
    if (sl + kPStages - 1 < slices) load(sl + kPStages - 1);
    cp_async_commit();
    const float* As = smem + (sl % kPStages) * C::kStage;
    const int nk = K - sl * kPK < kPK ? K - sl * kPK : kPK;
    if (nk == kPK)
      proj_fma<C, true>(As, As + C::BM * kPLD, nk, t, acc);
    else
      proj_fma<C, false>(As, As + C::BM * kPLD, nk, t, acc);
  }
}

// P [rows, c1] = (x @ W1x) + (f @ W1f) (x [rows, 3], f [rows, cf]; cf = 0:
// x @ W1x alone) and Yc [crows, c1] = c @ W1x: the feats chain on the
// ring, each xyz chain (3 fmaf from 0) in the epilogue, added last. P's
// tiles first (column tiles fastest), then Yc's.
template <class C>
__global__ void __launch_bounds__(kPThreads, C::MB)
    project_kernel(const float* __restrict__ x, const float* __restrict__ f,
                   long long rows, int cf, const float* __restrict__ c,
                   long long crows, const float* __restrict__ w1, int c1,
                   float* __restrict__ P, float* __restrict__ Yc) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NC = 4 * C::TQ;
  const int ct = (c1 / 4 + C::TQ - 1) / C::TQ;
  const long long ptiles = (rows + C::BM - 1) / C::BM * ct;
  const bool isP = blockIdx.x < ptiles;
  const long long tile = isP ? blockIdx.x : blockIdx.x - ptiles;
  const long long row0 = tile / ct * C::BM;
  const int col0 = (int)(tile % ct) * NC;
  const float* in = isP ? x : c;
  const long long M = isP ? rows : crows;
  float* out = isP ? P : Yc;
  const PLane t = plane<C>();

  // the xyz rows [BM][3] and W1x's tile columns [3][NC] past the ring
  float* xs = smem + kPStages * C::kStage;
  float* wx = xs + 3 * C::BM;
  for (int e = threadIdx.x; e < 3 * C::BM; e += kPThreads)
    xs[e] = row0 * 3 + e < M * 3 ? __ldg(in + row0 * 3 + e) : 0.0f;
  for (int e = threadIdx.x; e < 3 * NC; e += kPThreads) {
    const int k = e / NC, col = col0 + e % NC;
    wx[e] = col < c1 ? __ldg(w1 + (size_t)k * c1 + col) : 0.0f;
  }

  float acc[C::TM][4 * C::QT];
  const int K = isP ? cf : 0;
  const float* wf = w1 + (size_t)3 * c1;
  proj_chains<C>(
      f, cf, row0, M, K,
      cf % 4 == 0 && reinterpret_cast<uintptr_t>(f) % 16 == 0,
      [&](float* Bs, int k0) {
        for (int e = threadIdx.x; e < kPK * C::TQ; e += kPThreads) {
          const int kk = e / C::TQ, col = col0 + 4 * (e % C::TQ);
          float* d = Bs + kk * NC + (col - col0);
          if (k0 + kk < K && col < c1)
            cp_async16(d, wf + (size_t)(k0 + kk) * c1 + col);
          else
            *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      },
      t, acc);
  __syncthreads();  // xs and wx (where K = 0 no slice barrier ran)
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int r = t.rg + C::RG * i;
    if (row0 + r >= M) continue;
    const float x0 = xs[3 * r], x1 = xs[3 * r + 1], x2 = xs[3 * r + 2];
#pragma unroll
    for (int q = 0; q < C::QT; ++q) {
      const int u = 4 * (t.cg + C::CG * q);
      if (col0 + u >= c1) continue;
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = fmaf(x0, wx[u + j], 0.0f);
        v = fmaf(x1, wx[NC + u + j], v);
        v = fmaf(x2, wx[2 * NC + u + j], v);
        o[j] = K > 0 ? __fadd_rn(v, acc[i][4 * q + j]) : v;
      }
      *reinterpret_cast<float4*>(out + (row0 + r) * c1 + col0 + u) =
          make_float4(o[0], o[1], o[2], o[3]);
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

// The chains of a back-projection tile: rows row0 .. of dv [M, c1] times
// the columns u0 .. u0 + 4 TQ of W1^T shifted by one (u = 0: zeros; u >= 1:
// W1's row u - 1, read as w1t's column u - 1 by 4-byte copies, so the
// quads past quad 0 start on dfeats' quads).
template <class C>
__device__ __forceinline__ void backproject_chains(
    const float* dv, long long row0, long long M, int c1, const float* w1t,
    int c0p, int u0, const PLane& t, float (&acc)[C::TM][4 * C::QT]) {
  constexpr int NC = 4 * C::TQ;
  proj_chains<C>(
      dv, c1, row0, M, c1, reinterpret_cast<uintptr_t>(dv) % 16 == 0,
      [&](float* Bs, int k0) {
        for (int e = threadIdx.x; e < kPK * NC; e += kPThreads) {
          const int kk = e / NC, u = u0 + e % NC;
          float* d = Bs + kk * NC + (u - u0);
          if (k0 + kk < c1 && u >= 1 && u <= c0p)
            cp_async4(d, w1t + (size_t)(k0 + kk) * c0p + (u - 1));
          else
            *d = 0.0f;
        }
      },
      t, acc);
}

// dfeats [rows, cf] = dv @ W1f^T in tiles of C (cf's quads, column tiles
// fastest; by float4 where dfeats' rows are 16-byte aligned), then dxyz
// [rows, 3] = dv @ W1x^T and dcentres [crows, 3] = dyc @ W1x^T in 1-quad
// tiles (quad 0: (0, x, y, z)). w1t [c1, c0p].
template <class C>
__global__ void __launch_bounds__(kPThreads, C::MB)
    backproject_kernel(const float* __restrict__ dv, long long rows,
                       const float* __restrict__ dyc, long long crows, int c1,
                       const float* __restrict__ w1t, int c0p, int cf,
                       float* __restrict__ dx, float* __restrict__ df,
                       float* __restrict__ dc) {
  const int ct = (cf + 4 * C::TQ - 1) / (4 * C::TQ);
  const long long ftiles = (rows + C::BM - 1) / C::BM * ct;
  if (blockIdx.x < ftiles) {
    const PLane t = plane<C>();
    const long long row0 = blockIdx.x / ct * C::BM;
    const int q0 = (int)(blockIdx.x % ct) * C::TQ;  // the tile's first quad
    float acc[C::TM][4 * C::QT];
    backproject_chains<C>(dv, row0, rows, c1, w1t, c0p, 4 + 4 * q0, t, acc);
    const bool vec = cf % 4 == 0 && reinterpret_cast<uintptr_t>(df) % 16 == 0;
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      const long long r = row0 + t.rg + C::RG * i;
      if (r >= rows) continue;
#pragma unroll
      for (int q = 0; q < C::QT; ++q) {
        const int col = 4 * (q0 + t.cg + C::CG * q);
        if (col >= cf) continue;
        float* o = df + r * cf + col;
        if (vec) {
          *reinterpret_cast<float4*>(o) = make_float4(
              acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
              acc[i][4 * q + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (col + j < cf) o[j] = acc[i][4 * q + j];
        }
      }
    }
    return;
  }
  const long long tile = blockIdx.x - ftiles;
  const long long ptiles = (rows + POne::BM - 1) / POne::BM;
  const bool isP = tile < ptiles;
  const long long row0 = (isP ? tile : tile - ptiles) * POne::BM;
  const long long M = isP ? rows : crows;
  const PLane t = plane<POne>();
  float acc[1][4];
  backproject_chains<POne>(isP ? dv : dyc, row0, M, c1, w1t, c0p, 0, t, acc);
  if (row0 + t.rg < M) {
    float* o = (isP ? dx : dc) + (row0 + t.rg) * 3;
    o[0] = acc[0][1];
    o[1] = acc[0][2];
    o[2] = acc[0][3];
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// A projection launch: quads and rows a tile, blocks, shared memory.
struct ProjPlan {
  int quads, rows;
  long long tiles;
  size_t smem;
};

// Calls f(C{}) with the tile of a layer of nq > 0 quads (tile_quads).
template <class F>
auto with_tile(int nq, F&& f) {
  switch (tile_quads(nq)) {
    case 32: return f(PWide{});
    case 16: return f(PMid{});
    case 8: return f(PNarrow{});
  }
  return f(POne{});
}

template <class C>
size_t ring_bytes() {
  return (size_t)kPStages * C::kStage * sizeof(float);
}

// P's tiles and Yc's over c1's quads; the ring and the xyz region.
template <class C>
ProjPlan project_plan(long long rows, long long crows, int c1) {
  const long long ct = (c1 / 4 + C::TQ - 1) / C::TQ;
  return {C::TQ, C::BM,
          ((rows + C::BM - 1) / C::BM + (crows + C::BM - 1) / C::BM) * ct,
          ring_bytes<C>() + (size_t)(3 * C::BM + 12 * C::TQ) * sizeof(float)};
}

// dfeats' tiles over cf's quads (none where cf = 0), then the 1-quad tiles
// of dxyz and dcentres; the wider of the two rings.
template <class C>
ProjPlan backproject_plan(long long rows, long long crows, int cf) {
  const long long ct = ((cf + 3) / 4 + C::TQ - 1) / C::TQ;
  const size_t own = ring_bytes<C>(), one = ring_bytes<POne>();
  return {C::TQ, C::BM,
          (rows + C::BM - 1) / C::BM * ct + (rows + POne::BM - 1) / POne::BM +
              (crows + POne::BM - 1) / POne::BM,
          own > one ? own : one};
}

ProjPlan project_plan(long long rows, long long crows, int c1) {
  return with_tile(c1 / 4, [&](auto c) {
    return project_plan<decltype(c)>(rows, crows, c1);
  });
}

ProjPlan backproject_plan(long long rows, long long crows, int cf) {
  return with_tile(cf > 0 ? (cf + 3) / 4 : 1, [&](auto c) {
    return backproject_plan<decltype(c)>(rows, crows, cf);
  });
}

template <class C>
int launch_project(const float* x, const float* f, long long rows, int cf,
                   const float* c, long long crows, const float* w1, int c1,
                   float* P, float* Yc, cudaStream_t s) {
  const ProjPlan p = project_plan<C>(rows, crows, c1);
  if (p.tiles == 0) return 0;
  cudaError_t e = allow_smem(project_kernel<C>, p.smem);
  if (e != cudaSuccess) return (int)e;
  project_kernel<C><<<(unsigned)p.tiles, kPThreads, p.smem, s>>>(
      x, f, rows, cf, c, crows, w1, c1, P, Yc);
  return (int)cudaGetLastError();
}

// P [rows, c1] from x [rows, 3] and f [rows, cf] (null where cf = 0), and
// Yc [crows, c1] from c [crows, 3]: one launch.
int project(const float* x, const float* f, long long rows, int cf,
            const float* c, long long crows, const float* w1, int c1,
            float* P, float* Yc, cudaStream_t s) {
  return with_tile(c1 / 4, [&](auto cfg) {
    return launch_project<decltype(cfg)>(x, f, rows, cf, c, crows, w1, c1, P,
                                         Yc, s);
  });
}

template <class C>
int launch_backproject(const float* dv, long long rows, const float* dyc,
                       long long crows, int c1, const float* w1t, int c0p,
                       int cf, float* dx, float* df, float* dc,
                       cudaStream_t s) {
  const ProjPlan p = backproject_plan<C>(rows, crows, cf);
  if (p.tiles == 0) return 0;
  cudaError_t e = allow_smem(backproject_kernel<C>, p.smem);
  if (e != cudaSuccess) return (int)e;
  backproject_kernel<C><<<(unsigned)p.tiles, kPThreads, p.smem, s>>>(
      dv, rows, dyc, crows, c1, w1t, c0p, cf, dx, df, dc);
  return (int)cudaGetLastError();
}

// dx [rows, 3] and df [rows, cf] (null where cf = 0) from dv [rows, c1],
// and dc [crows, 3] from dyc [crows, c1], by w1t [c1, c0p]: one launch.
int backproject(const float* dv, long long rows, const float* dyc,
                long long crows, int c1, const float* w1t, int c0p, int cf,
                float* dx, float* df, float* dc, cudaStream_t s) {
  return with_tile(cf > 0 ? (cf + 3) / 4 : 1, [&](auto cfg) {
    return launch_backproject<decltype(cfg)>(dv, rows, dyc, crows, c1, w1t,
                                             c0p, cf, dx, df, dc, s);
  });
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
  int e = project(xyz, feats, (long long)b * n, cf, centres, (long long)b * m,
                  w1, c1, P, Yc, s);
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
  return backproject(dP, (long long)b * n, dYc, (long long)b * m, c1, w1t,
                     sd.c0p, cf, dxyz, dfeats, dcentres, s);
}
