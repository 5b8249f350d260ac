// Three folded-BatchNorm affine+ReLU layers over grouped rows, then the
// maximum over each group's ns rows; and the backward with respect to the
// grouped inputs.
//
// Replaces geoa3_tpu/ops/pallas/group_mlp_kernel.py:_fwd_kernel and
// :_bwd_kernel (group_mlp_maxpool). Rows are the flattened [groups * ns]
// grouped points: gx [rows, 3] (centred coordinates), gf [rows, cf]
// (features, cf >= 0). Layer 1 is gx @ w1[:3] + gf @ w1[3:] + b1 (the two
// parts meet in shared memory, never in device memory), then two more
// affine+ReLU layers, then pooled[g, c] = max over the group's rows.
// The backward recomputes a tile's activations, gives each pooled cotangent
// to the rows that attain the maximum, split evenly among ties (ties are
// routine: an under-full ball repeats its first hit, and repeated rows have
// identical activations), takes ReLU'(0) = 0 at every layer, and returns
// the cotangents of gx and gf only (the victim is frozen).
//
// The TPU kernel keeps thousands of rows in VMEM and splits every float32
// product into three bf16 passes for the MXU. Here every activation is one
// float32 fmaf chain from 0, k ascending (x's 3 channels before the
// features), then + bias, then fmaxf(., 0): the forward and the backward's
// recompute run the same loop (run_tiles, tile_loop.cuh), so they give
// bitwise the same activations whatever their tile heights, and
// `a3 == pooled` is exact.
//
// Both kernels run tile_loop.cuh's schedule of layers:
//  - the forward takes the largest of 128, 64 and 32 rows whose shared
//    memory leaves room for two blocks an SM, else the largest of those and
//    16 that fits (16 rows halve each weight's reuse and are taken only
//    where 32 do not fit); the backward, whose activations take two to
//    three times the forward's room, takes the largest of 256..16 that fits
//    one block an SM, and may use all its registers (a taller tile wastes
//    fewer of a round's columns on the narrow layers and streams the weights
//    once for more rows);
//  - layer 1's input sits whole in shared memory where some tile height
//    takes it so; where none does (thousands of features), it is staged in
//    slices of kin channels, a whole number of ring steps each, the widest
//    that fit: at each slice boundary of layer 1 the block waits at a
//    barrier, restages the next channels and waits again, while the
//    accumulators stay in registers, so every activation is still one fmaf
//    chain from 0 with k ascending, bitwise the unsliced kernel's (where
//    layer 1 takes several rounds of columns, each round restages them);
//    the backward's layer 6 reads no input and does not change;
//  - a tile holds whole groups, each padded to a slot of a power of two >= 8
//    rows, or one R-row part of a larger group (GroupAll: 128 rows a cloud,
//    32 clouds), so a split group's clouds fill the card.
// The forward is three layers; its last epilogue is the pool: each thread
// reduces its 8 rows of a column to (maximum, tie count) in registers, the
// lanes of a slot merge by shuffles (the maximum of the maxima, the sum of
// the counts of the partials that hold it), and a split group's parts write
// partials to a scratch that a finishing kernel merges by the same exact
// rule, in no order that matters.
// The backward is six layers on the same loop: the three recomputes (w1,
// w2, w3), then dz3 @ w3t, d2 @ w2t and d1 @ w1t (the transposed copies the
// wrapper keeps). Its epilogues: layer 3's gives each row its dz3 (the
// pooled cotangent / tie count where a3 == pooled > 0 on a row inside its
// group, else 0); layers 4 and 5 mask the product by a2 > 0 and a1 > 0 and
// overwrite those activations in place (a thread reads them at exactly the
// (column, row)s it writes, and the product reads only the other buffer);
// layer 6 writes dgx and dgf. A row's cotangent depends only on its row and
// its group's pooled, cnt and cotangent, so a split group needs no merge.
// A thread's 8 rows hold the maximum of only about 8 c3 / ns of the c3
// columns, so dz3 is zero at them in the others: where ns >= 64 (or where
// nothing else fits), dz3 is kept as a hit bit a (row, column) and each
// group's share instead of [c3][R] floats (which lets the tile grow), and
// layer 4 leaves the ring: each thread runs over the columns its rows' bits
// mark, ascending, with w3t's rows read from L2 (sparse_layer). Where cf <=
// 1 the last layer is 4 columns wide, and runs off the ring too
// (direct_layer).
//
// Bound on the H100: operations (2 * rows * (c0*c1 + c1*c2 + c2*c3) for the
// forward; for the backward the same recompute, plus 2 * c2 for each nonzero
// entry of dz3 and 2 * (c2*c1 + c1*c0) for each row that carries a
// cotangent, no weight gradients; against inputs and outputs of a few
// hundred MB at most).
#include "tile_loop.cuh"

namespace {

// Channels [lo, hi) of a tile's layer-1 input (x's 3 channels, then the
// features) as X[channel - lo][row], 0 on rows past the groups or past a
// group's ns rows.
template <int R>
__device__ __forceinline__ void stage_input(float* X,
                                            const float* __restrict__ gx,
                                            const float* __restrict__ gf,
                                            const Dims& d, const Plan& p,
                                            long long gbase, int part,
                                            int vec4, int lo, int hi) {
  const int tid = threadIdx.x;
  const int x1 = hi < 3 ? hi : 3;
  for (int e = tid; e < (x1 > lo ? x1 - lo : 0) * R; e += kThreads) {
    const int k = e / R, rt = e - k * R;
    const long long grp = gbase + (rt >> p.psh);
    const int rr = part * p.P + (rt & (p.P - 1));
    X[k * R + rt] = grp < p.groups && rr < d.ns
                        ? __ldg(gx + (grp * d.ns + rr) * 3 + lo + k)
                        : 0.0f;
  }
  // the features f0 .. f1 - 1 that lie in the slice
  const int f0 = lo > 3 ? lo - 3 : 0, f1 = hi - 3 < d.cf ? hi - 3 : d.cf;
  if (f1 <= f0) return;
  if (vec4) {
    const int q0 = f0 >> 2, q1 = (f1 + 3) >> 2;  // their float4s
    for (int e = tid; e < (q1 - q0) * R; e += kThreads) {
      const int q = q0 + e / R, rt = e % R;
      const long long grp = gbase + (rt >> p.psh);
      const int rr = part * p.P + (rt & (p.P - 1));
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (grp < p.groups && rr < d.ns)
        v = __ldg(reinterpret_cast<const float4*>(
            gf + (grp * d.ns + rr) * d.cf + 4 * q));
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = 4 * q + j;
        if (f >= f0 && f < f1) X[(size_t)(3 + f - lo) * R + rt] = vs[j];
      }
    }
  } else {
    for (int e = tid; e < (f1 - f0) * R; e += kThreads) {
      const int f = f0 + e / R, rt = e % R;
      const long long grp = gbase + (rt >> p.psh);
      const int rr = part * p.P + (rt & (p.P - 1));
      X[(size_t)(3 + f - lo) * R + rt] =
          grp < p.groups && rr < d.ns
              ? __ldg(gf + (grp * d.ns + rr) * d.cf + f)
              : 0.0f;
    }
  }
}

// Both kernels' staging hook (run_tiles): layer 1's input at a tile's first
// step, or, where the plan stages it in slices of kin channels, each slice
// at the step of layer 1 that first reads it (ka == 0).
template <int R, int BK>
__device__ __forceinline__ bool stage_layer1(int L, int r, int sl, int ka,
                                             long long gbase, int part,
                                             const float* __restrict__ gx,
                                             const float* __restrict__ gf,
                                             const Dims& d, const Plan& p,
                                             int vec4) {
  extern __shared__ __align__(16) float smem[];
  if (L != 0 || (p.kin == 0 ? (r | sl) != 0 : ka != 0)) return false;
  const int lo = p.kin == 0 ? 0 : sl * BK;
  const int hi = p.kin == 0 || lo + p.kin > d.c0 ? d.c0 : lo + p.kin;
  stage_input<R>(smem, gx, gf, d, p, gbase, part, vec4, lo, hi);
  return true;
}

// The forward: tile_loop.cuh's fwd_tiles (its pool after layer 3) with
// layer 1's input staged by stage_layer1.
template <int R>
__global__ void __launch_bounds__(kThreads, R <= 32 ? 1 : 2)
    group_mlp_fwd_tiles(const float* __restrict__ gx,
                        const float* __restrict__ gf, Weights wt,
                        const float* __restrict__ b3, Dims d, Plan p, int vec4,
                        float* __restrict__ pooled, int* __restrict__ cnt,
                        float* __restrict__ part_max,
                        int* __restrict__ part_cnt) {
  fwd_tiles<R>(
      wt, p, d, b3,
      [&](int L, int r, int sl, int ka, long long gbase, int part) {
        return stage_layer1<R, kBK>(L, r, sl, ka, gbase, part, gx, gf, d, p,
                                    vec4);
      },
      pooled, cnt, part_max, part_cnt);
}

// Row 16's split groups from their parts' partials (tile_loop.cuh).
__global__ void group_mlp_fwd_finish(const float* __restrict__ part_max,
                                     const int* __restrict__ part_cnt,
                                     long long n, int parts, int c3,
                                     float* __restrict__ pooled,
                                     int* __restrict__ cnt) {
  fwd_finish(part_max, part_cnt, n, parts, c3, pooled, cnt);
}

// The backward's epilogues for a thread's 8 rows x CW columns (all inside
// the layer). Rows outside their group (padded slot rows, rows past a split
// group's end or past the last group) carry no cotangent and are never
// written.
template <int R, int CW>
__device__ __forceinline__ void bwd_epilogue(
    const Layer& l, const float (&acc)[8][8], int col, const Lane& ln,
    long long grp, int rr0, const Dims& d, const Plan& p,
    const float* __restrict__ b3, const float* __restrict__ pooled,
    const int* __restrict__ cnt, const float* __restrict__ gout,
    float* __restrict__ dgx, float* __restrict__ dgf, float* smem) {
  if (l.epi == kDz3) {
    dz3_store<R, CW>(l, acc, col, ln, grp, rr0, d, p, b3, pooled, cnt, gout,
                     smem);
  } else if (l.epi == kMask) {
    mask_store<R, CW>(acc, col, ln, smem + l.out);
  } else if (grp < p.groups) {
    // da0 = d1 @ w1t: columns 0..2 are gx's cotangent, 3 .. c0 - 1 gf's
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int rr = rr0 + acc_row(i, ln.sw);
      if (rr >= d.ns) continue;
      const long long row = grp * d.ns + rr;
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        const int c = col + j;
        if (c < 3)
          dgx[row * 3 + c] = acc[i][j];
        else if (c < d.c0)
          dgf[row * d.cf + (c - 3)] = acc[i][j];
      }
    }
  }
}

// The last layer off the ring where it is 4 columns wide (cf <= 1): dgx and
// dgf of the tile's R rows, each of the (row, column) outputs one fmaf chain
// over d1 [c1][R] and w1t (from L2), k ascending, spread over the threads
// (a ring round would keep one column group busy for c1 / 16 steps).
template <int R>
__device__ __forceinline__ void direct_layer(const Layer& l, const Dims& d,
                                             const Plan& p, long long gbase,
                                             int part,
                                             const float* __restrict__ w1t,
                                             float* __restrict__ dgx,
                                             float* __restrict__ dgf,
                                             const float* smem) {
  const float* d1 = smem + l.in;
  for (int o = threadIdx.x; o < d.c0 * R; o += kThreads) {
    const int c = o / R, rt = o - c * R;
    const long long grp = gbase + (rt >> p.psh);
    const int rr = part * p.P + (rt & (p.P - 1));
    if (grp >= p.groups || rr >= d.ns) continue;
    float acc = 0.0f;
    for (int k = 0; k < l.K; ++k)
      acc = fmaf(d1[k * R + rt], __ldg(w1t + k * l.cout + c), acc);
    const long long row = grp * d.ns + rr;
    if (c < 3)
      dgx[row * 3 + c] = acc;
    else
      dgf[row * d.cf + (c - 3)] = acc;
  }
}

// One block an SM: the tile is the tallest that fits, so the block may use
// the SM's registers alone. BK: the plan's depth of k a step.
template <int R, int BK>
__global__ void __launch_bounds__(kThreads, 1)
    group_mlp_bwd_tiles(const float* __restrict__ gx,
                        const float* __restrict__ gf, Weights wt,
                        const float* __restrict__ b3, Dims d, Plan p, int vec4,
                        const float* __restrict__ pooled,
                        const int* __restrict__ cnt,
                        const float* __restrict__ gout,
                        float* __restrict__ dgx, float* __restrict__ dgf) {
  extern __shared__ __align__(16) float smem[];
  const Lane ln = lane<R>();
  run_tiles<R, 1, true, BK>(
      wt, p,
      [&](int L, int r, int sl, int ka, long long gbase, int part) {
        return stage_layer1<R, BK>(L, r, sl, ka, gbase, part, gx, gf, d, p,
                                   vec4);
      },
      [&](const Layer& l, int r, const float(&acc)[8][8], int col, bool ok,
          long long gbase, int part) {
        const int rr0 = part * p.P + ((8 * ln.rg) & (p.P - 1));
        const long long grp = gbase + ((8 * ln.rg) >> p.psh);
        if (ok && R > 16 && l.cw == 8)
          bwd_epilogue<R, 8>(l, acc, col, ln, grp, rr0, d, p, b3, pooled, cnt,
                             gout, dgx, dgf, smem);
        else if (ok)
          bwd_epilogue<R, 4>(l, acc, col, ln, grp, rr0, d, p, b3, pooled, cnt,
                             gout, dgx, dgf, smem);
        if (l.then != kNone && r == l.rounds - 1) {
          __syncthreads();  // the layer's output (and hit bits) are whole
          if (l.then == kDirect)
            direct_layer<R>(p.direct, d, p, gbase, part, wt.w[5], dgx, dgf,
                            smem);
          else if (R > 16 && p.sparse.cw == 8)
            sparse_layer<R, 8>(p.sparse, d, p, ln, wt.w[3], smem);
          else
            sparse_layer<R, 4>(p.sparse, d, p, ln, wt.w[3], smem);
        }
      });
}

bool dims_ok(const Dims& d) {
  return d.ns > 0 && d.cf >= 0 && d.c1 > 0 && d.c2 > 0 && d.c3 > 0 &&
         d.c1 % 4 == 0 && d.c2 % 4 == 0 && d.c3 % 4 == 0;
}

// Channels of region X past layer 1: layer 2's activations and, where the
// backward's layer 4 runs on the ring, dz3 after them.
int x_top(const Dims& d, bool bwd, bool sparse) {
  return bwd && !sparse ? d.c2 + d.c3 : d.c2;
}

// Shared memory: region X (layer 1's input, whole or kin channels of it,
// then layer 2's activations at 0 and, where the backward's layer 4 runs on
// the ring, dz3 after them), region B (layer 1's activations), the ring,
// and where layer 4 runs off the ring (`sparse`) its hit bits and cotangent
// shares. The backward's d2 and d1 overwrite a2 and a1.
Plan make_plan(const Dims& d, int R, bool bwd, int bk, int kin, bool sparse) {
  Plan p = tile_groups(d, R, bk);
  const int top = x_top(d, bwd, sparse);
  const int held = kin > 0 ? kin : d.c0p;
  const int xa = held > top ? held : top;
  const int X = 0, B = xa * R, Z = d.c2 * R;
  p.kin = kin;
  int n = 0;
  p.lay[n++] = make_layer(R, bk, d.c0, d.c1, X, B, 0, kRelu);
  p.lay[n++] = make_layer(R, bk, d.c1, d.c2, B, X, 1, kRelu);
  if (!bwd) {
    p.lay[n++] = make_layer(R, bk, d.c2, d.c3, X, -1, 2, kPool);
  } else {
    const Layer l6 = make_layer(R, bk, d.c1, d.c0p, B, -1, 5, kWrite);
    p.lay[n] = make_layer(R, bk, d.c2, d.c3, X, sparse ? -1 : Z, 2, kDz3);
    if (sparse) {
      p.lay[n++].then = kSparse;
      p.sparse = make_layer(R, bk, d.c3, d.c2, -1, X, 3, kMask);
    } else {
      ++n;
      p.lay[n++] = make_layer(R, bk, d.c3, d.c2, Z, X, 3, kMask);
    }
    p.lay[n] = make_layer(R, bk, d.c2, d.c1, X, B, 4, kMask);
    if (d.c0p == 4) {
      p.lay[n].then = kDirect;
      p.direct = l6;
    }
    ++n;
    if (d.c0p != 4) p.lay[n++] = l6;
  }
  p.nl = n;
  place_ring(p, d, R, (xa + d.c1) * R, sparse, 0);
  return p;
}

// The plan at R rows and depth bk at a level (tile_loop.cuh's kLevels): dz3
// as hit bits where ns >= 64 or from level 2 on; layer 1's input whole at
// level 0 or where that fits `limit`, else in the widest slices (a multiple
// of bk channels) that fit it (a plan that does not fit where none does).
Plan fit_plan(const Dims& d, int R, bool bwd, int bk, int level,
              size_t limit) {
  const bool sparse = bwd && (d.ns >= 64 || level >= 2);
  const Plan whole = make_plan(d, R, bwd, bk, 0, sparse);
  if (level == 0 || whole.smem <= limit) return whole;
  const int top = x_top(d, bwd, sparse);
  const size_t rest =
      whole.smem - (size_t)(d.c0p > top ? d.c0p : top) * R * sizeof(float);
  if (rest >= limit) return whole;
  const int kin = (int)((limit - rest) / (R * sizeof(float))) / bk * bk;
  return kin < bk ? whole : make_plan(d, R, bwd, bk, kin, sparse);
}

// The forward's plan (tile_loop.cuh's pick_fwd over fit_plan): at level 0,
// else at level 1 (layer 1's input in slices).
Plan fwd_tile_plan(const Dims& d, int* R) {
  return pick_fwd(
      [&](int rows, int level, size_t limit) {
        return fit_plan(d, rows, false, kBK, level, limit);
      },
      2, R);
}

// The backward's plan (tile_loop.cuh's pick_bwd over fit_plan).
Plan bwd_tile_plan(const Dims& d, int* R) {
  return pick_bwd(
      [&](int rows, int bk, int level) {
        return fit_plan(d, rows, true, bk, level, kSmemMax);
      },
      R);
}

// Whether the features can be read as float4s.
int vec4_ok(const Dims& d, const float* gf) {
  return d.cf % 4 == 0 && (reinterpret_cast<uintptr_t>(gf) & 15) == 0;
}

// The tiles, then, where groups are split, the finishing kernel.
template <int R>
int launch_fwd(const Plan& p, const float* gx, const float* gf,
               const Weights& wt, const float* b3, const Dims& d,
               float* pooled, int* cnt, void* scratch, cudaStream_t s) {
  if (p.parts > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      group_mlp_fwd_tiles<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  float* part_max = static_cast<float*>(scratch);
  int* part_cnt = reinterpret_cast<int*>(
      part_max + (p.parts > 1 ? (size_t)p.groups * p.parts * d.c3 : 0));
  group_mlp_fwd_tiles<R><<<tile_grid(group_mlp_fwd_tiles<R>, p), kThreads,
                           p.smem, s>>>(
      gx, gf, wt, b3, d, p, vec4_ok(d, gf), pooled, cnt, part_max, part_cnt);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.parts == 1) return (int)e;
  const long long n = p.groups * d.c3;
  group_mlp_fwd_finish<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      part_max, part_cnt, n, p.parts, d.c3, pooled, cnt);
  return (int)cudaGetLastError();
}

template <int R, int BK>
int launch_bwd(const Plan& p, const float* gx, const float* gf,
               const Weights& wt, const float* b3, const Dims& d,
               const float* pooled, const int* cnt, const float* gout,
               float* dgx, float* dgf, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      group_mlp_bwd_tiles<R, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  group_mlp_bwd_tiles<R, BK><<<tile_grid(group_mlp_bwd_tiles<R, BK>, p),
                               kThreads, p.smem, s>>>(
      gx, gf, wt, b3, d, p, vec4_ok(d, gf), pooled, cnt, gout, dgx, dgf);
  return (int)cudaGetLastError();
}

// The plan's depth: 2 kBK or kBK above 16 rows, kBK or kBK / 2 at 16.
template <int R>
int launch_bwd_rows(const Plan& p, const float* gx, const float* gf,
                    const Weights& wt, const float* b3, const Dims& d,
                    const float* pooled, const int* cnt, const float* gout,
                    float* dgx, float* dgf, cudaStream_t s) {
  if (p.bk == kBK)
    return launch_bwd<R, kBK>(p, gx, gf, wt, b3, d, pooled, cnt, gout, dgx,
                              dgf, s);
  return launch_bwd<R, (R > 16 ? 2 * kBK : kBK / 2)>(
      p, gx, gf, wt, b3, d, pooled, cnt, gout, dgx, dgf, s);
}

}  // namespace

// gx [groups*ns, 3], gf [groups*ns, cf] (null when cf == 0); w1 [3+cf, c1],
// w2 [c1, c2], w3 [c2, c3] row-major with their biases; pooled [groups, c3],
// cnt [groups, c3] (each maximum's number of ties); scratch: where the plan
// splits a group into parts = ceil(ns / R) > 1 (R the tile height,
// group_mlp_kernel.fwd_plan; at most ceil(ns / 16) parts), 2 * groups *
// parts * c3 four-byte words for their partials (else unused, may be null).
// Widths must be multiples of 4 and every weight pointer 16-byte aligned.
// Refused (cudaErrorInvalidConfiguration) where even a 16-row tile with
// layer 1's input in 16-channel slices does not fit a block's shared
// memory: where c1 + max(c2, 16) > 2096.
extern "C" int geoa3_group_mlp_fwd(const float* gx, const float* gf,
                                   const float* w1, const float* b1,
                                   const float* w2, const float* b2,
                                   const float* w3, const float* b3, int groups,
                                   int ns, int cf, int c1, int c2, int c3,
                                   float* pooled, int* cnt, void* scratch,
                                   void* stream) {
  const Dims d = make_dims(groups, ns, cf, c1, c2, c3);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  if (d.rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Weights wt = {{w1, w2, w3, nullptr, nullptr, nullptr}, {b1, b2}};
  int R = 0;
  const Plan p = fwd_tile_plan(d, &R);
  switch (R) {
    case 128:
      return launch_fwd<128>(p, gx, gf, wt, b3, d, pooled, cnt, scratch, s);
    case 64:
      return launch_fwd<64>(p, gx, gf, wt, b3, d, pooled, cnt, scratch, s);
    case 32:
      return launch_fwd<32>(p, gx, gf, wt, b3, d, pooled, cnt, scratch, s);
    case 16:
      return launch_fwd<16>(p, gx, gf, wt, b3, d, pooled, cnt, scratch, s);
  }
  return (int)cudaErrorInvalidConfiguration;
}

// w1t [c1, c0p] (w1 transposed, its 3+cf columns zero-padded to a multiple
// of 4), w2t [c2, c1], w3t [c3, c2]; pooled and cnt from the forward; gout
// [groups, c3]; dgx [groups*ns, 3], dgf [groups*ns, cf] (null when cf == 0).
// Refused where even a 16-row tile with the input in 8-channel slices, hit
// bits and 8-row ring stages does not fit (group_mlp_kernel.bwd_plan).
extern "C" int geoa3_group_mlp_bwd(const float* gx, const float* gf,
                                   const float* w1, const float* b1,
                                   const float* w2, const float* b2,
                                   const float* w3, const float* b3,
                                   const float* w1t, const float* w2t,
                                   const float* w3t, const float* pooled,
                                   const int* cnt, const float* gout,
                                   int groups, int ns, int cf, int c1, int c2,
                                   int c3, float* dgx, float* dgf,
                                   void* stream) {
  const Dims d = make_dims(groups, ns, cf, c1, c2, c3);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  if (d.rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Weights wt = {{w1, w2, w3, w3t, w2t, w1t}, {b1, b2}};
  int R = 0;
  const Plan p = bwd_tile_plan(d, &R);
  switch (R) {
    case 256:
      return launch_bwd_rows<256>(p, gx, gf, wt, b3, d, pooled, cnt, gout,
                                  dgx, dgf, s);
    case 128:
      return launch_bwd_rows<128>(p, gx, gf, wt, b3, d, pooled, cnt, gout,
                                  dgx, dgf, s);
    case 64:
      return launch_bwd_rows<64>(p, gx, gf, wt, b3, d, pooled, cnt, gout, dgx,
                                 dgf, s);
    case 32:
      return launch_bwd_rows<32>(p, gx, gf, wt, b3, d, pooled, cnt, gout, dgx,
                                 dgf, s);
    case 16:
      return launch_bwd_rows<16>(p, gx, gf, wt, b3, d, pooled, cnt, gout, dgx,
                                 dgf, s);
  }
  return (int)cudaErrorInvalidConfiguration;
}
