// The tile loop of the grouped-MLP kernels: group_mlp.cu's forward and
// backward (row 16) and sa_fused.cu's forward and backward (row 17) run it.
//
// A kernel is a schedule of layers on the FMA units (no tensor cores: those
// are other numerics), each layer an activation [K][R] in shared memory
// times a row-major weight [K][cout]:
//  - a tile is R = 256, 128, 64, 32 or 16 rows, transposed in shared memory
//    ([channel][row]);
//  - 256 threads, each with 8 rows x 8 columns of a layer's output (8 x 4
//    where the layer is narrower than a full round of columns, its width is
//    not a multiple of 8, or the tile is 16 rows): a k step is 64 FMAs for
//    two float4 activation reads and two float4 weight reads;
//  - each layer's weights stream through a ring of three cp.async stages of
//    bk rows x the round's columns (bk = 16, 32 where a block still fits, 8
//    where nothing else does), so every float fetched from L2 serves all R
//    rows of the tile and the next slices' copies overlap the FMAs; blocks
//    are persistent and the ring runs on across a block's layers and tiles;
//  - a tile holds whole groups, each padded to a slot of a power of two >= 8
//    rows, or one R-row part of a larger group.
// Every activation is one float32 fmaf chain from 0, k ascending, then
// + bias, then fmaxf(., 0), whatever the tile height, so a backward's
// recompute on this loop gives bitwise its forward's activations.
//
// A kernel hands the loop a staging hook, which fills shared memory with a
// tile's first activations (row 16: layer 1's input, whole or a slice of
// its channels at a time; row 17: layer 1's activations gathered from
// projected rows), and an epilogue for every layer's round that does not
// end in relu(acc + bias) stored in shared memory. Both forwards end in
// the same pool (fwd_tiles) and merge a split group's partials with the
// same finish (fwd_finish).
//
// Everything here lies in the translation unit's unnamed namespace (the CPU
// emulation of a source, tests/cuda_emu/cuda_runtime.h, declares the
// `smem` array a block-scope `extern __shared__` names there).
#pragma once

#include <map>
#include <mutex>
#include <utility>

#include "common.cuh"

namespace {

using geoa3::kSmemHalf;
using geoa3::kSmemMax;

constexpr int kThreads = 256;
constexpr int kBK = 16;     // weight rows a ring stage (2 kBK where a
                            // backward's block still fits, kBK / 2 where
                            // nothing else does)
constexpr int kStages = 3;  // ring depth
constexpr int kMaxLayers = 6;

// The CPU emulation of a source (tests/cuda_emu/cuda_runtime.h, which
// defines GEOA3_EMU) supplies cp.async as a synchronous copy.
#ifndef GEOA3_EMU
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
#endif

struct Dims {
  long long rows;  // groups * ns
  int ns, cf, c0, c0p, c1, c2, c3;
};

Dims make_dims(long long groups, int ns, int cf, int c1, int c2, int c3) {
  Dims d;
  d.rows = groups * ns;
  d.ns = ns;
  d.cf = cf;
  d.c0 = 3 + cf;
  d.c0p = (d.c0 + 3) / 4 * 4;
  d.c1 = c1;
  d.c2 = c2;
  d.c3 = c3;
  return d;
}

// Columns a thread takes in a layer of `cout` outputs with R-row tiles: 8
// where cout is a multiple of 8 wider than a round of 4-column threads (one
// round of 8 then does what would take two of 4), else 4 (a thread's columns
// never straddle the layer's end). A round covers 2048 / R column groups,
// R / 8 threads a column group. 16-row tiles always take 4: 8 would make a
// round 1024 columns and the three-stage ring 196,608 bytes; 4 keep it at
// 98,304, beside the widest inputs.
int tile_cw(int R, int cout) {
  return R > 16 && cout % 8 == 0 && cout > (2048 / R) * 4 ? 8 : 4;
}

// What a layer's rounds end in: relu(acc + bias) stored in shared memory;
// the forward's pool; the backward's dz3; the product masked by the
// activations it overwrites in place; the backward's dgx / dgf (row 16);
// dz1 scattered into dP and summed into dYc (row 17).
enum Epilogue { kRelu, kPool, kDz3, kMask, kWrite, kScatter };

// What a backward runs off the ring after a layer's last round: nothing,
// dz3 @ w3t over the columns a thread's rows hold (sparse_layer), or row
// 16's last layer where it is 4 columns wide (direct_layer).
enum Then { kNone, kSparse, kDirect };

// One layer of a tile's step schedule: `rounds` rounds of nc = 4 << sh
// columns, cw a thread, each round `slices` slices of bk rows of k. `in` and
// `out` are offsets (floats) into shared memory of the layer's input
// [K][R] and, where it stays there, its output [cout][R]; `w` indexes
// Weights::w; `epi` is an Epilogue, `then` a Then.
struct Layer {
  int K, cout, nc, sh, cw, slices, rounds, in, out, w, epi, then;
};

// How a call cuts its rows. A tile of R rows holds gpt whole groups, each
// in a slot of P = 1 << psh rows (ns padded to a power of two >= 8), or
// (ns > R) one of a group's `parts` parts of P = R rows. Passed as a kernel
// parameter, so the schedule sits in the constant bank.
// Where dz3 @ w3t runs off the ring, `sparse`: dz3 is kept as `hits`, the
// offset (words) of a bitmap [c3 / 32][R] of the (row, column)s that hold
// their group's maximum, and `share`, the offset (floats) of each of the
// tile's groups' pooled cotangents split over their ties, [gpt][c3] (else
// both -1). Where row 16's last layer is 4 columns wide, `direct` is that
// layer, run off the ring. `aux` is the offset (floats) of a kernel's own
// shared memory past the loop's (-1: none). kin > 0: shared memory holds
// kin of layer 1's K input channels at a time (a multiple of bk), the
// staging hook restaging the next ones at each slice boundary; 0: all K.
struct Plan {
  int P, psh, gpt, parts;
  long long groups, tiles;
  int bk;       // weight rows a ring stage, a step's depth of k
  int nl;       // layers on the ring
  int stage;    // floats of one ring stage
  int ring;     // offset (floats) of the ring in shared memory
  int hits, share, aux, kin;
  size_t smem;  // bytes
  Layer lay[kMaxLayers];
  Layer sparse, direct;
};

// The layers' weights, row-major [K][cout], in the order the plan's layers
// index them; and the biases of the layers whose epilogue the loop itself
// runs (kRelu), by layer.
struct Weights {
  const float* w[kMaxLayers];
  const float* b[2];
};

Layer make_layer(int R, int bk, int K, int cout, int in, int out, int w,
                 int epi) {
  Layer l;
  l.K = K;
  l.cout = cout;
  l.cw = tile_cw(R, cout);
  l.nc = (2048 / R) * l.cw;
  l.sh = 0;
  while ((4 << l.sh) < l.nc) ++l.sh;
  l.slices = (K + bk - 1) / bk;
  l.rounds = (cout + l.nc - 1) / l.nc;
  l.in = in;
  l.out = out;
  l.w = w;
  l.epi = epi;
  l.then = kNone;
  return l;
}

// A plan's tiling of groups of ns rows into R-row tiles, and its ring depth.
Plan tile_groups(const Dims& d, int R, int bk) {
  Plan p;
  p.bk = bk;
  p.groups = d.rows / d.ns;
  if (d.ns <= R) {
    p.P = 8;
    while (p.P < d.ns) p.P *= 2;
    p.gpt = R / p.P;
    p.parts = 1;
    p.tiles = (p.groups + p.gpt - 1) / p.gpt;
  } else {
    p.P = R;
    p.gpt = 1;
    p.parts = (d.ns + R - 1) / R;
    p.tiles = p.groups * p.parts;
  }
  p.psh = 0;
  while ((1 << p.psh) < p.P) ++p.psh;
  p.hits = p.share = p.aux = -1;
  p.kin = 0;
  return p;
}

// The ring (as wide as the plan's widest round) from offset `ring` (floats)
// on, then, where dz3 is hit bits (`sparse`), the bits and the shares; sets
// p.smem to the end of those plus `aux` floats of the kernel's own.
void place_ring(Plan& p, const Dims& d, int R, int ring, bool sparse,
                int aux) {
  int nc = 0;
  for (int L = 0; L < p.nl; ++L) nc = p.lay[L].nc > nc ? p.lay[L].nc : nc;
  p.stage = p.bk * nc;
  p.ring = ring;
  size_t end = (size_t)p.ring + (size_t)kStages * p.stage;
  if (sparse) {
    p.hits = (int)end;
    p.share = p.hits + (d.c3 + 31) / 32 * R;
    end = (size_t)p.share + (size_t)p.gpt * d.c3;
  }
  if (aux > 0) {
    p.aux = (int)end;
    end += aux;
  }
  p.smem = end * sizeof(float);
}

// How far a plan gives way to fit a block: 0 as its kernel's rule says; 1
// also with layer 1's input staged in slices of its channels (row 16); 2
// also with dz3 as hit bits at any ns; 3 also with ring stages kBK / 2 deep
// (16-row tiles only).
constexpr int kLevels = 4;

// A backward's plan: the tallest of 256, 128, 64, 32 and 16 rows whose
// plan at kBK fits one block an SM, at the lowest level that has one, with
// steps 2 kBK deep where that plan still fits (above 16 rows, below level
// 3); *R = 0 where none fits. fit(R, bk, level) makes a plan.
template <class Fit>
Plan pick_bwd(Fit fit, int* R) {
  const int heights[5] = {256, 128, 64, 32, 16};
  for (int level = 0; level < kLevels; ++level) {
    const int bk = level == 3 ? kBK / 2 : kBK;
    for (int i = level == 3 ? 4 : 0; i < 5; ++i) {
      const Plan p = fit(heights[i], bk, level);
      if (p.smem > kSmemMax) continue;
      *R = heights[i];
      if (level < 3 && heights[i] > 16) {
        const Plan q = fit(heights[i], 2 * kBK, level);
        if (q.smem <= kSmemMax) return q;
      }
      return p;
    }
  }
  *R = 0;
  return fit(16, kBK, 0);
}

// A forward's plan: the largest of 128, 64 and 32 rows whose block leaves
// room for two an SM, else the largest of 128, 64, 32 and 16 that fits one
// (16 rows halve each weight's reuse and are taken only where 32 do not
// fit), at the lowest of `levels` levels that has one; *R = 0 where none
// fits. fit(R, level, limit) makes a plan, fitting `limit` bytes where its
// level lets it.
template <class Fit>
Plan pick_fwd(Fit fit, int levels, int* R) {
  const int heights[4] = {128, 64, 32, 16};
  for (int level = 0; level < levels; ++level) {
    for (int i = 0; i < 3; ++i) {
      const Plan p = fit(heights[i], level, kSmemHalf);
      if (p.smem <= kSmemHalf) {
        *R = heights[i];
        return p;
      }
    }
    for (int i = 0; i < 4; ++i) {
      const Plan p = fit(heights[i], level, kSmemMax);
      if (p.smem <= kSmemMax) {
        *R = heights[i];
        return p;
      }
    }
  }
  *R = 0;
  return fit(16, 0, kSmemMax);
}

// acc[i][j] = fmaf(x[row i][k], w[k][j], acc[i][j]) for nk steps of k,
// ascending. a points at the tile's channel k0 ([k][R]); w at this thread's
// columns of the ring stage ([kk][nc]). acc rows 0..3 are tile rows
// off0 .. off0 + 3, rows 4..7 are off1 .. off1 + 3.
// NK > 0: a whole slice, unrolled fully where a block has the registers
// of a whole SM (MB = 1 block an SM), 4 steps at a time where two blocks
// share an SM (more spills past 128 registers a thread); NK == 0: nk steps.
template <int R, int MB, int CW, int NK>
__device__ __forceinline__ void tile_fma(const float* a, const float* w,
                                         int nk, int nc, int off0, int off1,
                                         float (&acc)[8][8]) {
  constexpr int kUnroll = NK == 0 ? 1 : MB == 1 ? NK : 4;
  const int n = NK > 0 ? NK : nk;
#pragma unroll(kUnroll)
  for (int kk = 0; kk < n; ++kk) {
    const float4 x0 = *reinterpret_cast<const float4*>(a + kk * R + off0);
    const float4 x1 = *reinterpret_cast<const float4*>(a + kk * R + off1);
    const float xr[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    float wr[8];
    const float4 v0 = *reinterpret_cast<const float4*>(w + kk * nc);
    wr[0] = v0.x;
    wr[1] = v0.y;
    wr[2] = v0.z;
    wr[3] = v0.w;
    if (CW == 8) {
      const float4 v1 = *reinterpret_cast<const float4*>(w + kk * nc + 4);
      wr[4] = v1.x;
      wr[5] = v1.y;
      wr[6] = v1.z;
      wr[7] = v1.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < CW; ++j) acc[i][j] = fmaf(xr[i], wr[j], acc[i][j]);
  }
}

template <int R, int MB, int CW, int BK>
__device__ __forceinline__ void tile_slice(const float* a, const float* w,
                                           int nk, int nc, int off0, int off1,
                                           float (&acc)[8][8]) {
  if (nk == BK)
    tile_fma<R, MB, CW, BK>(a, w, nk, nc, off0, off1, acc);
  else
    tile_fma<R, MB, CW, 0>(a, w, nk, nc, off0, off1, acc);
}

// An activation from its chain: + bias, rounded once, then the ReLU.
__device__ __forceinline__ float relu_bias(float acc, float b) {
  return fmaxf(__fadd_rn(acc, b), 0.0f);
}

// A kRelu layer's epilogue: outT[col + j][row] = relu(acc + bias).
template <int R, int CW>
__device__ __forceinline__ void relu_store(const float (&acc)[8][8],
                                           const float* __restrict__ bias,
                                           int col, int off0, int off1,
                                           float* outT) {
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    const float bj = __ldg(bias + col + j);
    float4 v0, v1;
    v0.x = relu_bias(acc[0][j], bj);
    v0.y = relu_bias(acc[1][j], bj);
    v0.z = relu_bias(acc[2][j], bj);
    v0.w = relu_bias(acc[3][j], bj);
    v1.x = relu_bias(acc[4][j], bj);
    v1.y = relu_bias(acc[5][j], bj);
    v1.z = relu_bias(acc[6][j], bj);
    v1.w = relu_bias(acc[7][j], bj);
    *reinterpret_cast<float4*>(outT + (size_t)(col + j) * R + off0) = v0;
    *reinterpret_cast<float4*>(outT + (size_t)(col + j) * R + off1) = v1;
  }
}

// A thread's place in the tile: its rows are 8 rg .. 8 rg + 7 (all in one
// slot), read as two float4 halves in an order that puts the 8 lanes of a
// quarter-warp on distinct bank groups (acc rows 0..3 at off0, 4..7 at
// off1); its columns are column group cg of each round.
struct Lane {
  int rg, cg, sw, off0, off1;
};

template <int R>
__device__ __forceinline__ Lane lane() {
  Lane t;
  t.rg = threadIdx.x % (R / 8);
  t.cg = threadIdx.x / (R / 8);
  t.sw = (t.rg >> 2) & 1;
  t.off0 = 8 * t.rg + 4 * t.sw;
  t.off1 = 8 * t.rg + 4 * (1 - t.sw);
  return t;
}

// Row i of a thread's acc, counted from its first row 8 rg.
__device__ __forceinline__ int acc_row(int i, int sw) {
  return i < 4 ? 4 * sw + i : 4 * (1 - sw) + (i - 4);
}

// The loop every kernel on it runs (MB: blocks an SM the kernel is built
// for; BK: its plan's depth of k a step):
// steps layer by layer, round by round, slice by slice, then the block's
// next tile. At each step, after the barrier that ends the step before,
// fill(L, r, sl, ka, gbase, part) may fill shared memory (it returns
// whether it did; it must at a tile's first step, where the loop has also
// cleared the hit bits), and the loop then waits for it at a barrier; ka is
// layer 1's step's first input channel counted from the staged slice's
// first (k0 where the input is whole), kept by a running count, not a
// remainder: a division on every step costs more than the FMAs of a short
// one. Layers of
// kRelu store relu(acc + bias) in shared memory; every other layer's round
// ends in the kernel's own epilogue, epi(l, r, acc, col, ok, gbase, part)
// (ok: the thread's columns lie inside the layer), which every thread of
// the block calls at the same steps.
template <int R, int MB, bool BWD, int BK, class Fill, class Epi>
__device__ __forceinline__ void run_tiles(const Weights& wt, const Plan& p,
                                          Fill&& fill, Epi&& epi) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem + p.ring;  // [kStages][p.stage]
  const int tid = threadIdx.x;
  const Lane ln = lane<R>();

  // (L, r, sl, t) is the step computed, the w-suffixed ones the step whose
  // weights are copied next (kStages - 1 ahead)
  int L = 0, r = 0, sl = 0, Lw = 0, rw = 0, slw = 0;
  long long t = blockIdx.x, tw = blockIdx.x;
  auto advance = [&](int& L_, int& r_, int& sl_, long long& t_) {
    if (++sl_ < p.lay[L_].slices) return;
    sl_ = 0;
    if (++r_ < p.lay[L_].rounds) return;
    r_ = 0;
    if (++L_ < p.nl) return;
    L_ = 0;
    t_ += gridDim.x;
  };
  // the weight slice of step (Lw, rw, slw) into ring stage `stage`
  auto load_w = [&](int stage) {
    const Layer& l = p.lay[Lw];
    const int k0 = slw * BK, col0 = rw * l.nc;
    const int rows = l.K - k0 < BK ? l.K - k0 : BK;
    const int cols = l.cout - col0 < l.nc ? l.cout - col0 : l.nc;
    const float* src = wt.w[l.w] + (size_t)k0 * l.cout + col0;
    float* dst = ring + (size_t)stage * p.stage;
    const int q4 = l.nc >> 2;
    for (int e = tid; e < rows << l.sh; e += kThreads) {
      const int kk = e >> l.sh, c = (e & (q4 - 1)) << 2;
      if (c < cols)
        cp_async16(dst + kk * l.nc + c, src + (size_t)kk * l.cout + c);
    }
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (tw < p.tiles) {
      load_w(st);
      advance(Lw, rw, slw, tw);
    }
    cp_async_commit();
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  int stage = 0, wstage = kStages - 1;
  long long gbase = 0;
  int part = 0, ka = 0;
  while (t < p.tiles) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (tw < p.tiles) {
      load_w(wstage);
      advance(Lw, rw, slw, tw);
    }
    cp_async_commit();
    wstage = wstage + 1 == kStages ? 0 : wstage + 1;
    if ((L | r | sl) == 0) {
      gbase = (t / p.parts) * p.gpt;
      part = (int)(t - (t / p.parts) * p.parts);
      if (BWD && p.hits >= 0)
        for (int e = tid; e < (p.sparse.K + 31) / 32 * R; e += kThreads)
          reinterpret_cast<unsigned*>(smem)[p.hits + e] = 0u;
    }
    const Layer& l = p.lay[L];
    ka = sl == 0 || ka + BK == p.kin ? 0 : ka + BK;
    if (fill(L, r, sl, ka, gbase, part)) __syncthreads();
    const int k0 = sl * BK;
    const int nk = l.K - k0 < BK ? l.K - k0 : BK;
    const float* a = smem + l.in + (size_t)(L == 0 ? ka : k0) * R;
    const float* w = ring + (size_t)stage * p.stage + ln.cg * l.cw;
    const int col = r * l.nc + ln.cg * l.cw;
    const bool ok = col < l.cout;
    // In a backward, threads whose columns lie past a layer's end (the
    // last round of a layer a few columns wider than the rounds before it,
    // as cf = 128's 132 after two rounds of 64) skip the FMAs and leave the
    // SM's issue slots to the others (the forward's tiles of two blocks an
    // SM measured faster without the branch).
    if ((!BWD || ok) && R > 16 && l.cw == 8)
      tile_slice<R, MB, 8, BK>(a, w, nk, l.nc, ln.off0, ln.off1, acc);
    else if (!BWD || ok)
      tile_slice<R, MB, 4, BK>(a, w, nk, l.nc, ln.off0, ln.off1, acc);
    stage = stage + 1 == kStages ? 0 : stage + 1;
    if (sl == l.slices - 1) {
      if (l.epi == kRelu) {
        if (ok && R > 16 && l.cw == 8)
          relu_store<R, 8>(acc, wt.b[L], col, ln.off0, ln.off1, smem + l.out);
        else if (ok)
          relu_store<R, 4>(acc, wt.b[L], col, ln.off0, ln.off1, smem + l.out);
      } else {
        epi(l, r, acc, col, ok, gbase, part);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    }
    advance(L, r, sl, t);
  }
  cp_async_wait<0>();
}

// The forward's layer 3 epilogue, the pool: each column's (maximum, tie
// count) over the thread's 8 rows (rows past the group's end count as -1,
// below every post-ReLU value), merged over the `lanes` lanes that share the
// slot by shuffles (the maximum of the maxima, the sum of the counts of the
// partials that hold it); the slot's first lane writes the group's result,
// or the part's partial where the group is split. Every lane of the warp
// calls it.
template <int CW>
__device__ __forceinline__ void fwd_pool(
    const float (&acc)[8][8], const float* __restrict__ b3, bool ok, int col,
    int c3, int rr0, int sw, int ns, int lanes, bool writer, long long grp,
    int parts, int part, float* __restrict__ pooled, int* __restrict__ cnt,
    float* __restrict__ part_max, int* __restrict__ part_cnt) {
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    const float bj = ok ? __ldg(b3 + col + j) : 0.0f;
    float m = -1.0f;
    int c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float v =
          rr0 + acc_row(i, sw) < ns ? relu_bias(acc[i][j], bj) : -1.0f;
      if (v > m) {
        m = v;
        c = 1;
      } else if (v == m) {
        ++c;
      }
    }
    for (int o = 1; o < lanes; o <<= 1) {
      const float om = __shfl_xor_sync(GEOA3_FULL_MASK, m, o);
      const int oc = __shfl_xor_sync(GEOA3_FULL_MASK, c, o);
      const float mx = fmaxf(m, om);
      c = (m == mx ? c : 0) + (om == mx ? oc : 0);
      m = mx;
    }
    if (ok && writer) {
      if (parts == 1) {
        pooled[grp * c3 + col + j] = m;
        cnt[grp * c3 + col + j] = c;
      } else {
        const size_t o = ((size_t)grp * parts + part) * c3 + col + j;
        part_max[o] = m;
        part_cnt[o] = c;
      }
    }
  }
}

// A forward on the loop (MB: two blocks an SM above 32 rows, where the
// kernel's __launch_bounds__ say so; 32- and 16-row tiles are taken only
// where two blocks do not fit an SM's shared memory, so they may use its
// registers alone): the plan's ring layers after the staging hook `fill`,
// the last one's rounds ending in fwd_pool. pooled, cnt [groups, c3];
// where the plan splits groups, each part's partials into part_max and
// part_cnt [groups, parts, c3] for fwd_finish.
template <int R, class Fill>
__device__ __forceinline__ void fwd_tiles(const Weights& wt, const Plan& p,
                                          const Dims& d,
                                          const float* __restrict__ b3,
                                          Fill&& fill,
                                          float* __restrict__ pooled,
                                          int* __restrict__ cnt,
                                          float* __restrict__ part_max,
                                          int* __restrict__ part_cnt) {
  const Lane ln = lane<R>();
  const int lanes = p.P / 8 < R / 8 ? p.P / 8 : R / 8;  // lanes sharing a slot
  run_tiles<R, R <= 32 ? 1 : 2, false, kBK>(
      wt, p, fill,
      [&](const Layer& l, int, const float(&acc)[8][8], int col, bool ok,
          long long gbase, int part) {
        const int rr0 = part * p.P + ((8 * ln.rg) & (p.P - 1));
        const long long grp = gbase + ((8 * ln.rg) >> p.psh);
        const bool writer = ln.rg % lanes == 0 && grp < p.groups;
        if (R > 16 && l.cw == 8)
          fwd_pool<8>(acc, b3, ok, col, d.c3, rr0, ln.sw, d.ns, lanes, writer,
                      grp, p.parts, part, pooled, cnt, part_max, part_cnt);
        else
          fwd_pool<4>(acc, b3, ok, col, d.c3, rr0, ln.sw, d.ns, lanes, writer,
                      grp, p.parts, part, pooled, cnt, part_max, part_cnt);
      });
}

// A split group's result from its parts' partials: the maximum of their
// maxima, and the sum of the counts of the parts that hold it. One thread
// an output of the n = groups * c3; each forward's finishing kernel (named
// for its row, so a profile tells them apart) is this body alone.
__device__ __forceinline__ void fwd_finish(const float* __restrict__ part_max,
                                           const int* __restrict__ part_cnt,
                                           long long n, int parts, int c3,
                                           float* __restrict__ pooled,
                                           int* __restrict__ cnt) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long g = i / c3;
  const size_t base = (size_t)g * parts * c3 + (size_t)(i - g * c3);
  float m = part_max[base];
  for (int q = 1; q < parts; ++q)
    m = fmaxf(m, part_max[base + (size_t)q * c3]);
  int k = 0;
  for (int q = 0; q < parts; ++q)
    if (part_max[base + (size_t)q * c3] == m)
      k += part_cnt[base + (size_t)q * c3];
  pooled[i] = m;
  cnt[i] = k;
}

// out[col + j][row] = acc where the activation there (which it overwrites)
// is > 0, else 0: d2 over a2, d1 over a1.
template <int R, int CW>
__device__ __forceinline__ void mask_store(const float (&acc)[8][8], int col,
                                           const Lane& ln, float* outT) {
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    float4* q0 =
        reinterpret_cast<float4*>(outT + (size_t)(col + j) * R + ln.off0);
    float4* q1 =
        reinterpret_cast<float4*>(outT + (size_t)(col + j) * R + ln.off1);
    const float4 a0 = *q0, a1 = *q1;
    *q0 = make_float4(a0.x > 0.0f ? acc[0][j] : 0.0f,
                      a0.y > 0.0f ? acc[1][j] : 0.0f,
                      a0.z > 0.0f ? acc[2][j] : 0.0f,
                      a0.w > 0.0f ? acc[3][j] : 0.0f);
    *q1 = make_float4(a1.x > 0.0f ? acc[4][j] : 0.0f,
                      a1.y > 0.0f ? acc[5][j] : 0.0f,
                      a1.z > 0.0f ? acc[6][j] : 0.0f,
                      a1.w > 0.0f ? acc[7][j] : 0.0f);
  }
}

// A backward's dz3 epilogue for a thread's 8 rows x CW columns (all inside
// the layer): the pooled cotangent split over its ties, on the rows whose
// recomputed a3 is the group's maximum (ReLU'(0) = 0), stored as [c3][R]
// for the ring, or as hit bits and the group's share. Rows outside their
// group (padded slot rows, rows past a split group's end or past the last
// group) carry none.
template <int R, int CW>
__device__ __forceinline__ void dz3_store(
    const Layer& l, const float (&acc)[8][8], int col, const Lane& ln,
    long long grp, int rr0, const Dims& d, const Plan& p,
    const float* __restrict__ b3, const float* __restrict__ pooled,
    const int* __restrict__ cnt, const float* __restrict__ gout,
    float* smem) {
  const bool in_groups = grp < p.groups;
  unsigned* bits = reinterpret_cast<unsigned*>(smem) + p.hits;
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    float m = -1.0f, share = 0.0f;
    if (in_groups) {
      const size_t o = (size_t)grp * d.c3 + col + j;
      m = __ldg(pooled + o);
      share = __ldg(gout + o) / (float)__ldg(cnt + o);
    }
    const float bj = __ldg(b3 + col + j);
    bool hit[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a3 = relu_bias(acc[i][j], bj);
      hit[i] = rr0 + acc_row(i, ln.sw) < d.ns && a3 > 0.0f && a3 == m;
    }
    if (p.hits < 0) {
      float* outT = smem + l.out + (size_t)(col + j) * R;
      *reinterpret_cast<float4*>(outT + ln.off0) =
          make_float4(hit[0] ? share : 0.0f, hit[1] ? share : 0.0f,
                      hit[2] ? share : 0.0f, hit[3] ? share : 0.0f);
      *reinterpret_cast<float4*>(outT + ln.off1) =
          make_float4(hit[4] ? share : 0.0f, hit[5] ? share : 0.0f,
                      hit[6] ? share : 0.0f, hit[7] ? share : 0.0f);
      continue;
    }
    // every thread of the group writes the same share
    if (in_groups) smem[p.share + ((8 * ln.rg) >> p.psh) * d.c3 + col + j] = share;
    unsigned* w = bits + ((col + j) >> 5) * R;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (hit[i])
        atomicOr(w + (i < 4 ? ln.off0 + i : ln.off1 + i - 4),
                 1u << ((col + j) & 31));
  }
}

// dz3 @ w3t off the ring: d2 = dz3 @ w3t, each thread over the c3 columns
// that some of its 8 rows hold (the hit bits of its rows; dz3 is 0 at them
// in every other column, so the sums are the full product's), ascending,
// with dz3 = the group's share on the rows whose bit is set, and w3t's rows
// read from L2, the next column's loaded before the current one's FMAs;
// then masked by a2 > 0 in place. 8 rows of a group of ns hold the maximum
// of about 8 c3 / ns columns.
template <int R, int CW>
__device__ __forceinline__ void sparse_layer(const Layer& l, const Dims& d,
                                             const Plan& p, const Lane& ln,
                                             const float* __restrict__ w3t,
                                             float* smem) {
  const int nw = (d.c3 + 31) / 32;
  const unsigned* bits = reinterpret_cast<const unsigned*>(smem) + p.hits;
  const float* share = smem + p.share + ((8 * ln.rg) >> p.psh) * d.c3;
  for (int r = 0; r < l.rounds; ++r) {
    const int col = r * l.nc + ln.cg * CW;
    if (col >= l.cout) continue;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    // the column of the next set bit of the thread's rows (or -1), and
    // which of its 8 rows hold it
    int wd = -1;
    uint4 w0 = make_uint4(0u, 0u, 0u, 0u), w1 = w0;
    unsigned any = 0u;
    auto next = [&](unsigned& rows) {
      while (any == 0u) {
        if (++wd >= nw) return -1;
        w0 = *reinterpret_cast<const uint4*>(bits + wd * R + ln.off0);
        w1 = *reinterpret_cast<const uint4*>(bits + wd * R + ln.off1);
        any = w0.x | w0.y | w0.z | w0.w | w1.x | w1.y | w1.z | w1.w;
      }
      const int b = __ffs(any) - 1;
      any &= any - 1u;
      rows = (w0.x >> b & 1u) | (w0.y >> b & 1u) << 1 | (w0.z >> b & 1u) << 2 |
             (w0.w >> b & 1u) << 3 | (w1.x >> b & 1u) << 4 |
             (w1.y >> b & 1u) << 5 | (w1.z >> b & 1u) << 6 |
             (w1.w >> b & 1u) << 7;
      return 32 * wd + b;
    };
    auto load = [&](int c, float4 (&v)[2]) {
      const float* wrow = w3t + (size_t)c * l.cout + col;
      v[0] = __ldg(reinterpret_cast<const float4*>(wrow));
      if (CW == 8) v[1] = __ldg(reinterpret_cast<const float4*>(wrow + 4));
    };
    float4 v[2], vn[2];
    v[1] = vn[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    unsigned rows = 0u, rows_n = 0u;
    int c = next(rows);
    if (c >= 0) load(c, v);
    while (c >= 0) {
      const int cn = next(rows_n);
      if (cn >= 0) load(cn, vn);
      const float s = share[c];
      const float wr[8] = {v[0].x, v[0].y, v[0].z, v[0].w,
                           v[1].x, v[1].y, v[1].z, v[1].w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = rows >> i & 1u ? s : 0.0f;
#pragma unroll
        for (int jj = 0; jj < CW; ++jj) acc[i][jj] = fmaf(x, wr[jj], acc[i][jj]);
      }
      c = cn;
      rows = rows_n;
      v[0] = vn[0];
      v[1] = vn[1];
    }
    mask_store<R, CW>(acc, col, ln, smem + l.out);
  }
}

// The card's SM count, read once.
int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    sms = v > 0 ? v : 1;
  }
  return sms;
}

// Persistent blocks: as many as the SMs hold at once (by the kernel's
// registers and shared memory), at most one a tile. The blocks an SM holds
// are read once for each (kernel, shared memory), as the SM count is.
template <class Kernel>
unsigned tile_grid(Kernel kernel, const Plan& p) {
  static std::mutex mu;
  static std::map<std::pair<const void*, size_t>, int> per_sm;
  int n;
  {
    std::lock_guard<std::mutex> hold(mu);
    int& seen = per_sm[{reinterpret_cast<const void*>(kernel), p.smem}];
    if (seen == 0) {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&seen, kernel, kThreads,
                                                    p.smem);
      seen = seen > 0 ? seen : 1;
    }
    n = seen;
  }
  const long long grid = (long long)n * num_sms();
  return (unsigned)(grid < p.tiles ? grid : p.tiles);
}

}  // namespace
