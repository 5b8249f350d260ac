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
// recompute run the same loop (run_tiles below), so they give bitwise the
// same activations whatever their tile heights, and `a3 == pooled` is exact.
//
// Both kernels are one schedule of layers on the FMA units (no tensor
// cores: those are other numerics), each layer an activation [K][R] in
// shared memory times a row-major weight [K][cout]:
//  - a tile is R = 256, 128, 64, 32 or 16 rows, transposed in shared memory
//    ([channel][row]): the forward takes the largest of 128, 64 and 32 whose
//    shared memory leaves room for two blocks an SM, else the largest of
//    those and 16 that fits (16 rows halve each weight's reuse and are taken
//    only where 32 do not fit); the backward, whose activations take two to
//    three times the forward's room, takes the largest of the five that fits
//    one block an SM, and may use all its registers (a taller tile wastes
//    fewer of a round's columns on the narrow layers and streams the weights
//    once for more rows);
//  - 256 threads, each with 8 rows x 8 columns of a layer's output (8 x 4
//    where the layer is narrower than a full round of columns, its width is
//    not a multiple of 8, or the tile is 16 rows): a k step is 64 FMAs for
//    two float4 activation reads and two float4 weight reads;
//  - each layer's weights stream through a ring of three cp.async stages of
//    16 rows x the round's columns (32 rows in the backward where its block
//    still fits: half the steps, ring waits and barriers a layer), so every
//    float fetched from L2 serves all R rows of the tile and the next
//    slices' copies overlap the FMAs; blocks are persistent (two an SM
//    where they fit) and the ring runs on across a block's layers and
//    tiles;
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
// columns, so dz3 is zero at them in the others: where ns >= 64, dz3 is kept
// as a hit bit a (row, column) and each group's share instead of [c3][R]
// floats (which lets the tile grow), and layer 4 leaves the ring: each
// thread runs over the columns its rows' bits mark, ascending, with w3t's
// rows read from L2 (sparse_layer). Where cf <= 1 the last layer is 4
// columns wide, and runs off the ring too (direct_layer).
//
// Bound on the H100: operations (2 * rows * (c0*c1 + c1*c2 + c2*c3) for the
// forward; for the backward the same recompute, plus 2 * c2 for each nonzero
// entry of dz3 and 2 * (c2*c1 + c1*c0) for each row that carries a
// cotangent, no weight gradients; against inputs and outputs of a few
// hundred MB at most).
#include <map>
#include <mutex>
#include <utility>

#include "group_mlp.cuh"

namespace {

struct Dims {
  long long rows;  // groups * ns
  int ns, cf, c0, c0p, c1, c2, c3;
};

constexpr int kThreads = 256;
constexpr int kBK = 16;     // weight rows a ring stage (the backward's: 2 kBK
                            // where its block still fits)
constexpr int kStages = 3;  // ring depth
constexpr int kMaxLayers = 6;

// The CPU emulation of this source (tests/cuda_emu/cuda_runtime.h, which
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
// activations it overwrites in place; the backward's dgx / dgf.
enum Epilogue { kRelu, kPool, kDz3, kMask, kWrite };

// What the backward runs off the ring after a layer's last round: nothing,
// layer 4 over the columns a thread's rows hold (sparse_layer), or the last
// layer where it is 4 columns wide (direct_layer).
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
// Where groups hold 64 rows or more, the backward's layer 4 (dz3 @ w3t)
// runs off the ring, `sparse`: dz3 is kept as `hits`, the offset (words) of
// a bitmap [c3 / 32][R] of the (row, column)s that hold their group's
// maximum, and `share`, the offset (floats) of each of the tile's groups'
// pooled cotangents split over their ties, [gpt][c3] (else both -1). Where
// the last layer is 4 columns wide, `direct` is that layer, run off the
// ring.
struct Plan {
  int P, psh, gpt, parts;
  long long groups, tiles;
  int bk;       // weight rows a ring stage, a step's depth of k
  int nl;       // layers on the ring
  int stage;    // floats of one ring stage
  int ring;     // offset (floats) of the ring in shared memory
  int hits, share;
  size_t smem;  // bytes
  Layer lay[kMaxLayers];
  Layer sparse, direct;
};

// The layers' weights, row-major [K][cout]: w1, w2, w3 and, for the
// backward, w3t [c3, c2], w2t [c2, c1], w1t [c1, c0p]; and the biases of the
// two layers whose epilogue the loop itself runs.
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

// Shared memory: region X (the input, then layer 2's activations at 0 and,
// where the backward's layer 4 runs on the ring, dz3 after them), region B
// (layer 1's activations), the ring, and where layer 4 runs off the ring
// its hit bits and cotangent shares. The backward's d2 and d1 overwrite a2
// and a1.
Plan make_plan(const Dims& d, int R, bool bwd, int bk) {
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
  // 8 rows of a group of ns hold the maximum of about 8 / ns of the
  // columns: past a quarter (ns < 64) the dense product on the ring wins
  const bool sparse = bwd && d.ns >= 64;
  const int top = bwd && !sparse ? d.c2 + d.c3 : d.c2;  // X past layer 2
  const int xa = d.c0p > top ? d.c0p : top;
  const int X = 0, B = xa * R, Z = d.c2 * R;
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
  int nc = 0;
  for (int L = 0; L < n; ++L) nc = p.lay[L].nc > nc ? p.lay[L].nc : nc;
  p.stage = bk * nc;
  p.ring = (xa + d.c1) * R;
  size_t end = (size_t)p.ring + (size_t)kStages * p.stage;
  p.hits = p.share = -1;
  if (sparse) {
    p.hits = (int)end;
    p.share = p.hits + (d.c3 + 31) / 32 * R;
    end = (size_t)p.share + (size_t)p.gpt * d.c3;
  }
  p.smem = end * sizeof(float);
  return p;
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

// Layer 1 or 2's epilogue: outT[col + j][row] = relu(acc + bias).
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

// A tile's input as X[channel][row] (x's 3 channels, then the features),
// 0 on rows past the groups or past a group's ns rows.
template <int R>
__device__ __forceinline__ void stage_input(float* X,
                                            const float* __restrict__ gx,
                                            const float* __restrict__ gf,
                                            const Dims& d, const Plan& p,
                                            long long gbase, int part,
                                            int vec4) {
  const int tid = threadIdx.x;
  for (int e = tid; e < 3 * R; e += kThreads) {
    const int k = e / R, rt = e - k * R;
    const long long grp = gbase + (rt >> p.psh);
    const int rr = part * p.P + (rt & (p.P - 1));
    X[k * R + rt] = grp < p.groups && rr < d.ns
                        ? __ldg(gx + (grp * d.ns + rr) * 3 + k)
                        : 0.0f;
  }
  if (vec4) {
    for (int e = tid; e < d.cf / 4 * R; e += kThreads) {
      const int k = e / R, rt = e - k * R;
      const long long grp = gbase + (rt >> p.psh);
      const int rr = part * p.P + (rt & (p.P - 1));
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (grp < p.groups && rr < d.ns)
        v = __ldg(reinterpret_cast<const float4*>(
            gf + (grp * d.ns + rr) * d.cf + 4 * k));
      float* o = X + (size_t)(3 + 4 * k) * R + rt;
      o[0] = v.x;
      o[R] = v.y;
      o[2 * R] = v.z;
      o[3 * R] = v.w;
    }
  } else {
    for (int e = tid; e < d.cf * R; e += kThreads) {
      const int k = e / R, rt = e - k * R;
      const long long grp = gbase + (rt >> p.psh);
      const int rr = part * p.P + (rt & (p.P - 1));
      X[(size_t)(3 + k) * R + rt] =
          grp < p.groups && rr < d.ns
              ? __ldg(gf + (grp * d.ns + rr) * d.cf + k)
              : 0.0f;
    }
  }
}

// The loop both kernels run (MB: blocks an SM the kernel is built for; BK:
// its plan's depth of k a step):
// steps layer by layer, round by round, slice by slice, then the block's
// next tile. Layers 1 and 2 store relu(acc + bias) in shared memory; every
// later layer's round ends in the kernel's own epilogue,
// epi(l, r, acc, col, ok, gbase, part) (ok: the thread's columns lie inside
// the layer), which every thread of the block calls at the same steps.
template <int R, int MB, bool BWD, int BK, class Epi>
__device__ __forceinline__ void run_tiles(const float* __restrict__ gx,
                                          const float* __restrict__ gf,
                                          const Weights& wt, const Dims& d,
                                          const Plan& p, int vec4, Epi&& epi) {
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
  int part = 0;
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
      stage_input<R>(smem, gx, gf, d, p, gbase, part, vec4);
      if (BWD && p.hits >= 0)
        for (int e = tid; e < (d.c3 + 31) / 32 * R; e += kThreads)
          reinterpret_cast<unsigned*>(smem)[p.hits + e] = 0u;
      __syncthreads();
    }
    const Layer& l = p.lay[L];
    const int k0 = sl * BK;
    const int nk = l.K - k0 < BK ? l.K - k0 : BK;
    const float* a = smem + l.in + (size_t)k0 * R;
    const float* w = ring + (size_t)stage * p.stage + ln.cg * l.cw;
    const int col = r * l.nc + ln.cg * l.cw;
    const bool ok = col < l.cout;
    // In the backward, threads whose columns lie past a layer's end (the
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

// 32- and 16-row tiles are taken only where two blocks do not fit an SM's
// shared memory, so they may use its registers alone.
template <int R>
__global__ void __launch_bounds__(kThreads, R <= 32 ? 1 : 2)
    group_mlp_fwd_tiles(const float* __restrict__ gx,
                        const float* __restrict__ gf, Weights wt,
                        const float* __restrict__ b3, Dims d, Plan p, int vec4,
                        float* __restrict__ pooled, int* __restrict__ cnt,
                        float* __restrict__ part_max,
                        int* __restrict__ part_cnt) {
  const Lane ln = lane<R>();
  const int lanes = p.P / 8 < R / 8 ? p.P / 8 : R / 8;  // lanes sharing a slot
  run_tiles<R, R <= 32 ? 1 : 2, false, kBK>(
      gx, gf, wt, d, p, vec4,
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
// maxima, and the sum of the counts of the parts that hold it.
__global__ void group_mlp_fwd_finish(const float* __restrict__ part_max,
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
  const bool in_groups = grp < p.groups;
  if (l.epi == kDz3) {
    // dz3: the pooled cotangent split over its ties, on the rows whose
    // recomputed a3 is the group's maximum (ReLU'(0) = 0): stored as
    // [c3][R] for the ring, or as hit bits and the group's share
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
  } else if (l.epi == kMask) {
    mask_store<R, CW>(acc, col, ln, smem + l.out);
  } else if (in_groups) {
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

// Layer 4 off the ring: d2 = dz3 @ w3t, each thread over the c3 columns
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
      gx, gf, wt, d, p, vec4,
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

Dims make_dims(int groups, int ns, int cf, int c1, int c2, int c3) {
  Dims d;
  d.rows = (long long)groups * ns;
  d.ns = ns;
  d.cf = cf;
  d.c0 = 3 + cf;
  d.c0p = (d.c0 + 3) / 4 * 4;
  d.c1 = c1;
  d.c2 = c2;
  d.c3 = c3;
  return d;
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

// A kernel's tile height: for the forward, the largest of 128, 64 and 32
// rows whose block leaves room for two an SM, else the largest of 128, 64,
// 32 and 16 that fits one; for the backward, the largest of 256, 128, 64, 32
// and 16 that fits one; else 0.
int tile_rows(const Dims& d, bool bwd) {
  const int heights[5] = {256, 128, 64, 32, 16};
  for (int i = 1; i < 4 && !bwd; ++i)
    if (make_plan(d, heights[i], bwd, kBK).smem <= geoa3::kSmemHalf)
      return heights[i];
  for (int i = bwd ? 0 : 1; i < 5; ++i)
    if (make_plan(d, heights[i], bwd, kBK).smem <= geoa3::kSmemMax)
      return heights[i];
  return 0;
}

// The backward's plan at R rows: steps 2 kBK deep where the block still
// fits (half the steps, ring waits and barriers a layer), else kBK.
Plan bwd_tile_plan(const Dims& d, int R) {
  if (R > 16) {
    const Plan p = make_plan(d, R, true, 2 * kBK);
    if (p.smem <= geoa3::kSmemMax) return p;
  }
  return make_plan(d, R, true, kBK);
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

// Whether the features can be read as float4s.
int vec4_ok(const Dims& d, const float* gf) {
  return d.cf % 4 == 0 && (reinterpret_cast<uintptr_t>(gf) & 15) == 0;
}

// The tiles, then, where groups are split, the finishing kernel.
template <int R>
int launch_fwd(const float* gx, const float* gf, const Weights& wt,
               const float* b3, const Dims& d, float* pooled, int* cnt,
               void* scratch, cudaStream_t s) {
  const Plan p = make_plan(d, R, false, kBK);
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

// 16-row tiles never fit steps 2 kBK deep.
template <int R>
int launch_bwd_rows(const float* gx, const float* gf, const Weights& wt,
                    const float* b3, const Dims& d, const float* pooled,
                    const int* cnt, const float* gout, float* dgx, float* dgf,
                    cudaStream_t s) {
  const Plan p = bwd_tile_plan(d, R);
  if (p.bk == kBK)
    return launch_bwd<R, kBK>(p, gx, gf, wt, b3, d, pooled, cnt, gout, dgx,
                              dgf, s);
  return launch_bwd<R, (R > 16 ? 2 * kBK : kBK)>(p, gx, gf, wt, b3, d, pooled,
                                               cnt, gout, dgx, dgf, s);
}

}  // namespace

// gx [groups*ns, 3], gf [groups*ns, cf] (null when cf == 0); w1 [3+cf, c1],
// w2 [c1, c2], w3 [c2, c3] row-major with their biases; pooled [groups, c3],
// cnt [groups, c3] (each maximum's number of ties); scratch: where the plan
// splits a group into parts = ceil(ns / R) > 1 (R the tile height,
// group_mlp_kernel.fwd_plan; at most ceil(ns / 16) parts), 2 * groups *
// parts * c3 four-byte words for their partials (else unused, may be null).
// Widths must be multiples of 4 and every weight pointer 16-byte aligned.
// Refused (cudaErrorInvalidConfiguration) where even a 16-row tile does not
// fit a block's shared memory: GroupAll's 256/512/1024 widths fit the
// forward up to cf = 1837, the backward up to cf = 1741.
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
  switch (tile_rows(d, false)) {
    case 128:
      return launch_fwd<128>(gx, gf, wt, b3, d, pooled, cnt, scratch, s);
    case 64:
      return launch_fwd<64>(gx, gf, wt, b3, d, pooled, cnt, scratch, s);
    case 32:
      return launch_fwd<32>(gx, gf, wt, b3, d, pooled, cnt, scratch, s);
    case 16:
      return launch_fwd<16>(gx, gf, wt, b3, d, pooled, cnt, scratch, s);
  }
  return (int)cudaErrorInvalidConfiguration;
}

// w1t [c1, c0p] (w1 transposed, its 3+cf columns zero-padded to a multiple
// of 4), w2t [c2, c1], w3t [c3, c2]; pooled and cnt from the forward; gout
// [groups, c3]; dgx [groups*ns, 3], dgf [groups*ns, cf] (null when cf == 0).
// Refused where even a 16-row tile does not fit (group_mlp_kernel.bwd_plan).
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
  switch (tile_rows(d, true)) {
    case 256:
      return launch_bwd_rows<256>(gx, gf, wt, b3, d, pooled, cnt, gout, dgx,
                                  dgf, s);
    case 128:
      return launch_bwd_rows<128>(gx, gf, wt, b3, d, pooled, cnt, gout, dgx,
                                  dgf, s);
    case 64:
      return launch_bwd_rows<64>(gx, gf, wt, b3, d, pooled, cnt, gout, dgx,
                                 dgf, s);
    case 32:
      return launch_bwd_rows<32>(gx, gf, wt, b3, d, pooled, cnt, gout, dgx,
                                 dgf, s);
    case 16:
      return launch_bwd_rows<16>(gx, gf, wt, b3, d, pooled, cnt, gout, dgx,
                                 dgf, s);
  }
  return (int)cudaErrorInvalidConfiguration;
}
