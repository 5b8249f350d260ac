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
// recompute (group_mlp.cuh, shared with sa_fused.cu) give bitwise the same
// activations whatever their tile shapes, so `a3 == pooled` is exact.
//
// The forward (group_mlp_fwd_tiles) is laid out for the FMA units (no
// tensor cores: those are other numerics):
//  - a tile is R = 128, 64 or 32 rows (the largest whose buffers leave room
//    for two blocks an SM, else the largest that fits), transposed in shared
//    memory ([channel][row]); layer 2's output overwrites the input;
//  - 256 threads, each with 8 rows x 8 columns of a layer's output (8 x 4
//    where the layer is narrower than a full round of columns, or its width
//    is not a multiple of 8): a k step is
//    64 FMAs for two float4 activation reads and two float4 weight reads;
//  - each layer's weights stream through a ring of three cp.async stages of
//    16 rows x the round's columns, so every float fetched from L2 serves
//    all R rows of the tile and the next slices' copies overlap the FMAs;
//    blocks are persistent (two an SM where they fit) and the ring runs on
//    across a block's tiles;
//  - a tile holds whole groups, each padded to a slot of a power of two >= 8
//    rows, or one R-row part of a larger group. The pool runs on every
//    thread: each reduces its 8 rows of a column to (maximum, tie count) in
//    registers, and the lanes of a slot merge by shuffles (the maximum of the
//    maxima, the sum of the counts of the partials that hold it);
//  - a group larger than R rows (GroupAll: 128 rows a cloud, 32 clouds) is
//    split over ceil(ns / R) blocks, so its clouds fill the card; each part
//    writes a partial (maximum, count) to a scratch, and a finishing kernel
//    merges a group's partials by the same exact rule, in no order that
//    matters.
// The backward keeps its own tiles (group_mlp_bwd_kernel below): a block
// takes R = 64, 32 or 16 rows through all three layers with activations
// transposed in shared memory ([channel][row], so a thread reads its 4 rows
// as one float4), weights streamed from L2 as float4 rows and a 4x4 output
// tile a thread. 16-row tiles are taken only where 32 do not fit a block's
// shared memory: the backward of a 640-feature GroupAll with widths
// 256/512/1024 needs 159,040 bytes at 16 rows and 286,272 at 32.
//
// Bound on the H100: operations (2 * rows * (c0*c1 + c1*c2 + c2*c3) for the
// forward, twice that for the backward: the recompute and one dz @ w^T
// product a layer, no weight gradients; against inputs and outputs of a few
// hundred MB at most).
#include "group_mlp.cuh"

namespace {

using geoa3::BwdLayout;
using geoa3::Tile;

struct Dims {
  long long rows;  // groups * ns
  int ns, cf, c0, c0p, c1, c2, c3;
};

constexpr int kFwdThreads = 256;
constexpr int kBK = 16;     // weight rows a ring stage
constexpr int kStages = 3;  // ring depth

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

// Columns a thread takes in a layer of `cout` outputs with R-row tiles: 8,
// or 4 where 8 would leave threads of the round idle or where cout is not a
// multiple of 8 (a thread's columns never straddle the layer's end). A round
// covers 2048 / R column groups, R / 8 threads a column group.
int fwd_cw(int R, int cout) {
  return cout % 8 == 0 && cout >= (2048 / R) * 8 ? 8 : 4;
}

// One layer of a tile's step schedule: `rounds` rounds of nc = 4 << sh
// columns, cw a thread, each round `slices` 16-row slices of k.
struct FwdLayer {
  int K, cout, nc, sh, cw, slices, rounds;
};

// How a forward call cuts its rows. A tile of R rows holds gpt whole groups,
// each in a slot of P = 1 << psh rows (ns padded to a power of two >= 8), or
// (ns > R) one of a group's `parts` parts of P = R rows. Passed as a kernel
// parameter, so the schedule sits in the constant bank.
struct FwdPlan {
  int P, psh, gpt, parts;
  long long groups, tiles;
  int stage;    // floats of one ring stage
  size_t smem;  // bytes
  FwdLayer lay[3];
};

FwdPlan fwd_plan(const Dims& d, int R) {
  FwdPlan p;
  const int K[3] = {d.c0, d.c1, d.c2}, C[3] = {d.c1, d.c2, d.c3};
  int nc = 0;
  for (int L = 0; L < 3; ++L) {
    FwdLayer& l = p.lay[L];
    l.K = K[L];
    l.cout = C[L];
    l.cw = fwd_cw(R, C[L]);
    l.nc = (2048 / R) * l.cw;
    l.sh = 0;
    while ((4 << l.sh) < l.nc) ++l.sh;
    l.slices = (K[L] + kBK - 1) / kBK;
    l.rounds = (C[L] + l.nc - 1) / l.nc;
    if (l.nc > nc) nc = l.nc;
  }
  const int wa = d.c0p > d.c2 ? d.c0p : d.c2;
  p.stage = kBK * nc;
  p.smem =
      ((size_t)(wa + d.c1) * R + (size_t)kStages * p.stage) * sizeof(float);
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
  return p;
}

// acc[i][j] = fmaf(x[row i][k], w[k][j], acc[i][j]) for nk steps of k,
// ascending. a points at the tile's channel k0 ([k][R]); w at this thread's
// columns of the ring stage ([kk][nc]). acc rows 0..3 are tile rows
// off0 .. off0 + 3, rows 4..7 are off1 .. off1 + 3.
// NK > 0: a whole slice, unrolled fully where a block has the registers
// of a whole SM (32-row tiles, one block an SM), 4 steps at a time where two
// blocks share an SM (more spills past 128 registers a thread); NK == 0: nk
// steps.
template <int R, int CW, int NK>
__device__ __forceinline__ void fwd_fma(const float* a, const float* w,
                                        int nk, int nc, int off0, int off1,
                                        float (&acc)[8][8]) {
  constexpr int kUnroll = NK == 0 ? 1 : R == 32 ? NK : 4;
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

// Layer 1 or 2's epilogue: outT[col + j][row] = relu(acc + bias).
template <int R, int CW>
__device__ __forceinline__ void fwd_store(const float (&acc)[8][8],
                                          const float* __restrict__ bias,
                                          int col, int off0, int off1,
                                          float* outT) {
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    const float bj = __ldg(bias + col + j);
    float4 v0, v1;
    v0.x = fmaxf(__fadd_rn(acc[0][j], bj), 0.0f);
    v0.y = fmaxf(__fadd_rn(acc[1][j], bj), 0.0f);
    v0.z = fmaxf(__fadd_rn(acc[2][j], bj), 0.0f);
    v0.w = fmaxf(__fadd_rn(acc[3][j], bj), 0.0f);
    v1.x = fmaxf(__fadd_rn(acc[4][j], bj), 0.0f);
    v1.y = fmaxf(__fadd_rn(acc[5][j], bj), 0.0f);
    v1.z = fmaxf(__fadd_rn(acc[6][j], bj), 0.0f);
    v1.w = fmaxf(__fadd_rn(acc[7][j], bj), 0.0f);
    *reinterpret_cast<float4*>(outT + (size_t)(col + j) * R + off0) = v0;
    *reinterpret_cast<float4*>(outT + (size_t)(col + j) * R + off1) = v1;
  }
}

// Layer 3's epilogue, the pool: each column's (maximum, tie count) over the
// thread's 8 rows (rows past the group's end count as -1, below every
// post-ReLU value), merged over the `lanes` lanes that share the slot by
// shuffles (the maximum of the maxima, the sum of the counts of the partials
// that hold it); the slot's first lane writes the group's result, or the
// part's partial where the group is split. Every lane of the warp calls it.
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
      const int rl = i < 4 ? 4 * sw + i : 4 * (1 - sw) + (i - 4);
      const float v =
          rr0 + rl < ns ? fmaxf(__fadd_rn(acc[i][j], bj), 0.0f) : -1.0f;
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

template <int R, int CW>
__device__ __forceinline__ void fwd_slice(const float* a, const float* w,
                                          int nk, int nc, int off0, int off1,
                                          float (&acc)[8][8]) {
  if (nk == kBK)
    fwd_fma<R, CW, kBK>(a, w, nk, nc, off0, off1, acc);
  else
    fwd_fma<R, CW, 0>(a, w, nk, nc, off0, off1, acc);
}

// 32-row tiles are taken only where two blocks do not fit an SM's shared
// memory, so they may use its registers alone.
template <int R>
__global__ void __launch_bounds__(kFwdThreads, R == 32 ? 1 : 2)
    group_mlp_fwd_tiles(const float* __restrict__ gx,
                        const float* __restrict__ gf,
                        const float* __restrict__ w1,
                        const float* __restrict__ b1,
                        const float* __restrict__ w2,
                        const float* __restrict__ b2,
                        const float* __restrict__ w3,
                        const float* __restrict__ b3, Dims d, FwdPlan p,
                        int vec4, float* __restrict__ pooled,
                        int* __restrict__ cnt, float* __restrict__ part_max,
                        int* __restrict__ part_cnt) {
  constexpr int RG = R / 8;  // threads a column group
  extern __shared__ __align__(16) float smem[];
  const int wa = d.c0p > d.c2 ? d.c0p : d.c2;
  float* bufA = smem;                     // [wa][R]: the input, then layer 2
  float* bufB = bufA + (size_t)wa * R;    // [c1][R]: layer 1
  float* ring = bufB + (size_t)d.c1 * R;  // [kStages][p.stage]
  const int tid = threadIdx.x;
  const int rg = tid % RG, cg = tid / RG;
  // a thread's rows are 8 rg .. 8 rg + 7, read as two float4 halves in an
  // order that puts the 8 lanes of a quarter-warp on distinct bank groups
  const int sw = (rg >> 2) & 1;
  const int off0 = 8 * rg + 4 * sw, off1 = 8 * rg + 4 * (1 - sw);
  const int lanes = p.P / 8 < RG ? p.P / 8 : RG;  // lanes sharing a slot

  // steps run layer by layer, round by round, slice by slice, then the
  // block's next tile: (L, r, sl, t) is the step computed, the w-suffixed
  // ones the step whose weights are copied next (kStages - 1 ahead)
  int L = 0, r = 0, sl = 0, Lw = 0, rw = 0, slw = 0;
  long long t = blockIdx.x, tw = blockIdx.x;
  auto advance = [&](int& L_, int& r_, int& sl_, long long& t_) {
    if (++sl_ < p.lay[L_].slices) return;
    sl_ = 0;
    if (++r_ < p.lay[L_].rounds) return;
    r_ = 0;
    if (++L_ < 3) return;
    L_ = 0;
    t_ += gridDim.x;
  };
  // the weight slice of step (Lw, rw, slw) into ring stage `stage`
  auto load_w = [&](int stage) {
    const FwdLayer& l = p.lay[Lw];
    const int k0 = slw * kBK, col0 = rw * l.nc;
    const int rows = l.K - k0 < kBK ? l.K - k0 : kBK;
    const int cols = l.cout - col0 < l.nc ? l.cout - col0 : l.nc;
    const float* src = (Lw == 0 ? w1 : Lw == 1 ? w2 : w3) +
                       (size_t)k0 * l.cout + col0;
    float* dst = ring + (size_t)stage * p.stage;
    const int q4 = l.nc >> 2;
    for (int e = tid; e < rows << l.sh; e += kFwdThreads) {
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
      // a new tile: its input as bufA[channel][row], 0 on rows past the
      // groups
      gbase = (t / p.parts) * p.gpt;
      part = (int)(t - (t / p.parts) * p.parts);
      for (int e = tid; e < 3 * R; e += kFwdThreads) {
        const int k = e / R, rt = e - k * R;
        const long long grp = gbase + (rt >> p.psh);
        const int rr = part * p.P + (rt & (p.P - 1));
        bufA[k * R + rt] = grp < p.groups && rr < d.ns
                               ? __ldg(gx + (grp * d.ns + rr) * 3 + k)
                               : 0.0f;
      }
      if (vec4) {
        for (int e = tid; e < d.cf / 4 * R; e += kFwdThreads) {
          const int k = e / R, rt = e - k * R;
          const long long grp = gbase + (rt >> p.psh);
          const int rr = part * p.P + (rt & (p.P - 1));
          float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (grp < p.groups && rr < d.ns)
            v = __ldg(reinterpret_cast<const float4*>(
                gf + (grp * d.ns + rr) * d.cf + 4 * k));
          float* o = bufA + (size_t)(3 + 4 * k) * R + rt;
          o[0] = v.x;
          o[R] = v.y;
          o[2 * R] = v.z;
          o[3 * R] = v.w;
        }
      } else {
        for (int e = tid; e < d.cf * R; e += kFwdThreads) {
          const int k = e / R, rt = e - k * R;
          const long long grp = gbase + (rt >> p.psh);
          const int rr = part * p.P + (rt & (p.P - 1));
          bufA[(size_t)(3 + k) * R + rt] =
              grp < p.groups && rr < d.ns
                  ? __ldg(gf + (grp * d.ns + rr) * d.cf + k)
                  : 0.0f;
        }
      }
      __syncthreads();
    }
    const FwdLayer& l = p.lay[L];
    const int k0 = sl * kBK;
    const int nk = l.K - k0 < kBK ? l.K - k0 : kBK;
    const float* a = (L == 1 ? bufB : bufA) + (size_t)k0 * R;
    const float* w = ring + (size_t)stage * p.stage + cg * l.cw;
    if (l.cw == 8)
      fwd_slice<R, 8>(a, w, nk, l.nc, off0, off1, acc);
    else
      fwd_slice<R, 4>(a, w, nk, l.nc, off0, off1, acc);
    stage = stage + 1 == kStages ? 0 : stage + 1;
    if (sl == l.slices - 1) {
      const int col = r * l.nc + cg * l.cw;
      const bool ok = col < l.cout;
      if (L < 2) {
        float* outT = L == 0 ? bufB : bufA;
        const float* bias = L == 0 ? b1 : b2;
        if (ok && l.cw == 8)
          fwd_store<R, 8>(acc, bias, col, off0, off1, outT);
        else if (ok)
          fwd_store<R, 4>(acc, bias, col, off0, off1, outT);
      } else {
        const int rr0 = part * p.P + ((8 * rg) & (p.P - 1));
        const long long grp = gbase + ((8 * rg) >> p.psh);
        const bool writer = rg % lanes == 0 && grp < p.groups;
        if (l.cw == 8)
          fwd_pool<8>(acc, b3, ok, col, d.c3, rr0, sw, d.ns, lanes, writer,
                      grp, p.parts, part, pooled, cnt, part_max, part_cnt);
        else
          fwd_pool<4>(acc, b3, ok, col, d.c3, rr0, sw, d.ns, lanes, writer,
                      grp, p.parts, part, pooled, cnt, part_max, part_cnt);
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

template <int R>
__global__ void __launch_bounds__(Tile<R>::kThreads)
    group_mlp_bwd_kernel(const float* __restrict__ gx,
                         const float* __restrict__ gf, const float* w1,
                         const float* b1, const float* w2, const float* b2,
                         const float* w3, const float* b3, const float* w1t,
                         const float* w2t, const float* w3t,
                         const float* __restrict__ pooled,
                         const int* __restrict__ cnt,
                         const float* __restrict__ gout, Dims d, BwdLayout l,
                         float* __restrict__ dgx, float* __restrict__ dgf) {
  extern __shared__ __align__(16) float smem[];
  float* a0T = smem + l.a0;
  float* a1T = smem + l.a1;
  float* a2T = smem + l.a2;
  float* d1T = smem + l.d1;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  const long long row0 = (long long)blockIdx.x * R;
  const int nrows = (int)(d.rows - row0 < R ? d.rows - row0 : R);
  geoa3::load_input<R>(a0T, gx, gf, row0, nrows, d.cf);
  __syncthreads();
  geoa3::dense_relu<R>(a0T, d.c0, w1, d.c1, b1, a1T);
  __syncthreads();
  geoa3::dense_relu<R>(a1T, d.c1, w2, d.c2, b2, a2T);
  __syncthreads();
  geoa3::backward_to_dz1<R>(a1T, a2T, smem + l.d2, smem + l.ch, d1T, w2t, w3,
                            b3, w3t, d.c1, d.c2, d.c3, pooled, cnt, gout, row0,
                            nrows, d.ns);
  // da0 = dz1 @ w1t: columns 0..2 are gx's cotangent, the rest gf's
  float acc[4][4];
  for (int jx = tx * 4; jx < d.c0p; jx += 64) {
    geoa3::gemm_tile<R>(d1T, d.c1, w1t, d.c0p, jx, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      if (r >= nrows) continue;
      const long long row = row0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = jx + j;
        if (c < 3)
          dgx[row * 3 + c] = acc[i][j];
        else if (c < d.c0)
          dgf[row * d.cf + (c - 3)] = acc[i][j];
      }
    }
  }
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
int fwd_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    sms = v > 0 ? v : 1;
  }
  return sms;
}

// The forward's tile height: the largest of 128, 64 and 32 rows whose block
// leaves room for two an SM, else the largest that fits one, else 0.
int fwd_rows(const Dims& d) {
  const int heights[3] = {128, 64, 32};
  for (int R : heights)
    if (fwd_plan(d, R).smem <= geoa3::kSmemHalf) return R;
  for (int R : heights)
    if (fwd_plan(d, R).smem <= geoa3::kSmemMax) return R;
  return 0;
}

// Persistent blocks (as many as the SMs hold, at most one a tile), then,
// where groups are split, the finishing kernel.
template <int R>
int launch_fwd(const float* gx, const float* gf, const float* w1,
               const float* b1, const float* w2, const float* b2,
               const float* w3, const float* b3, const Dims& d, float* pooled,
               int* cnt, void* scratch, cudaStream_t s) {
  const FwdPlan p = fwd_plan(d, R);
  if (p.parts > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      group_mlp_fwd_tiles<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  long long grid = (p.smem <= geoa3::kSmemHalf ? 2 : 1) * (long long)fwd_sms();
  if (grid > p.tiles) grid = p.tiles;
  float* part_max = static_cast<float*>(scratch);
  int* part_cnt = reinterpret_cast<int*>(
      part_max + (p.parts > 1 ? (size_t)p.groups * p.parts * d.c3 : 0));
  const int vec4 =
      d.cf % 4 == 0 && (reinterpret_cast<uintptr_t>(gf) & 15) == 0;
  group_mlp_fwd_tiles<R><<<(unsigned)grid, kFwdThreads, p.smem, s>>>(
      gx, gf, w1, b1, w2, b2, w3, b3, d, p, vec4, pooled, cnt, part_max,
      part_cnt);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.parts == 1) return (int)e;
  const long long n = p.groups * d.c3;
  group_mlp_fwd_finish<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      part_max, part_cnt, n, p.parts, d.c3, pooled, cnt);
  return (int)cudaGetLastError();
}

template <int R>
int launch_bwd(const float* gx, const float* gf, const float* w1,
               const float* b1, const float* w2, const float* b2,
               const float* w3, const float* b3, const float* w1t,
               const float* w2t, const float* w3t, const float* pooled,
               const int* cnt, const float* gout, const Dims& d, float* dgx,
               float* dgf, cudaStream_t s) {
  const BwdLayout l = geoa3::bwd_layout<R>(d.c0p, d.c1, d.c2);
  const size_t smem = (size_t)l.total * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      group_mlp_bwd_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (d.rows + R - 1) / R;
  group_mlp_bwd_kernel<R><<<(unsigned)blocks, Tile<R>::kThreads, smem, s>>>(
      gx, gf, w1, b1, w2, b2, w3, b3, w1t, w2t, w3t, pooled, cnt, gout, d, l,
      dgx, dgf);
  return (int)cudaGetLastError();
}

size_t bwd_smem(int R, const Dims& d) {
  const BwdLayout l = R == 64   ? geoa3::bwd_layout<64>(d.c0p, d.c1, d.c2)
                      : R == 32 ? geoa3::bwd_layout<32>(d.c0p, d.c1, d.c2)
                                : geoa3::bwd_layout<16>(d.c0p, d.c1, d.c2);
  return (size_t)l.total * sizeof(float);
}

}  // namespace

// gx [groups*ns, 3], gf [groups*ns, cf] (null when cf == 0); w1 [3+cf, c1],
// w2 [c1, c2], w3 [c2, c3] row-major with their biases; pooled [groups, c3],
// cnt [groups, c3] (each maximum's number of ties); scratch: where ns > 32,
// 2 * groups * ceil(ns / 32) * c3 four-byte words for a split group's
// partials (else unused, may be null). Widths must be multiples of 4 and
// every weight pointer 16-byte aligned. Refused (cudaErrorInvalidConfiguration)
// where even a 32-row tile does not fit a block's shared memory; the
// backward's 16-row tiles take some shapes the forward refuses (GroupAll's
// 256/512/1024 widths fit the forward up to cf = 789, the backward up to
// cf = 1557).
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
  switch (fwd_rows(d)) {
    case 128:
      return launch_fwd<128>(gx, gf, w1, b1, w2, b2, w3, b3, d, pooled, cnt,
                             scratch, s);
    case 64:
      return launch_fwd<64>(gx, gf, w1, b1, w2, b2, w3, b3, d, pooled, cnt,
                            scratch, s);
    case 32:
      return launch_fwd<32>(gx, gf, w1, b1, w2, b2, w3, b3, d, pooled, cnt,
                            scratch, s);
  }
  return (int)cudaErrorInvalidConfiguration;
}

// w1t [c1, c0p] (w1 transposed, its 3+cf columns zero-padded to a multiple
// of 4), w2t [c2, c1], w3t [c3, c2]; pooled and cnt from the forward; gout
// [groups, c3]; dgx [groups*ns, 3], dgf [groups*ns, cf] (null when cf == 0).
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
  switch (geoa3::pick_rows(bwd_smem(64, d), bwd_smem(32, d), bwd_smem(16, d))) {
    case 64:
      return launch_bwd<64>(gx, gf, w1, b1, w2, b2, w3, b3, w1t, w2t, w3t,
                            pooled, cnt, gout, d, dgx, dgf, s);
    case 32:
      return launch_bwd<32>(gx, gf, w1, b1, w2, b2, w3, b3, w1t, w2t, w3t,
                            pooled, cnt, gout, d, dgx, dgf, s);
    case 16:
      return launch_bwd<16>(gx, gf, w1, b1, w2, b2, w3, b3, w1t, w2t, w3t,
                            pooled, cnt, gout, d, dgx, dgf, s);
  }
  return (int)cudaErrorInvalidConfiguration;
}
