// The grouped three-layer MLP with its max over nsample, and its input
// gradient, in the single-pass bf16 mode: the bf16 PointNet++ victims'
// grouped MLPs (--victim_dtype bfloat16), on Hopper's tensor cores.
//
// Replaces geoa3_tpu/ops/pallas/group_mlp_kernel.py:_fwd_kernel and
// _bwd_kernel with f32_exact=False (`_mm` / `_mm_t` at :46-100, the else
// branches at :139-145 and :206-213). Over a group's rows (every product of
// bf16 values exact, every sum float32):
//   z1 = (x W1x + f W1f) + b1,  a1 = bf16(relu(z1))   (x: the 3 coordinates)
//   z2 = a1 W2 + b2,            a2 = bf16(relu(z2))
//   z3 = a2 W3 + b3,            pooled = max over the rows of relu(z3),
//                               cnt = the rows that tie at it
// and for the pooled cotangent g:
//   dz3 = bf16(g / cnt) on the tied rows where z3 > 0, else 0
//   dz2 = bf16(dz3 W3^T) where z2 > 0,  dz1 = bf16(dz2 W2^T) where z1 > 0
//   dgx = dz1 W1x^T, dgf = dz1 W1f^T  (float32; the wrapper rounds to bf16)
// The weights come zero-padded (widths to multiples of 16, W1x's 3 rows to
// 16), with their transposes for the backward; the biases are float32.
//
// Bound on the H100: operations at 989 TFLOP/s of bf16 (SSG SA1 at b = 32
// is 26.2 GFLOP forward, 0.026 ms). The staged kernels (mma.sync, no
// wgmma, TMA or warp specialisation; the shapes past the streamed plan,
// below):
//  - a block owns a tile of 128, 64, 32 or 16 rows of whole groups (or one
//    part of a group larger than the tile: GroupAll) and runs the layers
//    back to back in shared memory: a1 and a2 are kept there as bf16 rows,
//    which loses nothing (the TPU kernel rounds them to bf16 before each
//    product); layer 1's input (x padded to 16 channels with zeros, then
//    the features) is streamed in 32-channel slices, so cf sets no limit;
//  - each layer is passes of 128 output columns; each pass streams the
//    weights' 32-row slices through two cp.async stages and runs
//    mma.sync.m16n8k16 (bf16 -> float32) from ldmatrix fragments, 8 warps
//    over the tile's rows and the pass's columns;
//  - the forward's last layer writes relu(z3) as float32 rows, one pass at
//    a time, from which one thread a (group, column) takes the maximum and
//    its tie count; a split group's parts write partials that a finishing
//    kernel merges;
//  - the staged backward (gmlp_bf16_bwd_tiles) recomputes the tile with the
//    forward's own code, so z1, z2, z3 and the ties are bitwise the
//    forward's (an output's value depends only on its row, its column and
//    the k order, not on the tile height), then runs dz3 W3^T, dz2 W2^T and
//    dz1 W1^T on the same loop, each ReLU mask read from a1 / a2 (zero
//    exactly where z <= 0, but for 0 < z < 2^-134, which bf16 rounds to 0)
//    and overwritten in place by the cotangent.
//
// The kernels with the weights resident (gmlp_bf16_fwd_resident,
// gmlp_bf16_bwd_resident) serve every shape whose weights fit in shared
// memory beside a tile of 16 rows or more (`res_plan`): the victims' SA1
// layers (SSG, and MSG's three scales) and SSG's SA2 (135 KB of weights
// beside 64-row tiles). Persistent blocks (as many as the SMs hold)
// walk the tiles; at its start a block bulk-copies (TMA, csrc/tma.cuh) W1,
// W2, W3 and the biases into shared memory once, a row a copy into rows
// padded by 8 (ldmatrix reads them without bank conflicts), and the
// backward's W^T products read the same rows by ldmatrix without .trans.
// While a tile computes, one thread bulk-copies the next tile's gx and gf
// rows (one copy each: a tile's rows are contiguous), and for the backward
// its groups' pooled, cotangent and cnt, into a landing buffer; a piece
// that does not start and end on 16-byte lines is read in place instead.
// Layer 1's input is spread from there into padded rows. Each product runs
// its whole K from shared memory with no barrier, on warp tiles fitted to
// its width (`pick_unit`), with one block barrier between layers; every
// epilogue is an inlined functor.
//  - The forward's pool stays in registers: layer 3's epilogue takes each
//    thread's maximum of relu(z3 + b3) and its ties over its rows of a
//    segment (the unit's rows where they lie in one group, else an m16
//    tile's), merges them over the 8 lanes that hold the same columns by
//    shuffles (lanes swap halves of their columns, so each shuffle carries
//    one that its receiver keeps) and writes one (maximum, ties) partial a
//    segment and column over a1, which is dead after layer 2. After one
//    barrier each (group, column) merges its group's partials, in any order
//    the same (the maximum is exact, counts add), and stores them as
//    16-byte stores (pooled and cnt of a tile's groups are contiguous).
//    Where groups do not lie on m16 tiles (ns % 16 != 0), the epilogue
//    writes each row's value and 8 lanes an entry merge its rows; a split
//    group's parts write pmax / pcnt for gmlp_bf16_fwd_finish, as the staged
//    forward does.
//  - The backward computes g / cnt once a (group, column) (the staged
//    kernel's division), so the dz3 epilogue reads shared memory only and
//    never divides; dgx and dgf are staged in shared memory and written as
//    16-byte stores of the tile's contiguous rows.
// The kernels with the weights streamed (gmlp_bf16_fwd_wgmma,
// gmlp_bf16_bwd_wgmma) serve the shapes past that where a1 and a2 of a
// 64-row tile (widths padded to 128) and layer 1's whole input [64][cf] fit
// beside a ring of two or more 32 KB stages, and, in the backward, c2 and
// c3 padded to 128 are at most 512 and 1024 (`wgmma_plan`): the GroupAll
// layers (widths 256/512/1024 at cf = 256 and 640: 1.45-1.6 MB of weights;
// up to cf = 976), up to widths 512/512/1024. The staged kernels above keep
// the rest: GroupAll's widths at cf >= 992, c1 + c2 (padded to 128) past
// 1152 at c3 = 1024 (widths of 1024 among them), and the backward at a
// wider c2 or c3 (tests/test_torch_group_mlp_bf16_emulated.py `KERNEL`
// names a shape of each). Bound: the
// weights cross L2 once for every tile (1.4-1.6 MB for 64 rows), so the
// design cuts round trips and bytes, not operations:
//  - a block of two consumer warpgroups owns 64 rows (wgmma's M), groups of
//    ns rounded up to 16 rows (padding rows are masked) or one part of a
//    group of more than 64 rows; the warpgroups split each product's
//    columns, wgmma m64nNk16 (N = 128 or 64 a warpgroup) with A from
//    registers (ldmatrix from a1 / a2 in shared memory, as above) and B the
//    weights in shared memory by descriptor;
//  - the weights come packed on the host (`fold_mlp_bf16`: kpf the
//    forward's layers 1-3, kpb the backward's W2^T and W1^T), each pass of
//    256 or 128 output columns as slabs of 32 KB in wgmma's K-major
//    no-swizzle layout, so a slab is one bulk copy (TMA) into a ring of 2-4
//    stages on mbarriers, issued by warpgroup 0 `stages` slabs ahead (its
//    state in shared memory); no block barrier between slabs, a named
//    barrier between layers; layer 1's input lands once a tile, one copy a
//    group, over a2;
//  - the forward splits layer 3's passes over two blocks a tile where the
//    tiles leave SMs idle (128 blocks at GroupAll); its pool stays in
//    registers (`lanes_pool` over each warp's 16 rows, which lie in one
//    group), merged a (group, column) over the warps in shared memory, a
//    split group's parts by gmlp_bf16_fwd_finish;
//  - the backward replays layers 1-3 with the forward's own passes, so z3
//    and the ties are bitwise the forward's; layer 3's epilogue marks dz3's
//    hits as bits (z3 > 0 at its group's maximum) and dz2 = dz3 W3^T is
//    summed from the hits (`w_dz2`: about one a (group, column) at GroupAll)
//    with W3^T's rows read through L2, in place of a dense pass over W3^T;
//    then dz2 W2^T and dz1 W1^T on wgmma.
// The sums of the staged and resident kernels: mma.sync from ldmatrix with
// each output's k16 steps ascending from 0, then + bias by __fadd_rn, so z,
// a1, a2, the maxima and the ties are bitwise the staged forward's, and dgx
// / dgf bitwise the staged backward's. The streamed kernels sum the same
// chains on wgmma (its rounding inside a k16 step may differ from
// mma.sync's on the card; in the CPU emulation both add k ascending, one
// fmaf a term), their dz2 by fmaf.
#include "mma_bf16.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

#include <math.h>

#include <algorithm>
#include <map>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int KS = 32;         // k rows of a weight stage (two mma k-steps)
constexpr int NCH = 128;       // output columns of a pass
constexpr int kLdW = NCH + 8;  // a weight stage's row, bf16
constexpr int kLdA = KS + 8;   // a streamed input stage's row, bf16
constexpr int kLdP = NCH + 4;  // the pool's float32 row

__host__ __device__ inline int pad16(int c) { return (c + 15) / 16 * 16; }

// a launch's shapes and plan
struct Shape {
  int groups, ns, cf, c1, c2, c3;  // the true widths
  int k1, c1p, c2p, c3p;           // 16 + cf and the widths padded to 16
  int rows, gpt, parts, tiles;     // tile height, groups a tile, parts a group
};

size_t stage_bytes(int rows) {
  return 2 * ((size_t)rows * kLdA + (size_t)KS * kLdW) * 2;
}

// a1, a2 (bf16 rows of the padded width + 8), the pool's float32 rows, the
// stages
size_t fwd_smem(int rows, int c1p, int c2p) {
  return (size_t)rows * (c1p + c2p + 16) * 2 + (size_t)rows * kLdP * 4 +
         stage_bytes(rows);
}

// a1, a2, dz3 (bf16 rows of the padded width + 8), the stages
size_t bwd_smem(int rows, int c1p, int c2p, int c3p) {
  return (size_t)rows * (c1p + c2p + c3p + 24) * 2 + stage_bytes(rows);
}

size_t plan_smem(const Shape& s, bool bwd, int rows) {
  return bwd ? bwd_smem(rows, s.c1p, s.c2p, s.c3p) : fwd_smem(rows, s.c1p, s.c2p);
}

// the largest of 128, 64 and 32 rows whose block leaves room for two an SM,
// else the largest of 128 .. 16 that fits one; false where none does
bool make_shape(Shape& s, int groups, int ns, int cf, int c1, int c2, int c3,
                bool bwd) {
  s = Shape{groups, ns, cf, c1, c2, c3, 16 + cf, pad16(c1), pad16(c2), pad16(c3),
            0, 0, 0, 0};
  const int heights[4] = {128, 64, 32, 16};
  for (int i = 0; i < 3 && !s.rows; ++i)
    if (plan_smem(s, bwd, heights[i]) <= geoa3::kSmemHalf) s.rows = heights[i];
  for (int i = 0; i < 4 && !s.rows; ++i)
    if (plan_smem(s, bwd, heights[i]) <= geoa3::kSmemMax) s.rows = heights[i];
  if (!s.rows) return false;
  if (ns > s.rows) {
    s.parts = (ns + s.rows - 1) / s.rows;
    s.gpt = 1;
    s.tiles = groups * s.parts;
  } else {
    s.parts = 1;
    s.gpt = s.rows / ns;
    s.tiles = (groups + s.gpt - 1) / s.gpt;
  }
  return true;
}

// a tile's rows: tile row r < nrows is row g0 * ns + slot0 + r of the
// grouped inputs, in group g0 + r / ns (g0 alone where a group is split)
struct Tile {
  int g0, ngroups, part, slot0, nrows;
};

__device__ __forceinline__ Tile tile_of(const Shape& s, int t) {
  Tile r;
  if (s.parts > 1) {
    r.g0 = t / s.parts;
    r.part = t % s.parts;
    r.slot0 = r.part * s.rows;
    r.nrows = min(s.rows, s.ns - r.slot0);
    r.ngroups = 1;
  } else {
    r.g0 = t * s.gpt;
    r.ngroups = min(s.gpt, s.groups - r.g0);
    r.part = 0;
    r.slot0 = 0;
    r.nrows = r.ngroups * s.ns;
  }
  return r;
}

// the warps over a tile of BM rows and a pass's NCH columns: WR along the
// rows (MI m16 tiles each), WC along the columns (NJ n8 tiles each)
template <int BM>
struct Geo {
  static constexpr int MI = BM >= 32 ? 2 : 1;
  static constexpr int WR = BM / (16 * MI);
  static constexpr int WC = 8 / WR;
  static constexpr int NJ = NCH / (8 * WC);
};

// rows [k0, k0 + KS) and columns [n0, n0 + NCH) of W [K][N] (bf16, N a
// multiple of 16) into a stage [KS][kLdW]; zeros past K or N
__device__ __forceinline__ void stage_w(uint16_t* ws, const uint16_t* __restrict__ W,
                                        int K, int N, int k0, int n0) {
  for (int i = threadIdx.x; i < KS * (NCH / 8); i += kThreads) {
    const int r = i / (NCH / 8), c = (i % (NCH / 8)) * 8;
    const bool ok = k0 + r < K && n0 + c < N;
    cp_async16z(ws + r * kLdW + c, ok ? W + (size_t)(k0 + r) * N + n0 + c : W,
                ok ? 16 : 0);
  }
}

// channels [k0, k0 + KS) of layer 1's input for the tile's rows into a
// stage [BM][kLdA]: channels 0-2 the coordinates, 3-15 zero, 16 + j the
// feature j; zeros past the tile's rows and past 16 + cf
template <int BM>
__device__ __forceinline__ void stage_in(uint16_t* as, const uint16_t* __restrict__ gx,
                                         const uint16_t* __restrict__ gf,
                                         const Shape& s, const Tile& t, int k0) {
  for (int i = threadIdx.x; i < BM * (KS / 8); i += kThreads) {
    const int r = i / (KS / 8), k = k0 + (i % (KS / 8)) * 8;
    uint16_t* dst = as + r * kLdA + (k - k0);
    const size_t row = (size_t)t.g0 * s.ns + t.slot0 + r;
    if (r >= t.nrows || k >= s.k1) {
      cp_async16z(dst, gx, 0);
    } else if (k == 0) {
      const uint16_t* p = gx + row * 3;
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(p[0] | (static_cast<uint32_t>(p[1]) << 16), p[2], 0u, 0u);
    } else if (k < 16) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    } else {
      cp_async16z(dst, gf + row * s.cf + (k - 16), 16);
    }
  }
}

// acc = A (the tile's rows, K channels) @ W[:, n0 : n0 + NCH]: A is a
// resident bf16 block (lda elements a row), or where A is null layer 1's
// input, streamed. Every output is the chain of mma k-steps from 0 in
// ascending k. Starts and ends on a barrier.
template <int BM>
__device__ void gemm_pass(float (&acc)[Geo<BM>::MI][Geo<BM>::NJ][4],
                          const uint16_t* __restrict__ W, int K, int N, int n0,
                          const uint16_t* A, int lda, const uint16_t* __restrict__ gx,
                          const uint16_t* __restrict__ gf, const Shape& s,
                          const Tile& t, uint16_t* ast, uint16_t* wst) {
  using G = Geo<BM>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (warp % G::WR) * 16 * G::MI;
  const int col0 = (warp / G::WR) * G::NJ * 8;
  const bool active = n0 + col0 < N;
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
    for (int j = 0; j < G::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;
  const int nk = (K + KS - 1) / KS;
  auto load = [&](int sl) {
    stage_w(wst + (sl & 1) * KS * kLdW, W, K, N, sl * KS, n0);
    if (A == nullptr) stage_in<BM>(ast + (sl & 1) * BM * kLdA, gx, gf, s, t, sl * KS);
    cp_async_commit();
  };
  load(0);
  for (int sl = 0; sl < nk; ++sl) {
    if (sl + 1 < nk) {
      load(sl + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slice sl is in
    if (active) {
      const uint16_t* ws = wst + (sl & 1) * KS * kLdW;
      const int kend = min(KS, K - sl * KS);
      for (int kk = 0; kk < kend; kk += 16) {
        uint32_t a[G::MI][4];
#pragma unroll
        for (int mi = 0; mi < G::MI; ++mi) {
          const int r = row0 + mi * 16 + (lane & 15), c = kk + (lane >> 4) * 8;
          ldmatrix_x4(a[mi], A != nullptr
                                 ? A + (size_t)r * lda + sl * KS + c
                                 : ast + (sl & 1) * BM * kLdA + r * kLdA + c);
        }
        uint32_t bf[G::NJ][2];
#pragma unroll
        for (int jj = 0; jj < G::NJ / 2; ++jj) {
          uint32_t r4[4];
          ldmatrix_x4_trans(r4, ws + (kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLdW +
                                    col0 + jj * 16 + (lane >> 4) * 8);
          bf[2 * jj][0] = r4[0];
          bf[2 * jj][1] = r4[1];
          bf[2 * jj + 1][0] = r4[2];
          bf[2 * jj + 1][1] = r4[3];
        }
#pragma unroll
        for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
          for (int j = 0; j < G::NJ; ++j)
            mma_m16n8k16_bf16(acc[mi][j], a[mi], bf[j][0], bf[j][1]);
      }
    }
    __syncthreads();  // the stage sl is free for slice sl + 2
  }
}

// f(tile row, column, value at the column, value at the next column) for
// each pair of this thread's accumulators: rows g and g + 8 of each m16
// tile, columns 2q and 2q + 1 of each n8 tile
template <int BM, class F>
__device__ __forceinline__ void each_pair(float (&acc)[Geo<BM>::MI][Geo<BM>::NJ][4],
                                          int n0, F f) {
  using G = Geo<BM>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (warp % G::WR) * 16 * G::MI;
  const int col0 = (warp / G::WR) * G::NJ * 8;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
    for (int j = 0; j < G::NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(row0 + mi * 16 + g + 8 * h, n0 + col0 + j * 8 + 2 * q,
          acc[mi][j][2 * h], acc[mi][j][2 * h + 1]);
}

// a1 or a2: bf16(relu(acc + bias)) into dst's columns below N
template <int BM>
__device__ __forceinline__ void relu_to(float (&acc)[Geo<BM>::MI][Geo<BM>::NJ][4],
                                        int n0, uint16_t* dst, int ld,
                                        const float* __restrict__ bias, int N) {
  each_pair<BM>(acc, n0, [&](int r, int c, float v0, float v1) {
    if (c >= N) return;
    *reinterpret_cast<uint32_t*>(dst + (size_t)r * ld + c) =
        cvt_rn_bf16x2(fmaxf(__fadd_rn(v0, bias[c]), 0.0f),
                      fmaxf(__fadd_rn(v1, bias[c + 1]), 0.0f));
  });
}

// layers 1 and 2 of the tile into a1 and a2
template <int BM>
__device__ void hidden_layers(float (&acc)[Geo<BM>::MI][Geo<BM>::NJ][4],
                              const uint16_t* gx, const uint16_t* gf,
                              const uint16_t* w1, const float* b1,
                              const uint16_t* w2, const float* b2, const Shape& s,
                              const Tile& t, uint16_t* a1, uint16_t* a2,
                              uint16_t* ast, uint16_t* wst) {
  for (int n0 = 0; n0 < s.c1p; n0 += NCH) {
    gemm_pass<BM>(acc, w1, s.k1, s.c1p, n0, nullptr, 0, gx, gf, s, t, ast, wst);
    relu_to<BM>(acc, n0, a1, s.c1p + 8, b1, s.c1p);
  }
  for (int n0 = 0; n0 < s.c2p; n0 += NCH) {
    gemm_pass<BM>(acc, w2, s.c1p, s.c2p, n0, a1, s.c1p + 8, gx, gf, s, t, ast, wst);
    relu_to<BM>(acc, n0, a2, s.c2p + 8, b2, s.c2p);
  }
}

template <int BM>
__global__ void __launch_bounds__(kThreads, 1)
gmlp_bf16_fwd_tiles(const uint16_t* __restrict__ gx, const uint16_t* __restrict__ gf,
                    const uint16_t* __restrict__ w1, const float* __restrict__ b1,
                    const uint16_t* __restrict__ w2, const float* __restrict__ b2,
                    const uint16_t* __restrict__ w3, const float* __restrict__ b3,
                    Shape s, float* __restrict__ pooled, int* __restrict__ cnt,
                    float* __restrict__ pmax, int* __restrict__ pcnt) {
  extern __shared__ __align__(16) float smem[];
  uint16_t* a1 = reinterpret_cast<uint16_t*>(smem);
  uint16_t* a2 = a1 + (size_t)BM * (s.c1p + 8);
  float* P = reinterpret_cast<float*>(a2 + (size_t)BM * (s.c2p + 8));
  uint16_t* ast = reinterpret_cast<uint16_t*>(P + BM * kLdP);
  uint16_t* wst = ast + 2 * BM * kLdA;
  const Tile t = tile_of(s, blockIdx.x);
  float acc[Geo<BM>::MI][Geo<BM>::NJ][4];
  hidden_layers<BM>(acc, gx, gf, w1, b1, w2, b2, s, t, a1, a2, ast, wst);
  for (int n0 = 0; n0 < s.c3p; n0 += NCH) {
    gemm_pass<BM>(acc, w3, s.c2p, s.c3p, n0, a2, s.c2p + 8, gx, gf, s, t, ast, wst);
    each_pair<BM>(acc, n0, [&](int r, int c, float v0, float v1) {
      if (c >= s.c3p) return;
      P[r * kLdP + c - n0] = fmaxf(__fadd_rn(v0, b3[c]), 0.0f);
      P[r * kLdP + c - n0 + 1] = fmaxf(__fadd_rn(v1, b3[c + 1]), 0.0f);
    });
    __syncthreads();  // the pass's relu(z3) is whole
    // one thread a (group, column): the maximum over the group's rows in
    // the tile and its tie count (the next pass writes P after barriers)
    for (int i = threadIdx.x; i < t.ngroups * NCH; i += kThreads) {
      const int gi = i / NCH, cc = i % NCH, c = n0 + cc;
      if (c >= s.c3) continue;
      const int r0 = s.parts > 1 ? 0 : gi * s.ns;
      const int r1 = s.parts > 1 ? t.nrows : r0 + s.ns;
      float m = -1.0f;  // below every relu output
      int k = 0;
      for (int r = r0; r < r1; ++r) {
        const float v = P[r * kLdP + cc];
        if (v > m) {
          m = v;
          k = 1;
        } else if (v == m) {
          ++k;
        }
      }
      const size_t g = (size_t)t.g0 + gi;
      if (s.parts > 1) {
        const size_t o = (g * s.parts + t.part) * s.c3 + c;
        pmax[o] = m;
        pcnt[o] = k;
      } else {
        pooled[g * s.c3 + c] = m;
        cnt[g * s.c3 + c] = k;
      }
    }
  }
}

// a split group's maximum and tie count from its parts' partials
__global__ void gmlp_bf16_fwd_finish(const float* __restrict__ pmax,
                                     const int* __restrict__ pcnt, int groups,
                                     int parts, int c3, float* __restrict__ pooled,
                                     int* __restrict__ cnt) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)groups * c3) return;
  const size_t g = i / c3, c = i % c3;
  float m = -1.0f;
  for (int p = 0; p < parts; ++p) m = fmaxf(m, pmax[(g * parts + p) * c3 + c]);
  int k = 0;
  for (int p = 0; p < parts; ++p) {
    const size_t o = (g * parts + p) * c3 + c;
    if (pmax[o] == m) k += pcnt[o];
  }
  pooled[i] = m;
  cnt[i] = k;
}

// in place: bf16(acc) where the ReLU mask (the bf16 activation there) is
// nonzero, else 0
template <int BM>
__device__ __forceinline__ void masked_to(float (&acc)[Geo<BM>::MI][Geo<BM>::NJ][4],
                                          int n0, uint16_t* act, int ld, int N) {
  each_pair<BM>(acc, n0, [&](int r, int c, float v0, float v1) {
    if (c >= N) return;
    uint32_t* p = reinterpret_cast<uint32_t*>(act + (size_t)r * ld + c);
    const uint32_t on = *p;
    *p = cvt_rn_bf16x2((on & 0x7fffu) ? v0 : 0.0f, (on & 0x7fff0000u) ? v1 : 0.0f);
  });
}

template <int BM>
__global__ void __launch_bounds__(kThreads, 1)
gmlp_bf16_bwd_tiles(const uint16_t* __restrict__ gx, const uint16_t* __restrict__ gf,
                    const uint16_t* __restrict__ w1, const float* __restrict__ b1,
                    const uint16_t* __restrict__ w2, const float* __restrict__ b2,
                    const uint16_t* __restrict__ w3, const float* __restrict__ b3,
                    const uint16_t* __restrict__ w1t, const uint16_t* __restrict__ w2t,
                    const uint16_t* __restrict__ w3t, const float* __restrict__ pooled,
                    const int* __restrict__ cnt, const float* __restrict__ gout,
                    Shape s, float* __restrict__ dgx, float* __restrict__ dgf) {
  extern __shared__ __align__(16) float smem[];
  uint16_t* a1 = reinterpret_cast<uint16_t*>(smem);
  uint16_t* a2 = a1 + (size_t)BM * (s.c1p + 8);
  uint16_t* d3 = a2 + (size_t)BM * (s.c2p + 8);
  uint16_t* ast = d3 + (size_t)BM * (s.c3p + 8);
  uint16_t* wst = ast + 2 * BM * kLdA;
  const Tile t = tile_of(s, blockIdx.x);
  float acc[Geo<BM>::MI][Geo<BM>::NJ][4];
  hidden_layers<BM>(acc, gx, gf, w1, b1, w2, b2, s, t, a1, a2, ast, wst);
  // layer 3 again: dz3 = bf16(g / cnt) on the rows tied at the maximum
  for (int n0 = 0; n0 < s.c3p; n0 += NCH) {
    gemm_pass<BM>(acc, w3, s.c2p, s.c3p, n0, a2, s.c2p + 8, gx, gf, s, t, ast, wst);
    each_pair<BM>(acc, n0, [&](int r, int c, float v0, float v1) {
      if (c >= s.c3p) return;
      float d[2] = {0.0f, 0.0f};
      const float v[2] = {v0, v1};
      if (r < t.nrows) {
        const size_t g = (size_t)t.g0 + (s.parts > 1 ? 0 : r / s.ns);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (c + e >= s.c3) continue;
          const size_t o = g * s.c3 + c + e;
          const float a3 = fmaxf(__fadd_rn(v[e], b3[c + e]), 0.0f);
          if (a3 > 0.0f && a3 == pooled[o]) d[e] = gout[o] / (float)cnt[o];
        }
      }
      *reinterpret_cast<uint32_t*>(d3 + (size_t)r * (s.c3p + 8) + c) =
          cvt_rn_bf16x2(d[0], d[1]);
    });
  }
  for (int n0 = 0; n0 < s.c2p; n0 += NCH) {  // dz2 over a2
    gemm_pass<BM>(acc, w3t, s.c3p, s.c2p, n0, d3, s.c3p + 8, gx, gf, s, t, ast, wst);
    masked_to<BM>(acc, n0, a2, s.c2p + 8, s.c2p);
  }
  for (int n0 = 0; n0 < s.c1p; n0 += NCH) {  // dz1 over a1
    gemm_pass<BM>(acc, w2t, s.c2p, s.c1p, n0, a2, s.c2p + 8, gx, gf, s, t, ast, wst);
    masked_to<BM>(acc, n0, a1, s.c1p + 8, s.c1p);
  }
  for (int n0 = 0; n0 < s.k1; n0 += NCH) {  // dgx, dgf
    gemm_pass<BM>(acc, w1t, s.c1p, s.k1, n0, a1, s.c1p + 8, gx, gf, s, t, ast, wst);
    each_pair<BM>(acc, n0, [&](int r, int c, float v0, float v1) {
      if (r >= t.nrows || c >= s.k1) return;
      const size_t row = (size_t)t.g0 * s.ns + t.slot0 + r;
      if (c >= 16) {
        *reinterpret_cast<float2*>(dgf + row * s.cf + c - 16) = make_float2(v0, v1);
      } else if (c < 3) {
        dgx[row * 3 + c] = v0;
        if (c + 1 < 3) dgx[row * 3 + c + 1] = v1;
      }
    });
  }
}

// ------------------------------------------- the kernels with resident weights

// warp tiles of a product: MI m16 tiles by NJ n8 tiles
constexpr int kUnits[5][2] = {{2, 6}, {2, 4}, {1, 4}, {2, 2}, {1, 2}};

// the warp tile of a rows x N product over the block's 8 warps: the least
// units a warp runs times a unit's cost a k-step (two cycles an mma, four
// an ldmatrix.x4), the first of kUnits on a tie
int pick_unit(int rows, int N) {
  int best = 4;
  long long best_cost = 1LL << 60;
  for (int i = 0; i < 5; ++i) {
    const int mi = kUnits[i][0], nj = kUnits[i][1];
    if (rows % (16 * mi) || N % (8 * nj)) continue;
    const int units = rows / (16 * mi) * (N / (8 * nj));
    const long long cost = (long long)((units + 7) / 8) * (2 * mi * nj + 4 * (mi + nj / 2));
    if (cost < best_cost) {
      best = i;
      best_cost = cost;
    }
  }
  return best;
}

int units_of(int unit, int rows, int N) {
  return rows / (16 * kUnits[unit][0]) * (N / (8 * kUnits[unit][1]));
}

size_t round16(size_t bytes) { return (bytes + 15) / 16 * 16; }

// The resident kernels' plan: the tile rows, each product's warp tile and
// the shared memory, as byte offsets: W1, W2, W3 as bf16 rows of the padded
// width + 8, the biases (float32), a1, a2, then U, the landing buffer and
// two mbarriers (the weights', the landing buffer's).
// The backward: U holds layer 1's input X [rows][k1 + 8], later dz3
// [rows][c3p + 8]; the landing buffer gx's rows, gf's rows, then pooled,
// the cotangent (overwritten by g / cnt) and cnt of the tile's groups, gd
// bytes each. The float32 dgf [rows][cf + 8] and dgx [rows][3] are staged
// over a2 and U, which are dead by then.
// The forward: U holds X, the landing buffer gx's and gf's rows; the pool's
// partials (`PoolInto`: [rows / 16][lp] maxima, then as many tie counts;
// where groups are off m16 tiles, [rows][lp] row values) lie over a1, dead
// after layer 2, whose region grows to hold them.
struct Res {
  int rows, gd, first6;  // first6: the warp that takes dgf's first unit
  int gmul;              // a tile row's group: (row * gmul) >> 16
  int seg, lp;           // the forward's rows a pool partial (1: a row's value), their row
  int unit[7];           // L1, L2, L3, dz3 W3^T, dz2 W2^T, dgx's and dgf's part of dz1 W1^T
  size_t w1, w2, w3, bias, a1, a2, u, land, bars, smem;
};

void res_layout(Res& r, const Shape& s, int rows, bool bwd) {
  const int gpt = s.ns > rows ? 1 : rows / s.ns;
  size_t o = 0;
  auto take = [&](size_t bytes) {
    const size_t at = o;
    o += round16(bytes);
    return at;
  };
  r.rows = rows;
  r.lp = s.c3p + 4;
  r.w1 = take((size_t)s.k1 * (s.c1p + 8) * 2);
  r.w2 = take((size_t)s.c1p * (s.c2p + 8) * 2);
  r.w3 = take((size_t)s.c2p * (s.c3p + 8) * 2);
  r.bias = take((size_t)(s.c1p + s.c2p + s.c3p) * 4);
  const size_t a1 = (size_t)rows * (s.c1p + 8) * 2, a2 = (size_t)rows * (s.c2p + 8) * 2;
  const size_t x = (size_t)rows * (s.k1 + 8) * 2;
  if (bwd) {
    r.a1 = take(a1);
    size_t u = std::max(x, (size_t)rows * (s.c3p + 8) * 2);
    const size_t out = (size_t)rows * 12 + (s.cf ? (size_t)rows * (s.cf + 8) * 4 : 0);
    if (out > a2 + u) u = out - a2;
    r.a2 = take(a2);
    r.u = take(u);
    r.gd = (int)round16((size_t)gpt * s.c3 * 4);
    r.land = take((size_t)rows * 6 + (size_t)rows * s.cf * 2 + 3 * (size_t)r.gd);
  } else {
    const size_t pool = s.ns > rows || s.ns % 16 == 0 ? (size_t)rows / 16 * r.lp * 8
                                                      : (size_t)rows * r.lp * 4;
    r.a1 = take(std::max(a1, pool));
    r.a2 = take(a2);
    r.u = take(x);
    r.land = take((size_t)rows * 6 + (size_t)rows * s.cf * 2);
  }
  r.bars = take(16);
  r.smem = o;
}

// the largest of 128, 64 and 32 rows whose block leaves room for two an SM,
// else the largest of 128 .. 16 that fits one (make_shape's rule); false
// where none does (the weights alone are too large)
bool res_plan(Shape& s, Res& r, int groups, int ns, int cf, int c1, int c2, int c3,
              bool bwd) {
  s = Shape{groups, ns, cf, c1, c2, c3, 16 + cf, pad16(c1), pad16(c2), pad16(c3),
            0, 0, 0, 0};
  r = Res{};
  const int heights[4] = {128, 64, 32, 16};
  for (int pass = 0; pass < 2 && !s.rows; ++pass)
    for (int i = 0; i < (pass ? 4 : 3) && !s.rows; ++i) {
      res_layout(r, s, heights[i], bwd);
      if (r.smem <= (pass ? geoa3::kSmemMax : geoa3::kSmemHalf)) s.rows = heights[i];
    }
  if (!s.rows) return false;
  if (ns > s.rows) {
    s.parts = (ns + s.rows - 1) / s.rows;
    s.gpt = 1;
    s.tiles = groups * s.parts;
  } else {
    s.parts = 1;
    s.gpt = s.rows / ns;
    s.tiles = (groups + s.gpt - 1) / s.gpt;
  }
  if (!bwd) {
    const int widths[3] = {s.c1p, s.c2p, s.c3p};
    for (int i = 0; i < 3; ++i) r.unit[i] = pick_unit(s.rows, widths[i]);
    // a segment: a unit's rows of layer 3 where they lie in one group, else
    // an m16 tile's (groups on m16 tiles), else a row
    const int mi = kUnits[r.unit[2]][0];
    r.seg = s.parts > 1 || ns % (16 * mi) == 0 ? 16 * mi : ns % 16 == 0 ? 16 : 1;
    return true;
  }
  const int widths[7] = {s.c1p, s.c2p, s.c3p, s.c2p, s.c1p, 16, cf};
  for (int i = 0; i < 7; ++i) r.unit[i] = pick_unit(s.rows, widths[i]);
  r.first6 = units_of(r.unit[5], s.rows, 16) % 8;
  r.gmul = s.parts > 1 ? 0 : ((1 << 16) + ns - 1) / ns;
  return true;
}

// the fragments of k-step kk of a unit at rows r0, columns c0 into (a, b):
// A's by ldmatrix; kT, W [K][N] as stored (ldmatrix .trans), else W^T read
// from W's rows c0 .. by ldmatrix without .trans, which gives W^T's B
// fragments
template <int MI, int NJ, bool kT>
__device__ __forceinline__ void res_frags(uint32_t (&a)[MI][4], uint32_t (&b)[NJ][2],
                                          const uint16_t* A, int lda, const uint16_t* W,
                                          int ldw, int r0, int c0, int kk, int lane) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
    ldmatrix_x4(a[mi], A + (size_t)(r0 + mi * 16 + (lane & 15)) * lda + kk + (lane >> 4) * 8);
#pragma unroll
  for (int jj = 0; jj < NJ / 2; ++jj) {
    uint32_t r4[4];
    if (kT)
      ldmatrix_x4_trans(r4, W + (size_t)(kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * ldw + c0 +
                                jj * 16 + (lane >> 4) * 8);
    else
      ldmatrix_x4(r4, W + (size_t)(c0 + jj * 16 + (lane >> 4) * 8 + (lane & 7)) * ldw + kk +
                          ((lane >> 3) & 1) * 8);
    b[2 * jj][0] = r4[0];
    b[2 * jj][1] = r4[1];
    b[2 * jj + 1][0] = r4[2];
    b[2 * jj + 1][1] = r4[3];
  }
}

template <int MI, int NJ>
__device__ __forceinline__ void res_mma(float (&acc)[MI][NJ][4], const uint32_t (&a)[MI][4],
                                        const uint32_t (&b)[NJ][2]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_m16n8k16_bf16(acc[mi][j], a[mi], b[j][0], b[j][1]);
}

// A unit's epilogue: epi(row, column, value, value at the next column) for
// each pair of the thread's accumulators (rows g and g + 8 of each m16
// tile, columns 2q and 2q + 1 of each n8 tile); `PoolInto` has its own.
template <int MI, int NJ, class Epi>
__device__ __forceinline__ void unit_epi(const Epi& epi, float (&acc)[MI][NJ][4], int r0,
                                         int c0, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        epi(r0 + mi * 16 + g + 8 * h, c0 + j * 8 + 2 * q, acc[mi][j][2 * h],
            acc[mi][j][2 * h + 1]);
}

// the larger of two (maximum, tie count) pairs with the ties of both where
// they are equal: the same in any order (the maximum is exact, counts add)
__device__ __forceinline__ void merge_max(float& m, int& k, float m2, int k2) {
  const float mx = fmaxf(m, m2);
  k = (m == mx ? k : 0) + (m2 == mx ? k2 : 0);
  m = mx;
}

// The forward's layer 3: the pool's partials of relu(z3 + b3), with -1
// (below every relu output) on rows past the tile's. Where seg > 1, the
// (maximum, ties) of each segment of seg rows (16 MI: the unit's rows,
// where they lie in one group; 16: an m16 tile's) and column, merged in
// registers over the thread's rows, then over the lanes by shuffles, into
// pm / pc [segment][ld]; where seg is 1 (groups off m16 tiles) each row's
// value into pm [row][ld].
struct PoolInto {
  float* pm;
  int* pc;
  int ld;
  const float* b3;
  int nrows, seg;
};

// the entries a lane keeps once lanes_pool has merged V over 8 lanes
__host__ __device__ constexpr int pool_left(int n, int mask = 4) {
  return mask > 16 ? n : pool_left(n % 2 ? n : n / 2, mask * 2);
}

// The 8 lanes that share lane % 4 hold the same columns of other rows
// (entry e = 2 j + e' of a unit: column 8 j + 2 (lane % 4) + e'). While a
// lane's entries are even in number, lanes MASK apart swap halves (the lane
// with the bit set keeps the upper half) and merge what they receive, so
// each shuffle carries an entry that its receiver keeps; an odd number is
// merged in place, both lanes keeping all. On return a lane holds entries
// idx + [0, pool_left(V)) merged over the 8 lanes; lanes with a bit of dup
// set hold copies.
template <int N, int MASK, int V>
__device__ __forceinline__ void lanes_pool(float (&m)[V], int (&k)[V], int lane, int& idx,
                                           int& dup) {
  if constexpr (MASK <= 16) {
    if constexpr (N % 2 == 0) {
      constexpr int H = N / 2;
      const bool up = lane & MASK;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float om = __shfl_xor_sync(0xffffffffu, up ? m[i] : m[i + H], MASK);
        const int ok = __shfl_xor_sync(0xffffffffu, up ? k[i] : k[i + H], MASK);
        if (up) {
          m[i] = m[i + H];
          k[i] = k[i + H];
        }
        merge_max(m[i], k[i], om, ok);
      }
      if (up) idx += H;
      lanes_pool<H, MASK * 2>(m, k, lane, idx, dup);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float om = __shfl_xor_sync(0xffffffffu, m[i], MASK);
        const int ok = __shfl_xor_sync(0xffffffffu, k[i], MASK);
        merge_max(m[i], k[i], om, ok);
      }
      dup |= MASK;
      lanes_pool<N, MASK * 2>(m, k, lane, idx, dup);
    }
  }
}

// a segment's partials, merged over the lanes, into row sg of pm / pc
template <int V>
__device__ __forceinline__ void pool_segment(float (&m)[V], int (&k)[V], const PoolInto& p,
                                             int sg, int c0, int lane) {
  int idx = 0, dup = 0;
  lanes_pool<V, 4>(m, k, lane, idx, dup);
  if (lane & dup) return;
  constexpr int kLeft = pool_left(V);
#pragma unroll
  for (int i = 0; i < kLeft; ++i) {
    const int e = idx + i, c = c0 + (e >> 1) * 8 + 2 * (lane & 3) + (e & 1);
    p.pm[(size_t)sg * p.ld + c] = m[i];
    p.pc[(size_t)sg * p.ld + c] = k[i];
  }
}

template <int MI, int NJ>
__device__ __forceinline__ void unit_epi(const PoolInto& p, float (&acc)[MI][NJ][4], int r0,
                                         int c0, int lane) {
  const int g = lane >> 2, q = lane & 3;
  // relu(z3 + b3) in place, -1 on rows past the tile's
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const bool in0 = r0 + mi * 16 + g < p.nrows, in1 = r0 + mi * 16 + g + 8 < p.nrows;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float b = p.b3[c0 + j * 8 + 2 * q + e];
        acc[mi][j][e] = in0 ? fmaxf(__fadd_rn(acc[mi][j][e], b), 0.0f) : -1.0f;
        acc[mi][j][2 + e] = in1 ? fmaxf(__fadd_rn(acc[mi][j][2 + e], b), 0.0f) : -1.0f;
      }
  }
  if (p.seg == 1) {  // each row's values
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(p.pm + (size_t)(r0 + mi * 16 + g + 8 * h) * p.ld + c0 +
                                     j * 8 + 2 * q) =
              make_float2(acc[mi][j][2 * h], acc[mi][j][2 * h + 1]);
    return;
  }
  // each entry's maximum and ties over the thread's rows of the segment:
  // m16 tiles [mi0, mi1)
  constexpr int V = 2 * NJ;
  float m[V];
  int k[V];
  auto entries = [&](int mi0, int mi1) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float mx = -1.0f;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        if (mi >= mi0 && mi < mi1)
          mx = fmaxf(mx, fmaxf(acc[mi][i >> 1][i & 1], acc[mi][i >> 1][2 + (i & 1)]));
      int kx = 0;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        if (mi >= mi0 && mi < mi1)
          kx += (acc[mi][i >> 1][i & 1] == mx) + (acc[mi][i >> 1][2 + (i & 1)] == mx);
      m[i] = mx;
      k[i] = kx;
    }
  };
  if (MI > 1 && p.seg == 16 * MI) {  // the unit's rows lie in one group
    entries(0, MI);
    pool_segment(m, k, p, r0 / p.seg, c0, lane);
  } else {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {  // an m16 tile's
      entries(mi, mi + 1);
      pool_segment(m, k, p, r0 / 16 + mi, c0, lane);
    }
  }
}

// acc = A (rows x K, bf16, lda a row) W for output columns [n0, n0 + N)
// (`res_frags`), each output the chain of mma k-steps from 0 in ascending
// k, with no barrier. Warp w runs units w - first, w - first + 8, ...
// (mod 8) and hands each unit's accumulators to its epilogue (`unit_epi`).
template <int MI, int NJ, bool kT, class Epi>
__device__ __forceinline__ void res_product(const uint16_t* A, int lda, const uint16_t* W,
                                            int ldw, int K, int n0, int N, int rows,
                                            int first, const Epi& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ur = rows / (16 * MI), units = ur * (N / (8 * NJ));
  for (int u = (warp - first) & 7; u < units; u += 8) {
    const int r0 = (u % ur) * 16 * MI, c0 = n0 + (u / ur) * 8 * NJ;
    float acc[MI][NJ][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;
#pragma unroll 2
    for (int kk = 0; kk < K; kk += 16) {
      uint32_t a[MI][4], b[NJ][2];
      res_frags<MI, NJ, kT>(a, b, A, lda, W, ldw, r0, c0, kk, lane);
      res_mma<MI, NJ>(acc, a, b);
    }
    unit_epi(epi, acc, r0, c0, lane);
  }
}

// res_product at the warp tile kUnits[unit]
template <bool kT, class Epi>
__device__ __forceinline__ void res_gemm(int unit, const uint16_t* A, int lda,
                                         const uint16_t* W, int ldw, int K, int n0, int N,
                                         int rows, int first, const Epi& epi) {
  switch (unit) {
    case 0: res_product<2, 6, kT>(A, lda, W, ldw, K, n0, N, rows, first, epi); break;
    case 1: res_product<2, 4, kT>(A, lda, W, ldw, K, n0, N, rows, first, epi); break;
    case 2: res_product<1, 4, kT>(A, lda, W, ldw, K, n0, N, rows, first, epi); break;
    case 3: res_product<2, 2, kT>(A, lda, W, ldw, K, n0, N, rows, first, epi); break;
    default: res_product<1, 2, kT>(A, lda, W, ldw, K, n0, N, rows, first, epi); break;
  }
}

// The epilogues, each for a pair of accumulators at (row, column, column +
// 1): functors whose calls are inlined.
// a1 or a2: bf16(relu(acc + bias))
struct ReluInto {
  uint16_t* dst;
  int ld;
  const float* bias;
  __device__ __forceinline__ void operator()(int rr, int c, float v0, float v1) const {
    *reinterpret_cast<uint32_t*>(dst + (size_t)rr * ld + c) =
        cvt_rn_bf16x2(fmaxf(__fadd_rn(v0, bias[c]), 0.0f),
                      fmaxf(__fadd_rn(v1, bias[c + 1]), 0.0f));
  }
};

// layer 3 again: dz3 = bf16(g / cnt) (Q) on the rows tied at the maximum
// (P) where z3 > 0, else 0; 0 past the tile's rows and c3. Branch-free: P
// and Q are read at clamped indices inside the landing buffer whatever the
// outcome, and a row's group is (row * gmul) >> 16 (gmul = ceil(2^16 /
// ns), exact while row * ns < 2^16: both are at most 128 where a tile
// holds whole groups; 0 where a group is split).
struct Dz3Into {
  uint16_t* d3;
  int ld;
  const float *b3, *P, *Q;
  int nrows, c3, gmul;
  __device__ __forceinline__ void operator()(int rr, int c, float v0, float v1) const {
    const int o = ((rr * gmul) >> 16) * c3;
    const int o0 = o + min(c, c3 - 1), o1 = o + min(c + 1, c3 - 1);
    const float p0 = P[o0], p1 = P[o1], q0 = Q[o0], q1 = Q[o1];
    const float a0 = fmaxf(__fadd_rn(v0, b3[c]), 0.0f);
    const float a1 = fmaxf(__fadd_rn(v1, b3[c + 1]), 0.0f);
    const bool in = rr < nrows;
    const float d0 = in && c < c3 && a0 > 0.0f && a0 == p0 ? q0 : 0.0f;
    const float d1 = in && c + 1 < c3 && a1 > 0.0f && a1 == p1 ? q1 : 0.0f;
    *reinterpret_cast<uint32_t*>(d3 + (size_t)rr * ld + c) = cvt_rn_bf16x2(d0, d1);
  }
};

// in place: bf16(acc) where the ReLU mask (the bf16 activation there) is
// nonzero, else 0
struct MaskedInto {
  uint16_t* act;
  int ld;
  __device__ __forceinline__ void operator()(int rr, int c, float v0, float v1) const {
    uint32_t* p = reinterpret_cast<uint32_t*>(act + (size_t)rr * ld + c);
    const uint32_t on = *p;
    *p = cvt_rn_bf16x2((on & 0x7fffu) ? v0 : 0.0f, (on & 0x7fff0000u) ? v1 : 0.0f);
  }
};

// dgx's staged rows: columns 0-2 of the first 16
struct DgxInto {
  float* sx;
  __device__ __forceinline__ void operator()(int rr, int c, float v0, float v1) const {
    if (c >= 3) return;
    sx[rr * 3 + c] = v0;
    if (c + 1 < 3) sx[rr * 3 + c + 1] = v1;
  }
};

// dgf's staged rows: columns 16 ..
struct DgfInto {
  float* sf;
  int ld;
  __device__ __forceinline__ void operator()(int rr, int c, float v0, float v1) const {
    *reinterpret_cast<float2*>(sf + (size_t)rr * ld + c - 16) = make_float2(v0, v1);
  }
};

// A tile's inputs as they lie in device memory: gx's rows, gf's rows, and
// (the backward's, kBwd) pooled, the cotangent and cnt of its groups, each
// contiguous. A piece is bulk-copied into the landing buffer where it starts
// and ends on 16-byte lines (`bulk_ok`), else read in place.
struct Pieces {
  const void* src[5];
  unsigned bytes[5];
};

template <bool kBwd>
__device__ __forceinline__ Pieces pieces_of(const Shape& s, const Tile& t,
                                            const uint16_t* gx, const uint16_t* gf,
                                            const float* pooled, const float* gout,
                                            const int* cnt) {
  const size_t row0 = (size_t)t.g0 * s.ns + t.slot0, o = (size_t)t.g0 * s.c3;
  const unsigned gb = kBwd ? (unsigned)t.ngroups * s.c3 * 4 : 0u;
  Pieces p;
  p.src[0] = gx + row0 * 3;
  p.bytes[0] = (unsigned)t.nrows * 6;
  p.src[1] = gf != nullptr ? gf + row0 * s.cf : nullptr;
  p.bytes[1] = gf != nullptr ? (unsigned)t.nrows * s.cf * 2 : 0u;
  p.src[2] = kBwd ? pooled + o : nullptr;
  p.src[3] = kBwd ? gout + o : nullptr;
  p.src[4] = kBwd ? cnt + o : nullptr;
  p.bytes[2] = p.bytes[3] = p.bytes[4] = gb;
  return p;
}

__device__ __forceinline__ bool bulk_ok(const Pieces& p, int i) {
  return p.bytes[i] != 0 && p.bytes[i] % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p.src[i]) % 16 == 0;
}

// the landing buffer's offsets of the five pieces
struct Landing {
  size_t off[5];
};

__device__ __forceinline__ Landing landing_of(const Shape& s, const Res& r) {
  Landing l;
  l.off[0] = 0;
  l.off[1] = (size_t)r.rows * 6;
  l.off[2] = l.off[1] + (size_t)r.rows * s.cf * 2;
  l.off[3] = l.off[2] + r.gd;
  l.off[4] = l.off[3] + r.gd;
  return l;
}

// one thread: a tile's bulk-copyable pieces into the landing buffer on bar
// (a plain arrival where there are none)
__device__ __forceinline__ void land_tile(const Pieces& p, const Landing& l, char* land,
                                          uint64_t* bar) {
  unsigned total = 0;
  for (int i = 0; i < 5; ++i)
    if (bulk_ok(p, i)) total += p.bytes[i];
  if (total == 0) {
    mbar_arrive(bar);
    return;
  }
  mbar_expect_tx(bar, total);
  for (int i = 0; i < 5; ++i)
    if (bulk_ok(p, i)) bulk_copy(land + l.off[i], p.src[i], p.bytes[i], bar);
}

// n floats from shared memory (16-byte aligned) to device memory: 16-byte
// stores where dst is 16-byte aligned
__device__ __forceinline__ void store_rows(float* dst, const float* src, int n) {
  int i0 = 0;
  if (reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
    for (int i = threadIdx.x; i < n / 4; i += kThreads)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
    i0 = n / 4 * 4;
  }
  for (int i = i0 + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

// the resident kernels' regions of shared memory (`Res`)
struct Regions {
  uint16_t *W1, *W2, *W3, *a1, *a2, *X;
  float *B1, *B2, *B3;
  char* land;
  uint64_t* bars;
};

__device__ __forceinline__ Regions regions_of(char* base, const Shape& s, const Res& r) {
  Regions m;
  m.W1 = reinterpret_cast<uint16_t*>(base + r.w1);
  m.W2 = reinterpret_cast<uint16_t*>(base + r.w2);
  m.W3 = reinterpret_cast<uint16_t*>(base + r.w3);
  m.B1 = reinterpret_cast<float*>(base + r.bias);
  m.B2 = m.B1 + s.c1p;
  m.B3 = m.B2 + s.c2p;
  m.a1 = reinterpret_cast<uint16_t*>(base + r.a1);
  m.a2 = reinterpret_cast<uint16_t*>(base + r.a2);
  m.X = reinterpret_cast<uint16_t*>(base + r.u);
  m.land = base + r.land;
  m.bars = reinterpret_cast<uint64_t*>(base + r.bars);
  return m;
}

// A resident block's start: both mbarriers initialised, then warp 0
// bulk-copies W1, W2, W3 (a copy a row, into rows padded by 8) and the
// biases once on bars[0], and thread 0 the block's first tile's pieces on
// bars[1]; returns when the weights are in.
template <bool kBwd>
__device__ __forceinline__ void res_start(const Shape& s, const Regions& m, const Landing& l,
                                          const uint16_t* w1, const float* b1,
                                          const uint16_t* w2, const float* b2,
                                          const uint16_t* w3, const float* b3,
                                          const uint16_t* gx, const uint16_t* gf,
                                          const float* pooled, const float* gout,
                                          const int* cnt) {
  const int tid = threadIdx.x;
  const int ld1 = s.c1p + 8, ld2 = s.c2p + 8, ld3 = s.c3p + 8;
  if (tid == 0) {
    mbar_init(&m.bars[0], 1);
    mbar_init(&m.bars[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid < 32) {
    if (tid == 0)
      mbar_expect_tx(&m.bars[0],
                     (unsigned)((s.k1 * s.c1p + s.c1p * s.c2p + s.c2p * s.c3p) * 2 +
                                (s.c1p + s.c2p + s.c3p) * 4));
    __syncwarp();
    for (int i = tid; i < s.k1 + s.c1p + s.c2p; i += 32) {
      if (i < s.k1)
        bulk_copy(m.W1 + (size_t)i * ld1, w1 + (size_t)i * s.c1p, s.c1p * 2, &m.bars[0]);
      else if (i < s.k1 + s.c1p)
        bulk_copy(m.W2 + (size_t)(i - s.k1) * ld2, w2 + (size_t)(i - s.k1) * s.c2p,
                  s.c2p * 2, &m.bars[0]);
      else
        bulk_copy(m.W3 + (size_t)(i - s.k1 - s.c1p) * ld3,
                  w3 + (size_t)(i - s.k1 - s.c1p) * s.c3p, s.c3p * 2, &m.bars[0]);
    }
    if (tid == 0) {
      bulk_copy(m.B1, b1, s.c1p * 4, &m.bars[0]);
      bulk_copy(m.B2, b2, s.c2p * 4, &m.bars[0]);
      bulk_copy(m.B3, b3, s.c3p * 4, &m.bars[0]);
    }
  }
  if (tid == 0 && (int)blockIdx.x < s.tiles)
    land_tile(pieces_of<kBwd>(s, tile_of(s, blockIdx.x), gx, gf, pooled, gout, cnt), l,
              m.land, &m.bars[1]);
  mbar_wait(&m.bars[0], 0);
}

// layer 1's input of a tile into X [rows][k1 + 8]: x in channels 0-2, zeros
// to 16, the features; zero rows past the tile's (from the landing buffer
// where a piece was bulk-copied, else from device memory)
__device__ __forceinline__ void spread_input(const Shape& s, const Tile& t, const Pieces& pc,
                                             const Landing& l, const char* land, uint16_t* X,
                                             int rows) {
  const uint16_t* xs = bulk_ok(pc, 0) ? reinterpret_cast<const uint16_t*>(land + l.off[0])
                                      : static_cast<const uint16_t*>(pc.src[0]);
  const uint16_t* fs = bulk_ok(pc, 1) ? reinterpret_cast<const uint16_t*>(land + l.off[1])
                                      : static_cast<const uint16_t*>(pc.src[1]);
  const int chunks = s.k1 / 8, ldx = s.k1 + 8;
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int rr = i / chunks, j = i % chunks;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (rr < t.nrows) {
      if (j == 0) {
        const uint16_t* p = xs + rr * 3;
        v.x = p[0] | (static_cast<uint32_t>(p[1]) << 16);
        v.y = p[2];
      } else if (j >= 2) {
        v = *reinterpret_cast<const uint4*>(fs + (size_t)rr * s.cf + (j - 2) * 8);
      }
    }
    *reinterpret_cast<uint4*>(X + (size_t)rr * ldx + j * 8) = v;
  }
}

// The tile's (group, column) maxima and tie counts from the pool's
// partials into dm / dk (pooled and cnt of its groups, or a split group's
// part of pmax / pcnt: contiguous either way). A group's segments merge in
// ascending order, four entries a thread by 16-byte loads and stores where
// c3 % 4 == 0 and the outputs are 16-byte aligned, else one a thread; where
// groups are off m16 tiles (seg 1) 8 lanes an entry walk its rows and merge
// by shuffles.
__device__ __forceinline__ void pool_tile(const Shape& s, const Res& r, const Tile& t,
                                          const float* PM, const int* PC, float* dm, int* dk) {
  const int tid = threadIdx.x, n = t.ngroups * s.c3, lp = r.lp;
  if (r.seg == 1) {
    const int lane = tid & 31, sub = lane & 7;
    for (int e0 = (tid >> 5) * 4; e0 < n; e0 += kThreads / 8) {  // warp-uniform
      const int o = min(e0 + (lane >> 3), n - 1), gi = o / s.c3, c = o - gi * s.c3;
      float m = -1.0f;
      int k = 0;
      for (int rr = gi * s.ns + sub; rr < (gi + 1) * s.ns; rr += 8)
        merge_max(m, k, PM[(size_t)rr * lp + c], 1);
#pragma unroll
      for (int mask = 1; mask < 8; mask <<= 1) {
        const float om = __shfl_xor_sync(0xffffffffu, m, mask);
        const int ok = __shfl_xor_sync(0xffffffffu, k, mask);
        merge_max(m, k, om, ok);
      }
      if (sub == 0 && e0 + (lane >> 3) < n) {
        dm[o] = m;
        dk[o] = k;
      }
    }
    return;
  }
  const int nseg = s.parts > 1 ? (t.nrows + r.seg - 1) / r.seg : s.ns / r.seg;
  if (s.c3 % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(dm) | reinterpret_cast<uintptr_t>(dk)) % 16 == 0) {
    for (int i = tid; i < n / 4; i += kThreads) {
      const int o = 4 * i, gi = o / s.c3, c = o - gi * s.c3;
      float4 m = make_float4(-1.0f, -1.0f, -1.0f, -1.0f);
      int4 k;
      k.x = k.y = k.z = k.w = 0;
      for (int q = gi * nseg; q < (gi + 1) * nseg; ++q) {
        const float4 pm = *reinterpret_cast<const float4*>(PM + (size_t)q * lp + c);
        const int4 pk = *reinterpret_cast<const int4*>(PC + (size_t)q * lp + c);
        merge_max(m.x, k.x, pm.x, pk.x);
        merge_max(m.y, k.y, pm.y, pk.y);
        merge_max(m.z, k.z, pm.z, pk.z);
        merge_max(m.w, k.w, pm.w, pk.w);
      }
      *reinterpret_cast<float4*>(dm + o) = m;
      *reinterpret_cast<int4*>(dk + o) = k;
    }
    return;
  }
  for (int o = tid; o < n; o += kThreads) {
    const int gi = o / s.c3, c = o - gi * s.c3;
    float m = -1.0f;
    int k = 0;
    for (int q = gi * nseg; q < (gi + 1) * nseg; ++q)
      merge_max(m, k, PM[(size_t)q * lp + c], PC[(size_t)q * lp + c]);
    dm[o] = m;
    dk[o] = k;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
gmlp_bf16_fwd_resident(const uint16_t* __restrict__ gx, const uint16_t* __restrict__ gf,
                       const uint16_t* __restrict__ w1, const float* __restrict__ b1,
                       const uint16_t* __restrict__ w2, const float* __restrict__ b2,
                       const uint16_t* __restrict__ w3, const float* __restrict__ b3,
                       Shape s, Res r, float* __restrict__ pooled, int* __restrict__ cnt,
                       float* __restrict__ pmax, int* __restrict__ pcnt) {
  extern __shared__ __align__(16) float smem[];
  char* base = reinterpret_cast<char*>(smem);
  const Regions m = regions_of(base, s, r);
  float* PM = reinterpret_cast<float*>(base + r.a1);  // the pool's partials, over a1
  int* PC = reinterpret_cast<int*>(PM + (size_t)(r.rows / 16) * r.lp);
  const Landing l = landing_of(s, r);
  const int tid = threadIdx.x, rows = r.rows;
  const int ld1 = s.c1p + 8, ld2 = s.c2p + 8, ld3 = s.c3p + 8, ldx = s.k1 + 8;
  res_start<false>(s, m, l, w1, b1, w2, b2, w3, b3, gx, gf, nullptr, nullptr, nullptr);

  unsigned it = 0;
  for (int tn = blockIdx.x; tn < s.tiles; tn += gridDim.x, ++it) {
    const Tile t = tile_of(s, tn);
    mbar_wait(&m.bars[1], it & 1);
    spread_input(s, t, pieces_of<false>(s, t, gx, gf, nullptr, nullptr, nullptr), l, m.land,
                 m.X, rows);
    __syncthreads();  // X is in; the landing buffer is free for the next tile
    if (tid == 0 && tn + (int)gridDim.x < s.tiles)
      land_tile(pieces_of<false>(s, tile_of(s, tn + gridDim.x), gx, gf, nullptr, nullptr,
                                 nullptr),
                l, m.land, &m.bars[1]);
    res_gemm<true>(r.unit[0], m.X, ldx, m.W1, ld1, s.k1, 0, s.c1p, rows, 0,
                   ReluInto{m.a1, ld1, m.B1});
    __syncthreads();
    res_gemm<true>(r.unit[1], m.a1, ld1, m.W2, ld2, s.c1p, 0, s.c2p, rows, 0,
                   ReluInto{m.a2, ld2, m.B2});
    __syncthreads();  // a1 is dead: the pool's partials go over it
    res_gemm<true>(r.unit[2], m.a2, ld2, m.W3, ld3, s.c2p, 0, s.c3p, rows, 0,
                   PoolInto{PM, PC, r.lp, m.B3, t.nrows, r.seg});
    __syncthreads();  // the partials are in (read before the next tile's layer 1)
    const bool split = s.parts > 1;
    const size_t o = split ? ((size_t)t.g0 * s.parts + t.part) * s.c3 : (size_t)t.g0 * s.c3;
    pool_tile(s, r, t, PM, PC, (split ? pmax : pooled) + o, (split ? pcnt : cnt) + o);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
gmlp_bf16_bwd_resident(const uint16_t* __restrict__ gx, const uint16_t* __restrict__ gf,
                       const uint16_t* __restrict__ w1, const float* __restrict__ b1,
                       const uint16_t* __restrict__ w2, const float* __restrict__ b2,
                       const uint16_t* __restrict__ w3, const float* __restrict__ b3,
                       const float* __restrict__ pooled, const int* __restrict__ cnt,
                       const float* __restrict__ gout, Shape s, Res r,
                       float* __restrict__ dgx, float* __restrict__ dgf) {
  extern __shared__ __align__(16) float smem[];
  char* base = reinterpret_cast<char*>(smem);
  const Regions m = regions_of(base, s, r);
  uint16_t* d3 = m.X;                                     // dz3, over layer 1's input
  float* SF = reinterpret_cast<float*>(base + r.a2);      // dgf's staged rows,
  float* SX = SF + (s.cf ? (size_t)r.rows * (s.cf + 8) : 0);  // then dgx's
  const Landing l = landing_of(s, r);
  const int tid = threadIdx.x, rows = r.rows;
  const int ld1 = s.c1p + 8, ld2 = s.c2p + 8, ld3 = s.c3p + 8, ldx = s.k1 + 8;
  const int ldf = s.cf + 8;
  res_start<true>(s, m, l, w1, b1, w2, b2, w3, b3, gx, gf, pooled, gout, cnt);

  unsigned it = 0;
  for (int tn = blockIdx.x; tn < s.tiles; tn += gridDim.x, ++it) {
    const Tile t = tile_of(s, tn);
    const Pieces pc = pieces_of<true>(s, t, gx, gf, pooled, gout, cnt);
    mbar_wait(&m.bars[1], it & 1);
    spread_input(s, t, pc, l, m.land, m.X, rows);
    // the tile's groups' maxima into P (where not bulk-copied) and g / cnt
    // into Q, over the landing buffer's cotangent
    float* P = reinterpret_cast<float*>(m.land + l.off[2]);
    float* Q = reinterpret_cast<float*>(m.land + l.off[3]);
    {
      const float* ps = bulk_ok(pc, 2) ? P : static_cast<const float*>(pc.src[2]);
      const float* gs = bulk_ok(pc, 3) ? Q : static_cast<const float*>(pc.src[3]);
      const int* cs = bulk_ok(pc, 4) ? reinterpret_cast<const int*>(m.land + l.off[4])
                                     : static_cast<const int*>(pc.src[4]);
      for (int o = tid; o < t.ngroups * s.c3; o += kThreads) {
        P[o] = ps[o];
        Q[o] = gs[o] / (float)cs[o];
      }
    }
    __syncthreads();  // X, P and Q are in
    res_gemm<true>(r.unit[0], m.X, ldx, m.W1, ld1, s.k1, 0, s.c1p, rows, 0,
                   ReluInto{m.a1, ld1, m.B1});
    __syncthreads();
    res_gemm<true>(r.unit[1], m.a1, ld1, m.W2, ld2, s.c1p, 0, s.c2p, rows, 0,
                   ReluInto{m.a2, ld2, m.B2});
    __syncthreads();
    res_gemm<true>(r.unit[2], m.a2, ld2, m.W3, ld3, s.c2p, 0, s.c3p, rows, 0,
                   Dz3Into{d3, ld3, m.B3, P, Q, t.nrows, s.c3, r.gmul});
    __syncthreads();  // dz3 is in; the landing buffer is free for the next tile
    if (tid == 0 && tn + (int)gridDim.x < s.tiles)
      land_tile(pieces_of<true>(s, tile_of(s, tn + gridDim.x), gx, gf, pooled, gout, cnt), l,
                m.land, &m.bars[1]);
    res_gemm<false>(r.unit[3], d3, ld3, m.W3, ld3, s.c3p, 0, s.c2p, rows, 0,
                    MaskedInto{m.a2, ld2});  // dz2 over a2
    __syncthreads();
    res_gemm<false>(r.unit[4], m.a2, ld2, m.W2, ld2, s.c2p, 0, s.c1p, rows, 0,
                    MaskedInto{m.a1, ld1});  // dz1 over a1
    __syncthreads();
    // dgx (columns 0-2 of the first 16) and dgf (columns 16 ..) staged
    res_gemm<false>(r.unit[5], m.a1, ld1, m.W1, ld1, s.c1p, 0, 16, rows, 0, DgxInto{SX});
    if (s.cf)
      res_gemm<false>(r.unit[6], m.a1, ld1, m.W1, ld1, s.c1p, 16, s.cf, rows, r.first6,
                      DgfInto{SF, ldf});
    __syncthreads();  // the tile's outputs are staged
    const size_t row0 = (size_t)t.g0 * s.ns + t.slot0;
    store_rows(dgx + row0 * 3, SX, t.nrows * 3);
    if (s.cf) {  // dgf is 16-byte aligned and cf % 16 == 0: float4 rows
      float* df = dgf + row0 * s.cf;
      const int q = s.cf / 4;
      for (int i = tid; i < t.nrows * q; i += kThreads) {
        const int rr = i / q, c = (i % q) * 4;
        *reinterpret_cast<float4*>(df + (size_t)rr * s.cf + c) =
            *reinterpret_cast<const float4*>(SF + (size_t)rr * ldf + c);
      }
    }
    __syncthreads();  // the staging is read before the next tile's X overwrites it
  }
}

int res_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    sms = v > 0 ? v : 1;
  }
  return sms;
}

// persistent blocks of a resident kernel: as many as the SMs hold at once,
// at most one a tile (the blocks an SM holds read once for each kernel and
// shared-memory size)
unsigned res_grid(const void* kernel, const Shape& s, const Res& r) {
  static std::mutex mu;
  static std::map<std::pair<const void*, size_t>, int> per_sm;
  int n;
  {
    std::lock_guard<std::mutex> hold(mu);
    int& seen = per_sm[{kernel, r.smem}];
    if (seen == 0) {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&seen, kernel, kThreads, r.smem);
      seen = seen > 0 ? seen : 1;
    }
    n = seen;
  }
  const long long grid = (long long)n * res_sms();
  return (unsigned)(grid < s.tiles ? grid : s.tiles);
}

const void* res_kernel(bool bwd) {
  return bwd ? reinterpret_cast<const void*>(gmlp_bf16_bwd_resident)
             : reinterpret_cast<const void*>(gmlp_bf16_fwd_resident);
}

cudaError_t launch_res_fwd(const Shape& s, const Res& r, const void* gx, const void* gf,
                           const void* w1, const float* b1, const void* w2, const float* b2,
                           const void* w3, const float* b3, float* pooled, int* cnt,
                           float* pmax, int* pcnt, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gmlp_bf16_fwd_resident, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)geoa3::kSmemMax);
  if (attr != cudaSuccess) return attr;
  gmlp_bf16_fwd_resident<<<res_grid(res_kernel(false), s, r), kThreads, r.smem, st>>>(
      static_cast<const uint16_t*>(gx), static_cast<const uint16_t*>(gf),
      static_cast<const uint16_t*>(w1), b1, static_cast<const uint16_t*>(w2), b2,
      static_cast<const uint16_t*>(w3), b3, s, r, pooled, cnt, pmax, pcnt);
  return cudaGetLastError();
}

cudaError_t launch_res_bwd(const Shape& s, const Res& r, const void* gx, const void* gf,
                           const void* w1, const float* b1, const void* w2, const float* b2,
                           const void* w3, const float* b3, const float* pooled,
                           const int* cnt, const float* g, float* dgx, float* dgf,
                           cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gmlp_bf16_bwd_resident, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)geoa3::kSmemMax);
  if (attr != cudaSuccess) return attr;
  gmlp_bf16_bwd_resident<<<res_grid(res_kernel(true), s, r), kThreads, r.smem, st>>>(
      static_cast<const uint16_t*>(gx), static_cast<const uint16_t*>(gf),
      static_cast<const uint16_t*>(w1), b1, static_cast<const uint16_t*>(w2), b2,
      static_cast<const uint16_t*>(w3), b3, pooled, cnt, g, s, r, dgx, dgf);
  return cudaGetLastError();
}

// ------------------------------ the kernels with the weights streamed (wgmma)

constexpr int kWRows = 64;       // a tile's rows: wgmma's M
// two consumer warpgroups, the first also feeding the ring: with a producer
// warp or warpgroup besides (288 or 384 threads) ptxas held every thread to
// 168 registers, setmaxnreg or not, and the products spilled
constexpr int kWThreads = 256;
constexpr int kWStage = 32768;   // a ring stage: one weight slab
constexpr int kMaxPasses = 48;
constexpr int kWBars = 128;      // the mbarriers (`WRing`), then the feed's state

__host__ __device__ inline int pad128(int c) { return (c + 127) / 128 * 128; }

// A pass: output columns [n0, n0 + nb) of a product over k rows. Its
// weights [k][nb] come as slabs of ks rows (the last zero-padded to ks),
// each in wgmma's K-major no-swizzle layout [ks / 8][nb][8] (bf16), from
// byte src of its stream on.
struct WPass {
  int n0, nb, k, ks;
  unsigned src;
};

// The streamed kernels' plan (`wgmma_plan`): tiles of 64 rows, each
// holding groups of nsp rows (ns rounded up to 16: padding rows past ns) or
// one part of a group of more than 64 rows; every width padded to 128
// (zero weights and biases: those columns are 0 and add exact zeros); the
// passes in the order a block runs them, the first npf (layers 1-3) read
// from the forward's stream pf, the rest from the backward's pb; shared
// memory as byte offsets: the ring at 0, its mbarriers, a1, a2, then aux
// (the forward's pool partials, or the backward's dz3 hit bits and its
// groups' maxima and g / cnt); layer 1's input lands over a2 and aux (at
// a2), which it outlives. The biases (b1, b2, b3 at the padded widths) sit after the
// mbarriers.
struct WPlan {
  int groups, ns, cf, c3, k1;
  int c1p, c2p, c3p;             // the biases' lengths
  int c1q, c2q, c3q, k1q;        // the widths padded to 128
  int nsp, gpt, parts, tiles;    // a group's rows in a tile, groups a tile, tiles a group
  int splits, stages;            // blocks a tile (splitting layer 3's passes), ring stages
  int n1, n2, n3, n4, npf, npass;  // passes of layers 1, 2, 3, dz2 W2^T, those
                                   // from pf, all
  int lp;                        // the forward's pool partials' row
  unsigned bias, a1, a2, aux, smem;
  WPass pass[kMaxPasses];
};

// passes over N output columns, 256 or 128 wide (at most 64 accumulators a
// thread), largest first, in slabs of 32 KB; false past kMaxPasses
bool add_passes(WPlan& p, unsigned& src, int N, int K) {
  for (int n0 = 0; n0 < N;) {
    const int nb = N - n0 >= 256 ? 256 : 128;
    const int ks = 16384 / nb;
    if (p.npass == kMaxPasses) return false;
    p.pass[p.npass++] = WPass{n0, nb, K, ks, src};
    src += (unsigned)((K + ks - 1) / ks * ks) * nb * 2;
    n0 += nb;
  }
  return true;
}

// The plan of a direction's streamed kernel, false where it does not fit:
// the backward's dz2 takes c2 padded to at most 512 and c3 to 1024 (a
// warp's lanes hold a row's hit bits), and both hold a1, a2 (or layer 1's input)
// in shared memory beside two ring stages at least. The forward splits
// layer 3's passes over up to `sms` / tiles blocks a tile.
bool wgmma_plan(WPlan& p, int groups, int ns, int cf, int c1, int c2, int c3, bool bwd,
                int sms) {
  p = WPlan{};
  p.groups = groups, p.ns = ns, p.cf = cf, p.c3 = c3, p.k1 = 16 + cf;
  p.c1p = pad16(c1), p.c2p = pad16(c2), p.c3p = pad16(c3);
  p.c1q = pad128(c1), p.c2q = pad128(c2), p.c3q = pad128(c3), p.k1q = pad128(p.k1);
  if (bwd && (p.c2q > 512 || p.c3q > 1024)) return false;
  if (ns > kWRows) {
    p.parts = (ns + kWRows - 1) / kWRows, p.gpt = 1, p.nsp = kWRows;
    p.tiles = groups * p.parts;
  } else {
    p.parts = 1, p.nsp = pad16(ns), p.gpt = kWRows / p.nsp;
    p.tiles = (groups + p.gpt - 1) / p.gpt;
  }
  unsigned src = 0;
  bool ok = add_passes(p, src, p.c1q, p.k1);
  p.n1 = p.npass;
  ok = ok && add_passes(p, src, p.c2q, p.c1q);
  p.n2 = p.npass - p.n1;
  ok = ok && add_passes(p, src, p.c3q, p.c2q);
  p.n3 = p.npass - p.n1 - p.n2;
  p.npf = p.npass;
  if (bwd) {  // dz2 = dz3 W3^T by hits (`w_dz2`), then from pb:
    src = 0;
    const int before = p.npass;
    ok = ok && add_passes(p, src, p.c1q, p.c2q);  // dz1 = dz2 W2^T
    p.n4 = p.npass - before;
    ok = ok && add_passes(p, src, p.k1q, p.c1q);  // dgx, dgf = dz1 W1^T
  }
  if (!ok) return false;
  const unsigned a1 = kWRows * (p.c1q + 8) * 2, a2 = kWRows * (p.c2q + 8) * 2;
  unsigned aux;
  if (bwd) {
    aux = kWRows * p.c3q / 8 + 2u * p.gpt * p.c3q * 4;
  } else {
    for (int i = p.npass - p.n3; i < p.npass; ++i) p.lp = std::max(p.lp, p.pass[i].nb / 2);
    aux = 2u * 4 * p.lp * 8;
  }
  const unsigned x = kWRows * (unsigned)cf * 2, rest = std::max(a2 + aux, x);
  const unsigned bias = (p.c1q + p.c2q + p.c3q) * 4;
  for (int st = 4; st >= 2 && !p.stages; --st) {
    const size_t total = (size_t)st * kWStage + kWBars + bias + a1 + rest;
    if (total > geoa3::kSmemMax) continue;
    p.stages = st;
    p.bias = st * kWStage + kWBars, p.a1 = p.bias + bias, p.a2 = p.a1 + a1;
    p.aux = p.a2 + a2, p.smem = (unsigned)total;
  }
  if (!p.stages) return false;
  p.splits = bwd ? 1 : std::max(1, std::min(p.n3, sms / p.tiles));
  return true;
}

// the row of the grouped inputs at row r of tile t, or -1 (a padding row)
__device__ __forceinline__ long long w_row(const WPlan& p, int t, int r) {
  if (p.parts > 1) {
    const int slot = (t % p.parts) * kWRows + r;
    return slot < p.ns ? (long long)(t / p.parts) * p.ns + slot : -1;
  }
  const int gi = r / p.nsp, slot = r - gi * p.nsp, g = t * p.gpt + gi;
  return gi < p.gpt && slot < p.ns && g < p.groups ? (long long)g * p.ns + slot : -1;
}

// the tile's groups (1 where a group is split)
__device__ __forceinline__ int w_groups(const WPlan& p, int t) {
  return p.parts > 1 ? 1 : min(p.gpt, p.groups - t * p.gpt);
}

// The ring's feed, run by warpgroup 0 beside its products, its state in
// shared memory (no other warp holds registers for it): the block's passes
// are [0, a), then b on, n in all, read from src[0] (pf, the first npf) or
// src[1] (pb); the next slab to copy is slab `slab`, of the block's j-th
// pass from its k row k0.
struct WFeed {
  const char* src[2];
  int a, b, n;
  int j, k0, slab;
};

struct WRing {
  char* base;
  uint64_t* full;   // a slab has landed
  uint64_t* empty;  // its products have retired: the stage is free
  uint64_t* xin;    // layer 1's input has landed
  WFeed* feed;
  int stages;
};

// the mbarriers after the ring: full[stages], empty[stages], xin, then the
// feed's state at the ninth 8-byte slot (past 4 stages' barriers)
__device__ __forceinline__ WRing ring_of(char* base, const WPlan& p) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + (size_t)p.stages * kWStage);
  return WRing{base, bars, bars + p.stages, bars + 2 * p.stages,
               reinterpret_cast<WFeed*>(bars + 9), p.stages};
}
static_assert(9 * 8 + sizeof(WFeed) <= kWBars, "the feed's state past the barriers");

// warpgroup 0: the block's slabs below `upto` bulk-copied into the ring,
// one copy a slab (thread 0), each once the slab before it in its stage is
// released. Run by the whole warpgroup, so that no wgmma-related code lies
// on a path ptxas takes for divergent (it serializes the wgmmas: C7520).
__device__ __forceinline__ void w_feed(const WPlan& p, const WRing& rg, int upto) {
  WFeed f = *rg.feed;
  if (f.j >= f.n || f.slab >= upto) return;
  while (f.j < f.n && f.slab < upto) {
    const int i = f.j < f.a ? f.j : f.b + (f.j - f.a);
    const WPass& ps = p.pass[i];
    const unsigned sb = (unsigned)ps.ks * ps.nb * 2;
    const int st = f.slab % p.stages;
    if (f.slab >= p.stages) mbar_wait(&rg.empty[st], ((f.slab / p.stages) & 1) ^ 1);
    if (threadIdx.x == 0) {
      mbar_expect_tx(&rg.full[st], sb);
      bulk_copy(rg.base + (size_t)st * kWStage,
                f.src[i < p.npf ? 0 : 1] + ps.src + (size_t)(f.k0 / ps.ks) * sb, sb,
                &rg.full[st]);
    }
    ++f.slab;
    f.k0 += ps.ks;
    if (f.k0 >= ps.k) f.k0 = 0, ++f.j;
  }
  named_bar_sync(4, 128);  // every thread of the warpgroup has read the state
  if (threadIdx.x == 0) {
    rg.feed->j = f.j;
    rg.feed->k0 = f.k0;
    rg.feed->slab = f.slab;
  }
  named_bar_sync(4, 128);
}

// A streamed block's start: the ring's barriers initialised, then warp 0
// bulk-copies the tile's layer-1 input (the features of its rows: one copy
// a group, or a split group's part) to X [64][cf] on xin, and warpgroup 0
// the first slabs; returns the thread's warp (a value ptxas knows to be warp-uniform:
// a wgmma under a branch it takes for divergent is serialized)
__device__ __forceinline__ int w_start(const WPlan& p, const WRing& rg, const WFeed& f, int t,
                                       const uint16_t* gf, uint16_t* X) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < rg.stages; ++s) {
      mbar_init(rg.full + s, 1);
      mbar_init(rg.empty + s, 8);  // the consumer warps
    }
    mbar_init(rg.xin, 1);
    mbar_fence_init();
    *rg.feed = f;
  }
  __syncthreads();
  const int warp = __shfl_sync(GEOA3_FULL_MASK, (int)threadIdx.x >> 5, 0);
  if (warp == 0) {  // the layer-1 input
    const int lane = threadIdx.x & 31, ng = w_groups(p, t);
    // lane gi: group gi's rows (a split group's part: its valid rows)
    const long long r0 = w_row(p, t, lane * p.nsp);
    int rows = 0;
    if (lane < ng && p.cf) rows = p.parts > 1 ? min(kWRows, p.ns - (t % p.parts) * kWRows) : p.ns;
    unsigned total = rows * p.cf * 2;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) total += __shfl_xor_sync(GEOA3_FULL_MASK, total, o);
    if (lane == 0) {
      if (total)
        mbar_expect_tx(rg.xin, total);
      else
        mbar_arrive(rg.xin);
    }
    __syncwarp();
    if (rows)
      bulk_copy(X + (size_t)lane * p.nsp * p.cf, gf + r0 * p.cf, (unsigned)rows * p.cf * 2,
                rg.xin);
  }
  if (warp < 4) w_feed(p, rg, p.stages);
  return warp;
}

// A consumer thread's two rows of the tile (16 w + lane / 4, and 8 on):
// their rows of the grouped inputs (-1: padding) and groups in the tile
struct WRows {
  long long row[2];
  int gi[2];
};

__device__ __forceinline__ WRows w_rows(const WPlan& p, int t) {
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
  WRows w;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    w.row[h] = w_row(p, t, r0 + 8 * h);
    w.gi[h] = p.parts > 1 || w.row[h] < 0 ? 0 : (r0 + 8 * h) / p.nsp;
  }
  return w;
}

// Shared-memory loads and stores that the compiler keeps in program order:
// an epilogue's operand loads are not hoisted ahead of its stores, which
// would hold every entry's operands in registers beside the accumulators.
#ifndef GEOA3_EMU
__device__ __forceinline__ float2 lds_f2(const void* p) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(smem_addr(p)));
  return v;
}
__device__ __forceinline__ uint32_t lds_u32(const void* p) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(smem_addr(p)));
  return v;
}
__device__ __forceinline__ void sts_u32(void* p, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(smem_addr(p)), "r"(v) : "memory");
}
#else
inline float2 lds_f2(const void* p) {
  float2 v;
  memcpy(&v, p, 8);
  return v;
}
inline uint32_t lds_u32(const void* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
inline void sts_u32(void* p, uint32_t v) { memcpy(p, &v, 4); }
#endif

// the biases into shared memory (b1, b2, b3 at the padded widths, zero past
// their lengths), by the consumers, visible after their next barrier
__device__ __forceinline__ void w_biases(const WPlan& p, float* B, const float* b1,
                                         const float* b2, const float* b3) {
  for (int o = threadIdx.x; o < p.c1q + p.c2q + p.c3q; o += kWThreads) {
    const int c2 = o - p.c1q, c3 = c2 - p.c2q;
    B[o] = c2 < 0 ? (o < p.c1p ? b1[o] : 0.0f)
                  : c3 < 0 ? (c2 < p.c2p ? b2[c2] : 0.0f) : (c3 < p.c3p ? b3[c3] : 0.0f);
  }
}

// A's fragment of k-step k (16 columns from k) for the warp's 16 rows: from
// a bf16 matrix in shared memory (row r at r ld), by ldmatrix
struct AFromSmem {
  const uint16_t* A;
  int ld;
  __device__ __forceinline__ void operator()(uint32_t (&a)[4], int k) const {
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
    ldmatrix_x4(a, A + (size_t)(16 * w + (lane & 15)) * ld + k + (lane >> 4) * 8);
  }
};

// layer 1's input: k-step 0 the coordinates (x, zeros past them: built in
// registers from gx), the others the features from X [64][cf]
struct AFromInput {
  const uint16_t* X;
  int cf;
  uint32_t x[4];
  __device__ __forceinline__ void operator()(uint32_t (&a)[4], int k) const {
    if (k == 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = x[e];
      return;
    }
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
    ldmatrix_x4(a, X + (size_t)(16 * w + (lane & 15)) * cf + (k - 16) + (lane >> 4) * 8);
  }
};

__device__ __forceinline__ AFromInput x_fragment(const uint16_t* gx, const uint16_t* X,
                                                 int cf, const WRows& rw) {
  const int q = threadIdx.x & 3;
  AFromInput f{X, cf, {0u, 0u, 0u, 0u}};
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (rw.row[h] >= 0 && q < 2) {
      const uint16_t* px = gx + rw.row[h] * 3;
      f.x[h] = q == 0 ? px[0] | (static_cast<uint32_t>(px[1]) << 16) : px[2];
    }
  return f;
}

// acc (the tile's 64 rows x this warpgroup's NP columns of the pass: wg NP
// on) = A @ the pass's weights, over its 32 KB slabs in the ring (16384 /
// (2 NP) k rows each): a slab's k-steps issued in groups of at most 4 (A's
// fragments for a group in registers), each retired before the next, the
// slab's stage released after its last, the chain from 0 (where fresh) k
// ascending. Warpgroup 0 keeps the ring fed `stages` slabs ahead.
template <int NP, class ALoad, int kSteps = NP == 256 ? 2 : 4>  // k-steps a group
__device__ __forceinline__ void w_product(float (&acc)[NP / 2], const WPlan& p, const WRing& rg,
                                          int& slab, const WPass& ps, int wg,
                                          const ALoad& aload, bool fresh) {
  const int lane = threadIdx.x & 31;
  const unsigned lbo = (unsigned)ps.nb * 16;
  for (int k0 = 0; k0 < ps.k; k0 += ps.ks, ++slab) {
    if (wg == 0) w_feed(p, rg, slab + p.stages);
    const int st = slab % p.stages;
    mbar_wait(&rg.full[st], (slab / p.stages) & 1);
#ifndef GEOA3_GMLP_STREAM_ONLY  // a timing variant: the weight stream alone
    const unsigned w0 = smem_addr(rg.base + (size_t)st * kWStage) + (unsigned)wg * (NP / 8) * 128;
    const int kend = min(ps.ks, ps.k - k0);
    for (int kk = 0; kk < kend; kk += 16 * kSteps) {
      const int steps = min(kSteps, (kend - kk) / 16);
      uint32_t a[kSteps][4];
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        if (s < steps) aload(a[s], k0 + kk + 16 * s);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        if (s < steps)
          wgmma_bf16<NP>(acc, a[s], gmma_desc(w0 + (kk / 8 + 2 * s) * lbo, lbo, 128),
                         fresh && k0 + kk == 0 && s == 0 ? 0 : 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < NP / 2; ++e) fence_operand(acc[e]);
    }
#else
    (void)lbo, (void)aload, (void)fresh, (void)wg;
#endif
    __syncwarp();
    if (lane == 0) mbar_arrive(&rg.empty[st]);
  }
}

// f(tile row, column, value, value at the next column) for each pair of
// this thread's accumulators of a warpgroup's NP columns from c0
template <int NP, class F>
__device__ __forceinline__ void w_each(float (&acc)[NP / 2], int c0, const F& f) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < NP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      f(16 * w + g + 8 * h, c0 + 8 * j + 2 * q, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// a pairwise epilogue over a pass
template <class F>
struct Entries {
  F f;
  template <int NP>
  __device__ __forceinline__ void apply(float (&acc)[NP / 2], int c0) const {
    w_each<NP>(acc, c0, f);
  }
};

// a1 or a2: bf16(relu(acc + bias)) (the biases in shared memory)
struct ReluQ {
  uint16_t* dst;
  int ld;
  const float* bias;
  __device__ __forceinline__ void operator()(int rr, int c, float v0, float v1) const {
    const float2 b = lds_f2(bias + c);
    sts_u32(dst + (size_t)rr * ld + c,
            cvt_rn_bf16x2(fmaxf(__fadd_rn(v0, b.x), 0.0f), fmaxf(__fadd_rn(v1, b.y), 0.0f)));
  }
};

// in place: bf16(acc) where the ReLU mask (the bf16 activation there) is
// nonzero, else 0 (MaskedInto in program order)
struct MaskedQ {
  uint16_t* act;
  int ld;
  __device__ __forceinline__ void operator()(int rr, int c, float v0, float v1) const {
    uint16_t* p = act + (size_t)rr * ld + c;
    const uint32_t on = lds_u32(p);
    sts_u32(p, cvt_rn_bf16x2((on & 0x7fffu) ? v0 : 0.0f, (on & 0x7fff0000u) ? v1 : 0.0f));
  }
};

// The backward's layer 3 again: z3 > 0 and tied at its group's maximum (P,
// -1 past c3) marks a hit of dz3, a bit of H [64][c3q / 32], whose value
// bf16(g / cnt) depends on its (group, column) alone (`w_dz2`)
struct HitQ {
  uint32_t* H;
  const float *b3, *P;
  int c3q;
  WRows rw;
  __device__ __forceinline__ void operator()(int rr, int c, float v0, float v1) const {
    const int h = (rr >> 3) & 1;
    const float2 b = lds_f2(b3 + c), pm = lds_f2(P + rw.gi[h] * c3q + c);
    const float a0 = fmaxf(__fadd_rn(v0, b.x), 0.0f), a1 = fmaxf(__fadd_rn(v1, b.y), 0.0f);
    const bool in = rw.row[h] >= 0;
    const unsigned bits = (in && a0 > 0.0f && a0 == pm.x ? 1u << (c & 31) : 0u) |
                          (in && a1 > 0.0f && a1 == pm.y ? 2u << (c & 31) : 0u);
    if (bits) atomicOr(H + (size_t)rr * (c3q / 32) + (c >> 5), bits);
  }
};

// dz2 = bf16(dz3 W3^T) where a2 > 0, over a2, from dz3's hits. A warp
// takes tasks k = warp, warp + 8, ..: row k / halves, columns from (k %
// halves) 256, 8 a lane. It walks the row's hits c ascending (a lane holds a
// word of the row's hit bits; the warp visits the nonzero ones by ballot),
// kNB at a time: their W3^T rows loaded at once (512 contiguous bytes a warp
// and hit, through L2), then bf16(g / cnt)[c] W3^T[c][n] summed one fmaf a
// term from 0 (the dense chain's order: the terms it skips add exactly 0).
constexpr int kNB = 16;

__device__ __forceinline__ void w_dz2(const WPlan& p, const uint32_t* H, const float* Q,
                                      const uint16_t* w3t, uint16_t* A2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int words = p.c3q / 32, halves = p.c2q > 256 ? 2 : 1;
  for (int k = warp; k < kWRows * halves; k += kWThreads / 32) {
    const int r = k / halves, n0 = (k % halves) * 256 + 8 * lane;
    const int gi = p.parts > 1 ? 0 : min(r / p.nsp, p.gpt - 1);
    const uint32_t mine = lane < words ? H[(size_t)r * words + lane] : 0u;
    uint32_t nz = __ballot_sync(GEOA3_FULL_MASK, mine != 0u), bits = 0u;
    int wd = 0;
    float d[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) d[e] = 0.0f;
    for (bool more = nz != 0u; more;) {
      int c[kNB];
#pragma unroll
      for (int i = 0; i < kNB; ++i) {  // the next kNB hits (-1 past the last)
        if (bits == 0u && nz != 0u) {
          wd = __ffs(nz) - 1;
          nz &= nz - 1u;
          bits = __shfl_sync(GEOA3_FULL_MASK, mine, wd);
        }
        c[i] = bits != 0u ? wd * 32 + __ffs(bits) - 1 : -1;
        bits &= bits - 1u;
      }
      uint4 u[kNB];
#pragma unroll
      for (int i = 0; i < kNB; ++i)
        u[i] = c[i] >= 0 && n0 < p.c2p
                   ? __ldg(reinterpret_cast<const uint4*>(w3t + (size_t)c[i] * p.c2p + n0))
                   : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int i = 0; i < kNB; ++i) {
        if (c[i] < 0) break;
        const float v = round_bf16(Q[gi * p.c3q + c[i]]);
        const uint32_t w[4] = {u[i].x, u[i].y, u[i].z, u[i].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          d[2 * e] = fmaf(v, __uint_as_float(w[e] << 16), d[2 * e]);
          d[2 * e + 1] = fmaf(v, __uint_as_float(w[e] & 0xffff0000u), d[2 * e + 1]);
        }
      }
      more = c[kNB - 1] >= 0 && (bits != 0u || nz != 0u);
    }
    if (n0 >= p.c2q) continue;
    uint16_t* a = A2 + (size_t)r * (p.c2q + 8) + n0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t on = lds_u32(a + 2 * e);
      sts_u32(a + 2 * e, cvt_rn_bf16x2((on & 0x7fffu) ? d[2 * e] : 0.0f,
                                       (on & 0x7fff0000u) ? d[2 * e + 1] : 0.0f));
    }
  }
}

// dgx (columns 0-2) and dgf (columns 16 .. 16 + cf) of the tile's rows
struct DgOut {
  float *dgx, *dgf;
  int cf;
  WRows rw;
  __device__ __forceinline__ void operator()(int rr, int c, float v0, float v1) const {
    const long long row = rw.row[(rr >> 3) & 1];
    if (row < 0) return;
    if (c >= 16 && c < 16 + cf) {
      *reinterpret_cast<float2*>(dgf + row * cf + c - 16) = make_float2(v0, v1);
    } else if (c < 3) {
      dgx[row * 3 + c] = v0;
      if (c + 1 < 3) dgx[row * 3 + c + 1] = v1;
    }
  }
};

// The forward's layer 3 over a pass: relu(z3 + b3), -1 on padding rows;
// each column's maximum and ties over each warp's 16 rows (of one group),
// merged over the 8 lanes that hold the column (`lanes_pool`) into the
// warpgroup's partials pm / pc [4][lp]; after the warpgroup's barrier a
// thread a (group, column) merges its group's warps in order into pooled /
// cnt, or a split group's part into pmax / pcnt (`gmlp_bf16_fwd_finish`
// merges the parts).
struct WPool {
  const WPlan* p;
  float* pm;
  int* pc;
  const float* b3;
  WRows rw;
  int t, wg;
  float *pooled, *pmax;
  int *cnt, *pcnt;

  template <int NP>
  __device__ __forceinline__ void apply(float (&acc)[NP / 2], int c0) const {
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, q = lane & 3;
    const int lp = p->lp;
    const bool in0 = rw.row[0] >= 0, in1 = rw.row[1] >= 0;
#pragma unroll
    for (int cc = 0; cc < NP / 64; ++cc) {
      float m[16];
      int k[16];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * cc + jj;
        const float2 b2 = lds_f2(b3 + c0 + 8 * j + 2 * q);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float b = e ? b2.y : b2.x;
          const float v0 = in0 ? fmaxf(__fadd_rn(acc[4 * j + e], b), 0.0f) : -1.0f;
          const float v1 = in1 ? fmaxf(__fadd_rn(acc[4 * j + 2 + e], b), 0.0f) : -1.0f;
          const float mx = fmaxf(v0, v1);
          m[2 * jj + e] = mx;
          k[2 * jj + e] = (v0 == mx) + (v1 == mx);
        }
      }
      int idx = 0, dup = 0;
      lanes_pool<16, 4>(m, k, lane, idx, dup);
#pragma unroll
      for (int i = 0; i < pool_left(16); ++i) {
        const int e = idx + i, c = 64 * cc + (e >> 1) * 8 + 2 * q + (e & 1);
        pm[w * lp + c] = m[i];
        pc[w * lp + c] = k[i];
      }
    }
    named_bar_sync(2 + wg, 128);  // the warps' partials are in
    const int ng = p->parts > 1 ? 1 : min(p->gpt, p->groups - t * p->gpt);
    const int segs = p->parts > 1 ? 4 : p->nsp / 16;
    for (int o = threadIdx.x & 127; o < ng * NP; o += 128) {
      const int gi = o / NP, cl = o - gi * NP, c = c0 + cl;
      if (c >= p->c3) continue;
      float mx = -1.0f;
      int kk = 0;
      for (int s = gi * segs; s < (gi + 1) * segs; ++s)
        merge_max(mx, kk, pm[s * lp + cl], pc[s * lp + cl]);
      if (p->parts > 1) {
        const size_t at = (size_t)t * p->c3 + c;  // (group, part) = tile t
        pmax[at] = mx;
        pcnt[at] = kk;
      } else {
        const size_t at = ((size_t)t * p->gpt + gi) * p->c3 + c;
        pooled[at] = mx;
        cnt[at] = kk;
      }
    }
    named_bar_sync(2 + wg, 128);  // the partials are read: the next pass may write
  }
};

// the pass's product at its width (nb = 2 NP) and its epilogue
template <class ALoad, class Epi>
__device__ __forceinline__ void w_pass(const WPlan& p, const WRing& rg, int& slab,
                                       const WPass& ps, int wg, const ALoad& aload,
                                       const Epi& epi) {
  if (ps.nb == 256) {
    float acc[64];
    w_product<128>(acc, p, rg, slab, ps, wg, aload, true);
    epi.template apply<128>(acc, ps.n0 + wg * 128);
  } else {
    float acc[32];
    w_product<64>(acc, p, rg, slab, ps, wg, aload, true);
    epi.template apply<64>(acc, ps.n0 + wg * 64);
  }
}

// layer 1 of the tile into a1 (bf16 rows of the padded width + 8), passes
// [0, n1), once its input has landed
__device__ __forceinline__ void w_layer1(const WPlan& p, const WRing& rg, int& slab,
                                         int wg, const AFromInput& ain, uint16_t* A1,
                                         const float* B1) {
  if (p.cf) mbar_wait(rg.xin, 0);
  for (int i = 0; i < p.n1; ++i)
    w_pass(p, rg, slab, p.pass[i], wg, ain, Entries<ReluQ>{{A1, p.c1q + 8, B1}});
  named_bar_sync(1, 256);  // a1 is whole; the input is read
}

// layer 2 of the tile into a2, passes [n1, n1 + n2)
__device__ __forceinline__ void w_layer2(const WPlan& p, const WRing& rg, int& slab,
                                         int wg, uint16_t* A1, uint16_t* A2, const float* B2) {
  for (int i = p.n1; i < p.n1 + p.n2; ++i)
    w_pass(p, rg, slab, p.pass[i], wg, AFromSmem{A1, p.c1q + 8},
           Entries<ReluQ>{{A2, p.c2q + 8, B2}});
  named_bar_sync(1, 256);  // a2 is whole
}

__global__ void __launch_bounds__(kWThreads, 1)
gmlp_bf16_fwd_wgmma(const uint16_t* __restrict__ gx, const uint16_t* __restrict__ gf,
                    const char* __restrict__ pf, const float* __restrict__ b1,
                    const float* __restrict__ b2, const float* __restrict__ b3,
                    const __grid_constant__ WPlan p, float* __restrict__ pooled,
                    int* __restrict__ cnt, float* __restrict__ pmax, int* __restrict__ pcnt) {
  extern __shared__ __align__(16) float smem[];
  char* base = reinterpret_cast<char*>(smem);
  const WRing rg = ring_of(base, p);
  const int t = blockIdx.x / p.splits, h = blockIdx.x % p.splits;
  const int l3 = p.n1 + p.n2;
  const int lo = l3 + h * p.n3 / p.splits, hi = l3 + (h + 1) * p.n3 / p.splits;
  uint16_t* A1 = reinterpret_cast<uint16_t*>(base + p.a1);
  uint16_t* A2 = reinterpret_cast<uint16_t*>(base + p.a2);
  const WFeed f{{pf, nullptr}, l3, lo, l3 + hi - lo, 0, 0, 0};
  const int warp = w_start(p, rg, f, t, gf, A2);
  const int wg = warp >> 2;
  const WRows rw = w_rows(p, t);
  float* B = reinterpret_cast<float*>(base + p.bias);
  w_biases(p, B, b1, b2, b3);
  named_bar_sync(1, 256);  // the biases are in
  float* pm = reinterpret_cast<float*>(base + p.aux) + (size_t)wg * 8 * p.lp;
  int slab = 0;
  w_layer1(p, rg, slab, wg, x_fragment(gx, A2, p.cf, rw), A1, B);
  w_layer2(p, rg, slab, wg, A1, A2, B + p.c1q);
  const WPool pool{&p, pm, reinterpret_cast<int*>(pm + 4 * p.lp), B + p.c1q + p.c2q, rw, t,
                   wg, pooled, pmax, cnt, pcnt};
  for (int i = lo; i < hi; ++i)
    w_pass(p, rg, slab, p.pass[i], wg, AFromSmem{A2, p.c2q + 8}, pool);
}

__global__ void __launch_bounds__(kWThreads, 1)
gmlp_bf16_bwd_wgmma(const uint16_t* __restrict__ gx, const uint16_t* __restrict__ gf,
                    const char* __restrict__ pf, const char* __restrict__ pb,
                    const uint16_t* __restrict__ w3t, const float* __restrict__ b1,
                    const float* __restrict__ b2, const float* __restrict__ b3,
                    const float* __restrict__ pooled, const int* __restrict__ cnt,
                    const float* __restrict__ gout, const __grid_constant__ WPlan p,
                    float* __restrict__ dgx, float* __restrict__ dgf) {
  extern __shared__ __align__(16) float smem[];
  char* base = reinterpret_cast<char*>(smem);
  const WRing rg = ring_of(base, p);
  const int t = blockIdx.x;
  uint16_t* A1 = reinterpret_cast<uint16_t*>(base + p.a1);
  uint16_t* A2 = reinterpret_cast<uint16_t*>(base + p.a2);
  uint32_t* H = reinterpret_cast<uint32_t*>(base + p.aux);
  float* P = reinterpret_cast<float*>(H + kWRows * p.c3q / 32);
  float* Q = P + (size_t)p.gpt * p.c3q;
  const WFeed f{{pf, pb}, p.npass, p.npass, p.npass, 0, 0, 0};
  const int warp = w_start(p, rg, f, t, gf, A2);
  const int wg = warp >> 2;
  const WRows rw = w_rows(p, t);
  float* B = reinterpret_cast<float*>(base + p.bias);
  w_biases(p, B, b1, b2, b3);
  named_bar_sync(1, 256);  // the biases are in
  int slab = 0;
  w_layer1(p, rg, slab, wg, x_fragment(gx, A2, p.cf, rw), A1, B);
  {  // over the input: no hits yet, the tile's groups' maxima and g / cnt
    const int ng = w_groups(p, t);
    const size_t g0 = p.parts > 1 ? (size_t)t / p.parts : (size_t)t * p.gpt;
    for (int o = threadIdx.x; o < kWRows * p.c3q / 32; o += kWThreads) H[o] = 0u;
    for (int o = threadIdx.x; o < p.gpt * p.c3q; o += kWThreads) {
      const int gi = o / p.c3q, c = o - gi * p.c3q;
      const bool ok = gi < ng && c < p.c3;
      const size_t at = (g0 + gi) * p.c3 + c;
      P[o] = ok ? pooled[at] : -1.0f;
      Q[o] = ok ? gout[at] / (float)cnt[at] : 0.0f;
    }
  }
  w_layer2(p, rg, slab, wg, A1, A2, B + p.c1q);  // (its barrier: H, P and Q are in)
  int ip = p.n1 + p.n2;
  for (; ip < p.npf; ++ip)  // layer 3 again: dz3's hits
    w_pass(p, rg, slab, p.pass[ip], wg, AFromSmem{A2, p.c2q + 8},
           Entries<HitQ>{{H, B + p.c1q + p.c2q, P, p.c3q, rw}});
  named_bar_sync(1, 256);  // every hit is marked; no product reads a2 now
  w_dz2(p, H, Q, w3t, A2);
  named_bar_sync(1, 256);
  for (int i = 0; i < p.n4; ++i, ++ip)  // dz1 over a1, masked by it
    w_pass(p, rg, slab, p.pass[ip], wg, AFromSmem{A2, p.c2q + 8},
           Entries<MaskedQ>{{A1, p.c1q + 8}});
  named_bar_sync(1, 256);
  for (; ip < p.npass; ++ip)
    w_pass(p, rg, slab, p.pass[ip], wg, AFromSmem{A1, p.c1q + 8},
           Entries<DgOut>{{dgx, dgf, p.cf, rw}});
}

cudaError_t launch_w_fwd(const WPlan& p, const void* gx, const void* gf, const void* pf,
                         const float* b1, const float* b2, const float* b3, float* pooled,
                         int* cnt, float* pmax, int* pcnt, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gmlp_bf16_fwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geoa3::kSmemMax);
  if (attr != cudaSuccess) return attr;
  gmlp_bf16_fwd_wgmma<<<p.tiles * p.splits, kWThreads, p.smem, st>>>(
      static_cast<const uint16_t*>(gx), static_cast<const uint16_t*>(gf),
      static_cast<const char*>(pf), b1, b2, b3, p, pooled, cnt, pmax, pcnt);
  return cudaGetLastError();
}

cudaError_t launch_w_bwd(const WPlan& p, const void* gx, const void* gf, const void* pf,
                         const void* pb, const void* w3t, const float* b1, const float* b2,
                         const float* b3, const float* pooled, const int* cnt, const float* g,
                         float* dgx, float* dgf, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gmlp_bf16_bwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geoa3::kSmemMax);
  if (attr != cudaSuccess) return attr;
  gmlp_bf16_bwd_wgmma<<<p.tiles, kWThreads, p.smem, st>>>(
      static_cast<const uint16_t*>(gx), static_cast<const uint16_t*>(gf),
      static_cast<const char*>(pf), static_cast<const char*>(pb),
      static_cast<const uint16_t*>(w3t), b1, b2, b3, pooled, cnt, g, p, dgx, dgf);
  return cudaGetLastError();
}

// a direction's plan as its C entry picks it: the resident kernel where
// res_plan fits, else the streamed one where wgmma_plan does, else the
// staged one
enum Kind { kResident, kStreamed, kStaged };

struct Plan {
  Shape s;
  Res r;
  WPlan w;
  Kind kind;
  int parts() const { return kind == kStreamed ? w.parts : s.parts; }
  int tiles() const { return kind == kStreamed ? w.tiles : s.tiles; }
};

bool plan_of(Plan& p, int groups, int ns, int cf, int c1, int c2, int c3, bool bwd) {
  p.kind = kResident;
  if (res_plan(p.s, p.r, groups, ns, cf, c1, c2, c3, bwd)) return true;
  p.kind = kStreamed;
  if (wgmma_plan(p.w, groups, ns, cf, c1, c2, c3, bwd, res_sms())) return true;
  p.kind = kStaged;
  return make_shape(p.s, groups, ns, cf, c1, c2, c3, bwd);
}

template <int BM>
cudaError_t launch_fwd(const Shape& s, const void* gx, const void* gf, const void* w1,
                       const float* b1, const void* w2, const float* b2,
                       const void* w3, const float* b3, float* pooled, int* cnt,
                       float* pmax, int* pcnt, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gmlp_bf16_fwd_tiles<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)geoa3::kSmemMax);
  if (attr != cudaSuccess) return attr;
  gmlp_bf16_fwd_tiles<BM><<<s.tiles, kThreads, fwd_smem(BM, s.c1p, s.c2p), st>>>(
      static_cast<const uint16_t*>(gx), static_cast<const uint16_t*>(gf),
      static_cast<const uint16_t*>(w1), b1, static_cast<const uint16_t*>(w2), b2,
      static_cast<const uint16_t*>(w3), b3, s, pooled, cnt, pmax, pcnt);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_bwd(const Shape& s, const void* gx, const void* gf, const void* w1,
                       const float* b1, const void* w2, const float* b2,
                       const void* w3, const float* b3, const void* w1t,
                       const void* w2t, const void* w3t, const float* pooled,
                       const int* cnt, const float* g, float* dgx, float* dgf,
                       cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gmlp_bf16_bwd_tiles<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)geoa3::kSmemMax);
  if (attr != cudaSuccess) return attr;
  gmlp_bf16_bwd_tiles<BM><<<s.tiles, kThreads, bwd_smem(BM, s.c1p, s.c2p, s.c3p), st>>>(
      static_cast<const uint16_t*>(gx), static_cast<const uint16_t*>(gf),
      static_cast<const uint16_t*>(w1), b1, static_cast<const uint16_t*>(w2), b2,
      static_cast<const uint16_t*>(w3), b3, static_cast<const uint16_t*>(w1t),
      static_cast<const uint16_t*>(w2t), static_cast<const uint16_t*>(w3t), pooled,
      cnt, g, s, dgx, dgf);
  return cudaGetLastError();
}

}  // namespace

// gx [groups, ns, 3] bf16, gf [groups, ns, cf] bf16 (or null; cf % 16 == 0,
// 16-byte aligned), w1 [16 + cf, c1p], w2 [c1p, c2p], w3 [c2p, c3p] bf16
// and b_i [c_ip] float32, zero-padded (c_ip: c_i rounded up to 16), pf the
// streamed kernel's weights (`wgmma_plan`'s forward passes, packed) ->
// pooled, cnt [groups, c3]. scratch: 2 groups parts c3 ints where a group
// is split (ns above the tile's rows), else unused. One launch (and the
// finishing kernel's where a group is split): the resident kernel where
// its plan fits, else the streamed one where its plan does, else the staged
// one.
extern "C" int geoa3_group_mlp_fwd_bf16(const void* gx, const void* gf, const void* w1,
                                        const float* b1, const void* w2,
                                        const float* b2, const void* w3,
                                        const float* b3, const void* pf, int groups,
                                        int ns, int cf, int c1, int c2, int c3,
                                        float* pooled, int* cnt, void* scratch,
                                        void* stream) {
  Plan p;
  if (cf % 16 || !plan_of(p, groups, ns, cf, c1, c2, c3, false))
    return (int)cudaErrorInvalidValue;
  const Shape& s = p.s;
  const int parts = p.parts();
  if (p.tiles() == 0) return 0;
  if (parts > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pmax = parts > 1 ? static_cast<float*>(scratch) : nullptr;
  int* pcnt = parts > 1 ? reinterpret_cast<int*>(pmax + (size_t)groups * parts * c3) : nullptr;
  cudaError_t e;
  if (p.kind == kResident) {
    e = launch_res_fwd(s, p.r, gx, gf, w1, b1, w2, b2, w3, b3, pooled, cnt, pmax, pcnt, st);
  } else if (p.kind == kStreamed) {
    e = launch_w_fwd(p.w, gx, gf, pf, b1, b2, b3, pooled, cnt, pmax, pcnt, st);
  } else {
    switch (s.rows) {
      case 128: e = launch_fwd<128>(s, gx, gf, w1, b1, w2, b2, w3, b3, pooled, cnt, pmax, pcnt, st); break;
      case 64: e = launch_fwd<64>(s, gx, gf, w1, b1, w2, b2, w3, b3, pooled, cnt, pmax, pcnt, st); break;
      case 32: e = launch_fwd<32>(s, gx, gf, w1, b1, w2, b2, w3, b3, pooled, cnt, pmax, pcnt, st); break;
      default: e = launch_fwd<16>(s, gx, gf, w1, b1, w2, b2, w3, b3, pooled, cnt, pmax, pcnt, st); break;
    }
  }
  if (e != cudaSuccess || parts == 1) return (int)e;
  const size_t n = (size_t)groups * c3;
  gmlp_bf16_fwd_finish<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      pmax, pcnt, groups, parts, c3, pooled, cnt);
  return (int)cudaGetLastError();
}

// The cotangents of geoa3_group_mlp_fwd_bf16's inputs for the pooled
// cotangent g [groups, c3] float32, given its pooled and cnt -> dgx
// [groups, ns, 3] and dgf [groups, ns, cf] (or null; 16-byte aligned)
// float32. w1t, w2t, w3t: the padded weights transposed (read by the staged
// kernel only); pf, pb: the streamed kernel's weights (`wgmma_plan`'s
// backward passes, packed: the first npf from pf, the rest from pb). One
// launch: the resident kernel where its plan fits, else the streamed one
// where its plan does, else the staged one.
extern "C" int geoa3_group_mlp_bwd_bf16(const void* gx, const void* gf, const void* w1,
                                        const float* b1, const void* w2,
                                        const float* b2, const void* w3,
                                        const float* b3, const void* w1t,
                                        const void* w2t, const void* w3t, const void* pf,
                                        const void* pb, const float* pooled,
                                        const int* cnt, const float* g, int groups,
                                        int ns, int cf, int c1, int c2, int c3,
                                        float* dgx, float* dgf, void* stream) {
  Plan p;
  if (cf % 16 || reinterpret_cast<uintptr_t>(dgf) % 16 ||
      !plan_of(p, groups, ns, cf, c1, c2, c3, true))
    return (int)cudaErrorInvalidValue;
  const Shape& s = p.s;
  if (p.tiles() == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.kind == kResident)
    return (int)launch_res_bwd(s, p.r, gx, gf, w1, b1, w2, b2, w3, b3, pooled, cnt, g, dgx,
                               dgf, st);
  if (p.kind == kStreamed) {
    return (int)launch_w_bwd(p.w, gx, gf, pf, pb, w3t, b1, b2, b3, pooled, cnt, g, dgx, dgf,
                             st);
  }
  switch (s.rows) {
    case 128: return (int)launch_bwd<128>(s, gx, gf, w1, b1, w2, b2, w3, b3, w1t, w2t, w3t, pooled, cnt, g, dgx, dgf, st);
    case 64: return (int)launch_bwd<64>(s, gx, gf, w1, b1, w2, b2, w3, b3, w1t, w2t, w3t, pooled, cnt, g, dgx, dgf, st);
    case 32: return (int)launch_bwd<32>(s, gx, gf, w1, b1, w2, b2, w3, b3, w1t, w2t, w3t, pooled, cnt, g, dgx, dgf, st);
    default: return (int)launch_bwd<16>(s, gx, gf, w1, b1, w2, b2, w3, b3, w1t, w2t, w3t, pooled, cnt, g, dgx, dgf, st);
  }
}
