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
// is 26.2 GFLOP forward, 0.026 ms). A simple kernel first (mma.sync, no
// wgmma, TMA or warp specialisation):
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
//  - the backward recomputes the tile with the forward's own code, so z1,
//    z2, z3 and the ties are bitwise the forward's (an output's value
//    depends only on its row, its column and the k order, not on the tile
//    height), then runs dz3 W3^T, dz2 W2^T and dz1 W1^T on the same loop,
//    each ReLU mask read from a1 / a2 (zero exactly where z <= 0, but for
//    0 < z < 2^-134, which bf16 rounds to 0) and overwritten in place by
//    the cotangent.
#include "mma_bf16.cuh"

#include <math.h>

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
// and b_i [c_ip] float32, zero-padded (c_ip: c_i rounded up to 16) ->
// pooled, cnt [groups, c3]. scratch: 2 groups parts c3 ints where a group
// is split (ns above the tile's rows), else unused.
extern "C" int geoa3_group_mlp_fwd_bf16(const void* gx, const void* gf, const void* w1,
                                        const float* b1, const void* w2,
                                        const float* b2, const void* w3,
                                        const float* b3, int groups, int ns, int cf,
                                        int c1, int c2, int c3, float* pooled,
                                        int* cnt, void* scratch, void* stream) {
  Shape s;
  if (!make_shape(s, groups, ns, cf, c1, c2, c3, false) || cf % 16)
    return (int)cudaErrorInvalidValue;
  if (s.tiles == 0) return 0;
  if (s.parts > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pmax = s.parts > 1 ? static_cast<float*>(scratch) : nullptr;
  int* pcnt = s.parts > 1 ? reinterpret_cast<int*>(pmax + (size_t)groups * s.parts * c3)
                          : nullptr;
  cudaError_t e;
  switch (s.rows) {
    case 128: e = launch_fwd<128>(s, gx, gf, w1, b1, w2, b2, w3, b3, pooled, cnt, pmax, pcnt, st); break;
    case 64: e = launch_fwd<64>(s, gx, gf, w1, b1, w2, b2, w3, b3, pooled, cnt, pmax, pcnt, st); break;
    case 32: e = launch_fwd<32>(s, gx, gf, w1, b1, w2, b2, w3, b3, pooled, cnt, pmax, pcnt, st); break;
    default: e = launch_fwd<16>(s, gx, gf, w1, b1, w2, b2, w3, b3, pooled, cnt, pmax, pcnt, st); break;
  }
  if (e != cudaSuccess || s.parts == 1) return (int)e;
  const size_t n = (size_t)groups * c3;
  gmlp_bf16_fwd_finish<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      pmax, pcnt, groups, s.parts, c3, pooled, cnt);
  return (int)cudaGetLastError();
}

// The cotangents of geoa3_group_mlp_fwd_bf16's inputs for the pooled
// cotangent g [groups, c3] float32, given its pooled and cnt -> dgx
// [groups, ns, 3] and dgf [groups, ns, cf] (or null) float32. w1t, w2t,
// w3t: the padded weights transposed.
extern "C" int geoa3_group_mlp_bwd_bf16(const void* gx, const void* gf, const void* w1,
                                        const float* b1, const void* w2,
                                        const float* b2, const void* w3,
                                        const float* b3, const void* w1t,
                                        const void* w2t, const void* w3t,
                                        const float* pooled, const int* cnt,
                                        const float* g, int groups, int ns, int cf,
                                        int c1, int c2, int c3, float* dgx,
                                        float* dgf, void* stream) {
  Shape s;
  if (!make_shape(s, groups, ns, cf, c1, c2, c3, true) || cf % 16)
    return (int)cudaErrorInvalidValue;
  if (s.tiles == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (s.rows) {
    case 128: return (int)launch_bwd<128>(s, gx, gf, w1, b1, w2, b2, w3, b3, w1t, w2t, w3t, pooled, cnt, g, dgx, dgf, st);
    case 64: return (int)launch_bwd<64>(s, gx, gf, w1, b1, w2, b2, w3, b3, w1t, w2t, w3t, pooled, cnt, g, dgx, dgf, st);
    case 32: return (int)launch_bwd<32>(s, gx, gf, w1, b1, w2, b2, w3, b3, w1t, w2t, w3t, pooled, cnt, g, dgx, dgf, st);
    default: return (int)launch_bwd<16>(s, gx, gf, w1, b1, w2, b2, w3, b3, w1t, w2t, w3t, pooled, cnt, g, dgx, dgf, st);
  }
}
