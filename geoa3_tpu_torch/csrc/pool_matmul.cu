// Folded-BN affine (1x1, or kernel-3 conv over points) fused with the global
// max over points, and its input gradient.
//
// Replaces geoa3_tpu/ops/pallas/pool_matmul_kernel.py:_fwd_kernel and
// _bwd_kernel for the global pool (seg = whole cloud):
//   z[b,p,c]      = sum_t sum_k x[b, p+t-1, k] w3[t,k,c] + bias[c]   (taps 3;
//                   zero rows outside [0,n); taps 1 uses x[b,p,k] alone)
//   pooled[b,c]   = max_p z[b,p,c]
//   dx            = sum over the rows tied at the max of g[b,c]/cnt[b,c] *
//                   w3[t,:,c], shifted by tap
//
// Bound on the H100: operations. At the main path's [32,1024,128] -> 1024
// with 3 taps the product is 25.8 GFLOP of float32 against 17 MB of input;
// the [b,n,1024] activation is never written. Every output is one fmaf chain
// from 0 in (tap, k) ascending order, then __fadd_rn of the bias: the
// backward's recompute path below repeats that chain to find the ties again.
//
// The forward (pool_fwd_kernel) is a float32 product on the FMA units (no
// tensor cores: the victim's numerics) laid out for them:
//  - a block owns 128 output channels of one cloud and walks the cloud's
//    point tiles of 128 (grid cout/128 x B: 256 blocks at the main path's
//    shapes, two a SM at ~102 KB of shared memory, one wave on 132 SMs), so
//    the max needs no second pass and no atomics;
//  - 256 threads, each with 8 rows x 8 channels (rows ty + 16 i, channels in
//    two 4-wide halves), so a k step is 64 FMAs per four 16-byte shared loads;
//  - the x rows p0-1 .. p0+128 of all cin channels are staged in shared
//    memory once a point tile with 16-byte cp.async copies (zero rows past
//    the cloud's ends); every tap reads this slab one row further down, so x
//    crosses L2 once, not once a tap. A thread reads 4 channels of a row as
//    one float4: rows sit cin + 4 floats apart, so the 8 rows a quarter-warp
//    reads start on 8 different 4-bank groups;
//  - the weights (w3, 1.5 MB, resident in L2) stream through a ring of four
//    cp.async stages of 16 x 128, so the next slabs' copies overlap the FMAs;
//  - the max epilogue runs on every thread: a column's maximum over the 16
//    row-groups of a half-warp is a shuffle reduction, and its tied rows in
//    ascending order (row 16 i + ty, i major) come from one ballot per i. A
//    column's state (maximum, tie count, first kMaxTies tied rows, 0 past the
//    count) lives in shared memory, owned by one thread, and merges each
//    tile's result: a larger maximum replaces it, an equal one adds its count
//    and appends its rows; a tile whose maximum is below the state's skips
//    the ballots. The result equals a serial scan of the rows.
// The backward then needs no second product: it is csrc/pool_gather.cuh's
// gather over dx's rows, pool_bwd_gather<GatherF32, TAPS>, shared with the
// bf16 pool: each dx row sums g/cnt * w3t[t,c,:] (float32 coefficient, each
// product rounded on its own) over its entries (column c, tap t) in a fixed
// order and is written once, so dx needs no memset and holds the same bits
// from run to run. A column with more than kMaxTies ties recomputes its z
// over the block's rows with the forward's exact chain (`tied_rows32`), so it
// finds the same ties. Bound on the H100: bytes, dx written once (16.8 MB at
// [32, 1024, 128]) plus g, cnt, the recorded rows and w3t read once.
#include "pool_gather.cuh"  // kMaxTies, the backward; mma_bf16.cuh's cp.async

#include <math.h>

namespace {

constexpr int BM = 128;  // points per tile
constexpr int BN = 128;  // output channels per block
constexpr int BK = 16;   // weight rows per pipeline stage
constexpr int kStages = 4;
constexpr int kSlabRows = BM + 2;  // one halo row above and below (taps 3)
constexpr int kThreads = 256;
constexpr int kSmemMax = 232448;  // a block's opt-in shared memory, H100

__device__ __forceinline__ float lane_of(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// row slot q of a tie list of kMaxTies named registers (q >= kMaxTies: none)
__device__ __forceinline__ void put_row(int (&r)[kMaxTies], int q, int row) {
#pragma unroll
  for (int s = 0; s < kMaxTies; ++s)
    if (q == s) r[s] = row;
}

size_t pool_fwd_smem(int cin) {
  return ((size_t)kSlabRows * (cin + 4) + (size_t)kStages * BK * BN) *
             sizeof(float) +
         (size_t)BN * (2 + kMaxTies) * sizeof(int);
}

__global__ void __launch_bounds__(kThreads, 2)
pool_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w3,
                const float* __restrict__ bias, int n, int cin, int cout,
                int taps, float* __restrict__ pooled, int* __restrict__ cnt,
                int* __restrict__ rows) {
  extern __shared__ __align__(16) float smem[];
  const int ldx = cin + 4;
  float* Xs = smem;                              // [kSlabRows][ldx]
  float* Ws = Xs + (size_t)kSlabRows * ldx;      // [kStages][BK][BN]
  float* col_mx = Ws + kStages * BK * BN;        // [BN]
  int* col_cnt = reinterpret_cast<int*>(col_mx + BN);   // [BN]
  int* col_rows = col_cnt + BN;                  // [BN][kMaxTies]

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ty = lane & 15;                      // row group: rows ty + 16 i
  const int tx = (tid >> 5) * 2 + (lane >> 4);   // channels tx*4.., 64+tx*4..
  const int halo = taps == 3 ? 1 : 0;
  const float* X = x + (size_t)b * n * cin;

  if (tid < BN) {
    col_mx[tid] = -INFINITY;
    col_cnt[tid] = 0;
#pragma unroll
    for (int q = 0; q < kMaxTies; ++q) col_rows[tid * kMaxTies + q] = 0;
  }

  const int kpt = cin / BK;  // pipeline steps a tap
  const int S = taps * kpt;  // steps a point tile
  const int T = (n + BM - 1) / BM;
  const int total = T * S;

  auto load_w = [&](int step, int stage) {
    const int t = step / kpt, k0 = (step - t * kpt) * BK;
    const float* src = w3 + ((size_t)t * cin + k0) * cout + c0;
    float* dst = Ws + stage * BK * BN;
#pragma unroll
    for (int q = tid; q < BK * BN / 4; q += kThreads) {
      const int kk = q / (BN / 4), cc = (q % (BN / 4)) * 4;
      cp_async16z(dst + kk * BN + cc, src + (size_t)kk * cout + cc, 16);
    }
  };
  auto load_x = [&](int p0) {
    const int per_row = cin / 4;
    for (int q = tid; q < kSlabRows * per_row; q += kThreads) {
      const int r = q / per_row, k = (q - r * per_row) * 4;
      const int p = p0 - halo + r;
      const bool ok = p >= 0 && p < n;
      cp_async16z(Xs + r * ldx + k, ok ? X + (size_t)p * cin + k : X,
                  ok ? 16 : 0);
    }
  };

  load_x(0);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < total) load_w(st % S, st);
    cp_async_commit();
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int g = 0; g < total; ++g) {
    const int tile = g / S, s = g - tile * S;
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      const int gn = g + kStages - 1;
      if (gn < total) load_w(gn % S, gn % kStages);
      cp_async_commit();
    }
    // tap t reads slab row r + t for output row r (slab row 0 is p0 - halo)
    const int t = s / kpt, k0 = (s - t * kpt) * BK;
    const float* xa = Xs + (ty + (taps == 3 ? t : 0)) * ldx + k0;
    const float* wb = Ws + (g % kStages) * BK * BN + tx * 4;
#pragma unroll
    for (int kc = 0; kc < BK; kc += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(xa + i * 16 * ldx + kc);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 w0 = *reinterpret_cast<const float4*>(wb + (kc + q) * BN);
        const float4 w1 =
            *reinterpret_cast<const float4*>(wb + (kc + q) * BN + 64);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = lane_of(a[i], q);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, wv[j], acc[i][j]);
        }
      }
    }
    if (s != S - 1) continue;

    // end of a point tile: stage the next slab while the epilogue runs
    const int p0 = tile * BM;
    __syncthreads();  // every warp is done reading this tile's slab
    if (tile + 1 < T) load_x(p0 + BM);
    cp_async_commit();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cl = j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4);
      const float bj = __ldg(bias + c0 + cl);
      float z[8];
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        z[i] = __fadd_rn(acc[i][j], bj);
        if (p0 + ty + 16 * i < n) m = fmaxf(m, z[i]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(GEOA3_FULL_MASK, m, off));
      // a tile below the column's running maximum changes nothing (most
      // tiles after the first few): the half-warp skips the tie scan
      const float cm = col_mx[cl];
      if (m < cm) continue;
      // this tile's tied rows in ascending order: row 16 i + ty, i major
      const unsigned half = 0xffffu << (lane & 16);
      int tcnt = 0;
      int tr[kMaxTies] = {0, 0, 0, 0};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const unsigned bal =
            __ballot_sync(half, p0 + ty + 16 * i < n && z[i] == m);
        unsigned mine = (bal >> (lane & 16)) & 0xffffu;
        while (mine != 0u && tcnt < kMaxTies) {
          put_row(tr, tcnt, p0 + 16 * i + __ffs(mine) - 1);
          ++tcnt;
          mine &= mine - 1u;
        }
        tcnt += __popc(mine);
      }
      if (ty == j && tcnt > 0) {  // the column's owner merges the tile
        int* cr = col_rows + cl * kMaxTies;
        if (col_cnt[cl] == 0 || m > cm) {
          col_mx[cl] = m;
          col_cnt[cl] = tcnt;
#pragma unroll
          for (int q = 0; q < kMaxTies; ++q) cr[q] = tr[q];
        } else if (m == cm) {
          const int base = col_cnt[cl];
#pragma unroll
          for (int q = 0; q < kMaxTies; ++q)
            if (q < tcnt && base + q < kMaxTies) cr[base + q] = tr[q];
          col_cnt[cl] = base + tcnt;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    cp_async_wait<0>();
  }
  cp_async_wait<0>();
  __syncthreads();
  if (tid < BN) {
    const size_t o = (size_t)b * cout + c0 + tid;
    pooled[o] = col_mx[tid];
    cnt[o] = col_cnt[tid];
#pragma unroll
    for (int q = 0; q < kMaxTies; ++q)
      rows[o * kMaxTies + q] = col_rows[tid * kMaxTies + q];
  }
}

// The forward's chain for column c at window rows p0 .. p0 + nrows - 1
// (nrows <= 32), one lane a row: fmaf over (tap, k) ascending from 0 with
// zero rows outside the cloud, then __fadd_rn of the bias, exactly as
// pool_fwd_kernel computes z. Bit j is set where row p0 + j lies in the
// cloud and its z equals zmax; every lane gets the same bits. Column c's
// weights come from w3t's contiguous rows t cout + c (w3's column c, the
// same values). Not inlined: the common path keeps its registers.
__device__ __noinline__ uint32_t tied_rows32(const float* X, const float* w3t, int n, int cin,
                                             int cout, int taps, int c, int p0, int nrows,
                                             float bc, float zmax, int lane) {
  const int p = p0 + lane;
  float acc = 0.0f;
  for (int t = 0; t < taps; ++t) {
    const int pr = p + tap_shift(taps, t);
    const bool in = pr >= 0 && pr < n;
    const float* xr = X + (size_t)(in ? pr : 0) * cin;
    const float* wr = w3t + ((size_t)t * cout + c) * cin;
    for (int k = 0; k < cin; k += 4) {
      const float4 xv = in ? *reinterpret_cast<const float4*>(xr + k)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float4 wv = __ldg(reinterpret_cast<const float4*>(wr + k));
      acc = fmaf(xv.x, wv.x, acc);
      acc = fmaf(xv.y, wv.y, acc);
      acc = fmaf(xv.z, wv.z, acc);
      acc = fmaf(xv.w, wv.w, acc);
    }
  }
  return __ballot_sync(GEOA3_FULL_MASK,
                       lane < nrows && p >= 0 && p < n && __fadd_rn(acc, bc) == zmax);
}

// The gather's precision policy (csrc/pool_gather.cuh) in float32: w3t's
// four channels as one float4, the coefficient g / cnt in float32, dx
// float32, the tied rows of a window found again by tied_rows32.
struct GatherF32 {
  using X = float;
  using W = float;
  using W4 = float4;
  __device__ static float coef(float g, int ct) { return g / (float)ct; }
  __device__ static float4 widen(float4 w) { return w; }
  __device__ static uint32_t tied_rows(const float* X, const float*, const float* w3t, int n,
                                       int cin, int cout, int taps, int c, int p0, int nrows,
                                       float bc, float zmax, int lane) {
    return tied_rows32(X, w3t, n, cin, cout, taps, c, p0, nrows, bc, zmax, lane);
  }
};

template <int TAPS>
cudaError_t launch_bwd(const float* w3t, const float* g, const int* cnt, const int* rows,
                       const float* x, const float* bias, const float* pooled, const float* w3,
                       int B, int n, int cin, int cout, float* dx, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      pool_bwd_gather<GatherF32, TAPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(BwdSmem));
  if (attr != cudaSuccess) return attr;
  dim3 grid((n + kBwdRows - 1) / kBwdRows, B);
  pool_bwd_gather<GatherF32, TAPS><<<grid, kBwdThreads, sizeof(BwdSmem), s>>>(
      w3t, g, cnt, rows, x, bias, pooled, w3, n, cin, cout, dx);
  return cudaGetLastError();
}

}  // namespace

extern "C" int geoa3_pool_fwd(const float* x, const float* w3,
                              const float* bias, int B, int n, int cin,
                              int cout, int taps, float* pooled, int* cnt,
                              int* rows, void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      pool_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(cout / BN, B);
  pool_fwd_kernel<<<grid, kThreads, pool_fwd_smem(cin),
                    static_cast<cudaStream_t>(stream)>>>(
      x, w3, bias, n, cin, cout, taps, pooled, cnt, rows);
  return (int)cudaGetLastError();
}

// The input cotangent of geoa3_pool_fwd for the pooled cotangent g
// [B, cout] -> dx [B, n, cin], every element written once (no memset). w3t
// is w3 as [taps, cout, cin]; g, cnt, rows, x, w3t and dx 16-byte aligned
// (bulk copies and float4 loads). cin % 16 == 0, cout % 128 == 0, taps 1 or
// 3: every shape geoa3_pool_fwd takes.
extern "C" int geoa3_pool_bwd(const float* w3t, const float* g, const int* cnt,
                              const int* rows, const float* x,
                              const float* bias, const float* pooled,
                              const float* w3, int B, int n, int cin, int cout,
                              int taps, float* dx, void* stream) {
  if (cin % 16 != 0 || cout % 128 != 0 || (taps != 1 && taps != 3) ||
      reinterpret_cast<uintptr_t>(g) % 16 || reinterpret_cast<uintptr_t>(cnt) % 16 ||
      reinterpret_cast<uintptr_t>(rows) % 16 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w3t) % 16 || reinterpret_cast<uintptr_t>(dx) % 16)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(taps == 3 ? launch_bwd<3>(w3t, g, cnt, rows, x, bias, pooled, w3, B, n, cin,
                                         cout, dx, s)
                         : launch_bwd<1>(w3t, g, cnt, rows, x, bias, pooled, w3, B, n, cin,
                                         cout, dx, s));
}
