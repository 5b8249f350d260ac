// The folded-BN affine (1x1, or kernel-3 conv over points) fused with the
// global max over points, and its input gradient, in the single-pass bf16
// mode: the bf16 victim's three global pools (--victim_dtype bfloat16), on
// Hopper's tensor cores.
//
// Replaces geoa3_tpu/ops/pallas/pool_matmul_kernel.py:_fwd_kernel and
// _bwd_kernel with f32_exact=False (`_mm` / `_mm_t`,
// geoa3_tpu/ops/pallas/group_mlp_kernel.py:46-100), seg = whole cloud:
//   z[b,p,c]    = sum_t sum_k bf16(x[b,p+t-1,k]) bf16(w3[t,k,c]) + bias[c]
//                 (exact products, float32 sums; zero rows outside [0,n);
//                 taps 1 uses x[b,p,k] alone)
//   pooled[b,c] = max_p z[b,p,c]
//   dx          = sum over the rows tied at the max of
//                 bf16(g[b,c]/cnt[b,c]) * w3[t,:,c], shifted by tap
// w3 (and w3t, the same as [taps, cout, cin]) is bf16; x is bf16 (the bf16
// victim's input T-Net) or float32 (its feature T-Net and conv5), rounded
// to bf16 here with cvt.rn as the TPU kernel's `_mm` rounds it; bias is
// float32. dx is float32 (the wrapper casts it to x's type).
//
// Bound on the H100: operations, on the tensor cores (989 TFLOP/s of
// bf16): conv5 at [32,1024,128] -> 1024 with 3 taps is 25.8 GFLOP (0.026
// ms) against 17 MB of float32 input; a T-Net pool 8.6 GFLOP. The
// [b,n,1024] activation never reaches device memory. A simple kernel first
// (mma.sync; wgmma, TMA and warp specialisation are later work):
//  - a block owns 128 output channels of one cloud (grid cout/128 x B) and
//    walks the cloud's point tiles of 128, so the max needs no second pass;
//    the block's weights w3[:, :, c0:c0+128] are staged once, as bf16, in
//    shared memory, for every tile;
//  - a tile's x rows p0-1 .. p0+128 arrive by 16-byte cp.async in a staging
//    buffer while the tile before computes, and are converted into a bf16
//    slab (cvt.rn.bf16x2.f32) that every tap reads one row further down, so
//    x crosses L2 once, not once a tap; rows sit 16 bytes apart from a
//    multiple of 128, so the eight rows an ldmatrix phase reads hit all 32
//    banks once;
//  - 8 warps as 4 (rows) x 2 (channels), 32 x 64 outputs a warp: a 16-deep
//    k step is two ldmatrix.x4 of x, four ldmatrix.x4.trans of w3 and
//    sixteen mma.sync.m16n8k16 bf16 products with float32 accumulators;
//  - the epilogue finds a column's maximum over a warp's 32 rows by
//    shuffles and its tied rows by ballots; one thread a column merges the
//    four warps' partials in row order into the column's state (maximum,
//    tie count, first kMaxTies tied rows ascending, 0 past the count), as
//    the float32 kernel merges its tiles; a warp whose four columns all lie
//    below their running maxima skips the ballots.
// Every output is the same chain of mma over the (tap, k) steps from 0,
// then __fadd_rn of the bias, whatever its row or column, so identical rows
// give identical z. The backward is the float32 kernel's: a warp per
// column adds bf16(g/cnt) * w3[t,:,c] into dx at the recorded rows
// (atomicAdd; the products are exact, the sums vary in the last bits from
// run to run). A column with more than kMaxTies ties is recomputed 16 rows
// at a time by the forward's own mma instruction on the same bf16 operands
// in the same (tap, k) order, so it finds the forward's ties.
#include "mma_bf16.cuh"

#include <math.h>

namespace {

constexpr int BM = 128;       // points per tile
constexpr int BN = 128;       // output channels per block
constexpr int kThreads = 256;
constexpr int kWarpsM = 4;    // warps along the rows (32 rows each)
constexpr int kMaxTies = 4;
constexpr int kBwdWarps = 8;
constexpr int kPad = 8;       // bf16 of padding after a shared row (16 bytes)

__device__ __forceinline__ int tap_shift(int taps, int t) {
  return taps == 3 ? t - 1 : 0;
}

// two consecutive values of a row as a bf16 pair (low half first)
__device__ __forceinline__ uint32_t load_bf16x2(const float* p) {
  return cvt_rn_bf16x2(p[0], p[1]);
}
__device__ __forceinline__ uint32_t load_bf16x2(const uint16_t* p) {
  return p[0] | (static_cast<uint32_t>(p[1]) << 16);
}

// eight staged values into the bf16 slab (16 bytes)
__device__ __forceinline__ void to_bf16x8(uint16_t* dst, const float* src) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(cvt_rn_bf16x2(a.x, a.y), cvt_rn_bf16x2(a.z, a.w),
                 cvt_rn_bf16x2(b.x, b.y), cvt_rn_bf16x2(b.z, b.w));
}
__device__ __forceinline__ void to_bf16x8(uint16_t* dst, const uint16_t* src) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

// the block's shared memory: weights [taps cin][BN + kPad] bf16, the slab
// [BM + 2][cin + kPad] bf16, the staging buffer [BM + 2][cin] of x's type,
// the warps' partials (maximum, count, four row offsets in bytes) and the
// columns' states
size_t pool_bf16_smem(int cin, int taps, int xbytes) {
  return (size_t)taps * cin * (BN + kPad) * 2 +
         (size_t)(BM + 2) * (cin + kPad) * 2 + (size_t)(BM + 2) * cin * xbytes +
         (size_t)kWarpsM * BN * 3 * 4 + (size_t)BN * (2 + kMaxTies) * 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
pool_fwd_bf16_kernel(const T* __restrict__ x, const uint16_t* __restrict__ w3,
                     const float* __restrict__ bias, int n, int cin, int cout,
                     int taps, float* __restrict__ pooled,
                     int* __restrict__ cnt, int* __restrict__ rows) {
  extern __shared__ __align__(16) float smem[];
  const int ldw = BN + kPad, ldx = cin + kPad;
  const int halo = taps == 3 ? 1 : 0;
  const int slab = BM + 2 * halo;
  uint16_t* Ws = reinterpret_cast<uint16_t*>(smem);
  uint16_t* Xs = Ws + (size_t)taps * cin * ldw;
  T* St = reinterpret_cast<T*>(Xs + (size_t)(BM + 2) * ldx);
  float* part_mx = reinterpret_cast<float*>(St + (size_t)(BM + 2) * cin);
  int* part_cnt = reinterpret_cast<int*>(part_mx + kWarpsM * BN);
  int* part_rows = part_cnt + kWarpsM * BN;
  float* col_mx = reinterpret_cast<float*>(part_rows + kWarpsM * BN);
  int* col_cnt = reinterpret_cast<int*>(col_mx + BN);
  int* col_rows = col_cnt + BN;  // [BN][kMaxTies]

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;  // rows wm*32, cols wn*64
  const int g = lane >> 2, q = lane & 3;               // a fragment's row, pair
  const T* X = x + (size_t)b * n * cin;

  if (tid < BN) {
    col_mx[tid] = -INFINITY;
    col_cnt[tid] = 0;
#pragma unroll
    for (int s = 0; s < kMaxTies; ++s) col_rows[tid * kMaxTies + s] = 0;
  }
  // the block's weights, once: row t cin + k of w3 is w3[t, k, :]
  for (int i = tid; i < taps * cin * (BN / 8); i += kThreads) {
    const int r = i / (BN / 8), cc = (i - r * (BN / 8)) * 8;
    cp_async16z(Ws + (size_t)r * ldw + cc, w3 + (size_t)r * cout + c0 + cc, 16);
  }
  constexpr int kPer = 16 / (int)sizeof(T);  // x values a 16-byte copy
  auto load_x = [&](int p0) {
    const int per_row = cin / kPer;
    for (int i = tid; i < slab * per_row; i += kThreads) {
      const int r = i / per_row, k = (i - r * per_row) * kPer;
      const int p = p0 - halo + r;
      const bool ok = p >= 0 && p < n;
      cp_async16z(St + (size_t)r * cin + k, ok ? X + (size_t)p * cin + k : X,
                  ok ? 16 : 0);
    }
  };
  load_x(0);
  cp_async_commit();

  const int tiles = (n + BM - 1) / BM;
  const int ksteps = cin / 16;
  for (int tile = 0; tile < tiles; ++tile) {
    const int p0 = tile * BM;
    cp_async_wait<0>();
    __syncthreads();  // the staged rows are in; the last merge is done
    for (int i = tid; i < slab * (cin / 8); i += kThreads) {
      const int r = i / (cin / 8), k = (i - r * (cin / 8)) * 8;
      to_bf16x8(Xs + (size_t)r * ldx + k, St + (size_t)r * cin + k);
    }
    __syncthreads();  // the slab is whole; the staging buffer is free
    if (tile + 1 < tiles) load_x(p0 + BM);
    cp_async_commit();

    float acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;

    for (int t = 0; t < taps; ++t) {
      // output row r reads slab row r + t (slab row 0 is p0 - halo)
      const uint16_t* xa = Xs + (size_t)(wm * 32 + (lane & 15) + (taps == 3 ? t : 0)) * ldx +
                           (lane >> 4) * 8;
      const uint16_t* wb = Ws + (size_t)(t * cin + ((lane >> 3) & 1) * 8 + (lane & 7)) * ldw +
                           wn * 64 + (lane >> 4) * 8;
      for (int ks = 0; ks < ksteps; ++ks) {
        const int k0 = ks * 16;
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4(a[mi], xa + (size_t)mi * 16 * ldx + k0);
        uint32_t bf[8][2];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t r4[4];
          ldmatrix_x4_trans(r4, wb + (size_t)k0 * ldw + jj * 16);
          bf[2 * jj][0] = r4[0];
          bf[2 * jj][1] = r4[1];
          bf[2 * jj + 1][0] = r4[2];
          bf[2 * jj + 1][1] = r4[3];
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            mma_m16n8k16_bf16(acc[mi][j], a[mi], bf[j][0], bf[j][1]);
      }
    }

    // a column's maximum over this warp's 32 rows and its tied rows: slot s
    // of a lane holds row 8 s + g (acc[s / 2][j][2 (s % 2) + e])
    const int rbase = p0 + wm * 32;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = wn * 64 + j * 8 + 2 * q + e;
        const float bj = __ldg(bias + c0 + cl);
        float z[4];
        bool ok[4];
        float m = -INFINITY;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          z[s] = __fadd_rn(acc[s >> 1][j][(s & 1) * 2 + e], bj);
          ok[s] = rbase + s * 8 + g < n;
          if (ok[s]) m = fmaxf(m, z[s]);
        }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          m = fmaxf(m, __shfl_xor_sync(GEOA3_FULL_MASK, m, off));
        int tcnt = 0, packed = 0;
        // col_mx changes only in the merge, between barriers
        if (!__all_sync(GEOA3_FULL_MASK, m < col_mx[cl])) {
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const unsigned bal = __ballot_sync(GEOA3_FULL_MASK, ok[s] && z[s] == m);
            // this column's lanes are q, q + 4, ..: row 8 s + (bit / 4)
            unsigned mine = (bal >> q) & 0x11111111u;
            while (mine != 0u && tcnt < kMaxTies) {
              packed |= (s * 8 + ((__ffs(mine) - 1) >> 2)) << (8 * tcnt);
              ++tcnt;
              mine &= mine - 1u;
            }
            tcnt += __popc(mine);
          }
        }
        if (g == j) {
          const int o = wm * BN + cl;
          part_mx[o] = m;
          part_cnt[o] = m < col_mx[cl] ? 0 : tcnt;
          part_rows[o] = packed;
        }
      }
    }
    __syncthreads();
    if (tid < BN) {  // the column's owner merges the warps' rows in order
      float mx = col_mx[tid];
      int ct = col_cnt[tid];
      int* cr = col_rows + tid * kMaxTies;
      for (int w = 0; w < kWarpsM; ++w) {
        const int o = w * BN + tid;
        const int pc = part_cnt[o];
        if (pc == 0) continue;
        const float pm = part_mx[o];
        const int pr = part_rows[o];
        const int base = p0 + w * 32;
        if (ct == 0 || pm > mx) {
          mx = pm;
          ct = pc;
#pragma unroll
          for (int s = 0; s < kMaxTies; ++s)
            cr[s] = s < pc ? base + ((pr >> (8 * s)) & 255) : 0;
        } else if (pm == mx) {
          for (int s = 0; s < pc && ct + s < kMaxTies; ++s)
            cr[ct + s] = base + ((pr >> (8 * s)) & 255);
          ct += pc;
        }
      }
      col_mx[tid] = mx;
      col_cnt[tid] = ct;
    }
  }
  cp_async_wait<0>();
  if (tid < BN) {
    const size_t o = (size_t)b * cout + c0 + tid;
    pooled[o] = col_mx[tid];
    cnt[o] = col_cnt[tid];
#pragma unroll
    for (int s = 0; s < kMaxTies; ++s)
      rows[o * kMaxTies + s] = col_rows[tid * kMaxTies + s];
  }
}

template <typename T>
__global__ void pool_bwd_bf16_kernel(const uint16_t* __restrict__ w3t,
                                     const float* __restrict__ g,
                                     const int* __restrict__ cnt,
                                     const int* __restrict__ rows,
                                     const T* __restrict__ x,
                                     const float* __restrict__ bias,
                                     const float* __restrict__ pooled,
                                     const uint16_t* __restrict__ w3, int n,
                                     int cin, int cout, int taps,
                                     float* __restrict__ dx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int c = blockIdx.x * kBwdWarps + warp;
  if (c >= cout) return;
  const size_t o = (size_t)b * cout + c;
  const float gv = g[o];
  if (gv == 0.0f) return;
  const int ct = cnt[o];
  // the TPU kernel's `_mm_t` takes the cotangent eq * g / cnt in bf16
  const float coef = round_bf16(gv / (float)ct);
  float* DX = dx + (size_t)b * n * cin;
  auto add_row = [&](int p) {  // the column's cotangent at output row p
    for (int t = 0; t < taps; ++t) {
      const int row = p + tap_shift(taps, t);
      if (row < 0 || row >= n) continue;
      const uint16_t* wr = w3t + ((size_t)t * cout + c) * cin;
      for (int k = lane; k < cin; k += 32)
        atomicAdd(DX + (size_t)row * cin + k, coef * bf16_to_float(wr[k]));
    }
  };
  if (ct <= kMaxTies) {
    for (int s = 0; s < ct; ++s) add_row(rows[o * kMaxTies + s]);
    return;
  }
  // more ties than were recorded: the forward's chain again, 16 rows at a
  // time, column c in every column of the B fragment; row p0 + gr in d[0],
  // p0 + gr + 8 in d[2]
  const T* X = x + (size_t)b * n * cin;
  const float zmax = pooled[o];
  const float bc = bias[c];
  const int gr = lane >> 2, q = lane & 3;
  for (int p0 = 0; p0 < n; p0 += 16) {
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int t = 0; t < taps; ++t) {
      for (int k0 = 0; k0 < cin; k0 += 16) {
        uint32_t a[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {  // a0 (g, 2q), a1 (g+8, 2q), a2 (g, 2q+8), a3
          const int pr = p0 + gr + (h & 1) * 8 + tap_shift(taps, t);
          const int kk = k0 + 2 * q + (h >> 1) * 8;
          a[h] = pr >= 0 && pr < n ? load_bf16x2(X + (size_t)pr * cin + kk) : 0u;
        }
        const uint16_t* wc = w3 + ((size_t)t * cin + k0 + 2 * q) * cout + c;
        const uint32_t b0 = wc[0] | (static_cast<uint32_t>(wc[cout]) << 16);
        const uint32_t b1 =
            wc[(size_t)8 * cout] | (static_cast<uint32_t>(wc[(size_t)9 * cout]) << 16);
        mma_m16n8k16_bf16(d, a, b0, b1);
      }
    }
    const bool hit0 = q == 0 && p0 + gr < n && __fadd_rn(d[0], bc) == zmax;
    const bool hit1 = q == 0 && p0 + gr + 8 < n && __fadd_rn(d[2], bc) == zmax;
    unsigned m0 = __ballot_sync(GEOA3_FULL_MASK, hit0);
    unsigned m1 = __ballot_sync(GEOA3_FULL_MASK, hit1);
    while (m0 != 0u) {
      add_row(p0 + ((__ffs(m0) - 1) >> 2));
      m0 &= m0 - 1u;
    }
    while (m1 != 0u) {
      add_row(p0 + 8 + ((__ffs(m1) - 1) >> 2));
      m1 &= m1 - 1u;
    }
  }
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w3, const float* bias,
                       int B, int n, int cin, int cout, int taps,
                       float* pooled, int* cnt, int* rows, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      pool_fwd_bf16_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)geoa3::kSmemMax);
  if (attr != cudaSuccess) return attr;
  dim3 grid(cout / BN, B);
  pool_fwd_bf16_kernel<T><<<grid, kThreads, pool_bf16_smem(cin, taps, sizeof(T)), s>>>(
      static_cast<const T*>(x), static_cast<const uint16_t*>(w3), bias, n, cin,
      cout, taps, pooled, cnt, rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* w3t, const float* g, const int* cnt,
                       const int* rows, const void* x, const float* bias,
                       const float* pooled, const void* w3, int B, int n,
                       int cin, int cout, int taps, float* dx, cudaStream_t s) {
  dim3 grid((cout + kBwdWarps - 1) / kBwdWarps, B);
  pool_bwd_bf16_kernel<T><<<grid, kBwdWarps * 32, 0, s>>>(
      static_cast<const uint16_t*>(w3t), g, cnt, rows, static_cast<const T*>(x),
      bias, pooled, static_cast<const uint16_t*>(w3), n, cin, cout, taps, dx);
  return cudaGetLastError();
}

}  // namespace

// x [B, n, cin] bf16 (x_bf16 != 0) or float32, w3 [taps, cin, cout] bf16,
// bias [cout] float32 -> pooled [B, cout], cnt [B, cout], rows
// [B, cout, kMaxTies]. cin % 16 == 0, cout % 128 == 0, and the block's
// shared memory (pool_bf16_smem) within the card's 232,448 bytes.
extern "C" int geoa3_pool_fwd_bf16(const void* x, const void* w3,
                                   const float* bias, int B, int n, int cin,
                                   int cout, int taps, int x_bf16,
                                   float* pooled, int* cnt, int* rows,
                                   void* stream) {
  if (pool_bf16_smem(cin, taps, x_bf16 ? 2 : 4) > geoa3::kSmemMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return (int)launch_fwd<uint16_t>(x, w3, bias, B, n, cin, cout, taps,
                                     pooled, cnt, rows, s);
  return (int)launch_fwd<float>(x, w3, bias, B, n, cin, cout, taps, pooled,
                                cnt, rows, s);
}

// The input cotangent of geoa3_pool_fwd_bf16 for the pooled cotangent g
// [B, cout] -> dx [B, n, cin] float32, zeroed here on the stream. w3t is w3
// as [taps, cout, cin] bf16.
extern "C" int geoa3_pool_bwd_bf16(const void* w3t, const float* g,
                                   const int* cnt, const int* rows,
                                   const void* x, const float* bias,
                                   const float* pooled, const void* w3, int B,
                                   int n, int cin, int cout, int taps,
                                   int x_bf16, float* dx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      cudaMemsetAsync(dx, 0, (size_t)B * n * cin * sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  if (x_bf16)
    return (int)launch_bwd<uint16_t>(w3t, g, cnt, rows, x, bias, pooled, w3,
                                     B, n, cin, cout, taps, dx, s);
  return (int)launch_bwd<float>(w3t, g, cnt, rows, x, bias, pooled, w3, B, n,
                                cin, cout, taps, dx, s);
}
