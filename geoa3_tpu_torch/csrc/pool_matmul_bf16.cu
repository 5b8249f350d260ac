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
// ms) against 17 MB of float32 input; a T-Net pool 8.6 GFLOP (0.0087 ms),
// where the float32 x a block re-reads for its channels is 67 MB through
// L2. The [b,n,1024] activation never reaches device memory. The first
// design (mma.sync, one block of 8 warps an SM, x as the A operand) spent
// ten times its tensor-core work on what surrounds it: block-wide barriers,
// a conversion pass and a serial merge of the warps' partials on every
// tile. Measured on the H100 along the way (PERF.md): a bulk copy a
// row cost more than the products, and any epilogue that sees one point's
// row of channels (x as A) needs a warp's shuffles or a trip of z through
// shared memory to reach a column. So the forward,
// pool_fwd_bf16_kernel<T, NWG, KS>, swaps the operands: z^T = W^T x^T.
//  - A block owns one cloud and 64 channels for each of its NWG consumer
//    warpgroups: NWG = 4 at taps 1 where cout >= 256 and the plan fits
//    (where cout % 256 == 128 the last block's last two warpgroups have no
//    channels and only release the stages), else 2, so x crosses L2 once
//    for every 256 (or 128) channels. Its weights are staged once; at the
//    victim's cin of 128 (KS = taps cin / 16 steps) each consumer warp then
//    keeps its 16 channels' W^T fragments (ldmatrix.trans) in registers for
//    the whole cloud: wgmma's A.
//  - The producer warpgroup streams the cloud's 64-point tiles (66 rows at
//    taps 3: the halo), one 1D bulk copy (TMA) a tile into a landing buffer
//    on an mbarrier, and writes each tile as bf16 (cvt.rn for float32 x;
//    zeros outside the cloud) into an operand buffer in wgmma's K-major
//    no-swizzle layout, x^T, B: each 16-byte k-group of a point beside the
//    next point's. A tap is the same descriptor 16 bytes on. It gives its
//    registers to the consumers (setmaxnreg; RegSplit checks the budget).
//  - Each consumer warpgroup runs wgmma.mma_async m64n64k16 over a tile
//    (its 64 channels x 64 points), then its epilogue; the warpgroups' work
//    interleaves, and four of them (at the T-Nets) hide more of the
//    epilogue's latency than two. An operand buffer is released on an
//    mbarrier once every warpgroup's products retired. No block-wide
//    barrier runs after the weights are staged.
//  - D's layout gives each lane two channels (rows) and 16 points a tile,
//    each channel's four lanes interleaved points, so the pool
//    stays in registers: a lane's largest value of each channel is compared
//    with its running maximum and, only where it reaches it, its hits are
//    recorded in point order (maximum, tie count, first kMaxTies rows). The
//    four lanes' states merge once, after the last tile, by shuffles (a
//    sorted merge of ascending lists).
// Every output is the same chain over the (tap, 16-deep k) steps from 0,
// then __fadd_rn of the bias, whatever its row or column, so identical rows
// give identical z. The backward is the float32 kernel's: a warp per
// column adds bf16(g/cnt) * w3[t,:,c] into dx at the recorded rows
// (atomicAdd; the products are exact, the sums vary in the last bits from
// run to run). A column with more than kMaxTies ties is recomputed 16 rows
// at a time by mma.sync on the same bf16 operands in the same (tap, k)
// order; on the H100 it finds the forward's wgmma ties (chip_smoke.py's
// duplicated-rows holds).
#include "mma_bf16.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

#include <math.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kTile = 64;            // points a tile (one wgmma's N)
constexpr int kWgChannels = 64;      // channels a consumer warpgroup (wgmma's M)
constexpr int kStages = 2;           // landing and operand buffers
constexpr int kMaxTies = 4;
constexpr int kBwdWarps = 8;
constexpr int kBarBytes = 64;        // 3 kStages mbarriers, 16-byte aligned

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

// The forward's plan: nwg consumer warpgroups (64 nwg channels a block),
// `smem` bytes of shared memory (nwg == 0 where none fits): the mbarriers,
// the block's weights [taps cin][64 nwg + 8] bf16, kStages landing buffers
// of the tile's x rows (66 at taps 3: the halo) as x's type, kStages operand
// buffers of the same rows as bf16 in wgmma's K-major layout.
struct FwdPlan {
  int nwg;
  size_t smem;
};

FwdPlan pool_bf16_plan(int cin, int cout, int taps, int xbytes) {
  const size_t rows = kTile + (taps == 3 ? 2 : 0);
  for (int nwg = 4; nwg >= 2; nwg -= 2) {
    if (nwg == 4 && (taps != 1 || cout < 256)) continue;
    const size_t smem = kBarBytes + (size_t)taps * cin * (2 * kWgChannels * nwg + 16) +
                        (size_t)kStages * rows * cin * (xbytes + 2);
    if (smem <= geoa3::kSmemMax) return {nwg, smem};
  }
  return {0, 0};
}

// Columns c0 .. c0 + BN - 1 of w [K, cout] (bf16; w3's rows t cin + k) into
// W [K][BN + 8] (rows 16 bytes apart from a multiple of 128, so ldmatrix
// hits every bank once), zero past cout, by cp.async from every thread.
template <int BN>
__device__ __forceinline__ void stage_weights(char* W, const uint16_t* w, int K,
                                              int cout, int c0) {
  for (int i = threadIdx.x; i < K * (BN / 8); i += blockDim.x) {
    const int k = i / (BN / 8), c = c0 + (i % (BN / 8)) * 8;
    const bool ok = c < cout;
    cp_async16z(W + (size_t)k * (2 * BN + 16) + (size_t)(c - c0) * 2,
                ok ? w + (size_t)k * cout + c : w, ok ? 16 : 0);
  }
}

// wgmma's A fragment of W^T for k rows k0 .. k0 + 15 and channels m0 .. m0 +
// 15 of W [K][BN + 8]: ldmatrix.trans of the four 8 x 8 blocks (k0 / k0 + 8,
// m0 / m0 + 8)
template <int BN>
__device__ __forceinline__ void w_fragment(uint32_t (&f)[4], const char* W,
                                           int k0, int m0, int lane) {
  ldmatrix_x4_trans(f, W + (size_t)(k0 + (lane & 7) + 8 * (lane >> 4)) * (2 * BN + 16) +
                           (size_t)(m0 + 8 * ((lane >> 3) & 1)) * 2);
}

// The producer warpgroup's pass over a landed tile: rows p (first + p of
// the cloud, zero outside it) of `land` [rows][cin] into the operand buffer
// B [cin / 8][rows][8] bf16 (row p's k-group kg 16 bytes at kg lbo + 16 p),
// float32 rounded by cvt.rn. Piece 8 a + j (of 8 kg_n a row-octet) is row
// 8 (a / kg_n) + j, k-group (a + j) % kg_n, so the eight threads of a
// 16-byte phase read and write eight different banks; thread pt takes
// pieces pt, pt + 128, .., so at the victim's cin of 128 (CIN: kg_n = 16)
// it keeps one k-group and rows j, j + 8, .. with no division.
template <typename T, int CIN>
__device__ __forceinline__ void stage_operand(char* B, const char* land, int rows,
                                              int cin, int first, int n, int pt) {
  auto piece = [&](int p, int kg) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (first + p >= 0 && first + p < n) {
      const char* src = land + ((size_t)p * cin + (size_t)kg * 8) * sizeof(T);
      if constexpr (sizeof(T) == 2) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        const float4 lo = *reinterpret_cast<const float4*>(src);
        const float4 hi = *reinterpret_cast<const float4*>(src + 16);
        v = make_uint4(cvt_rn_bf16x2(lo.x, lo.y), cvt_rn_bf16x2(lo.z, lo.w),
                       cvt_rn_bf16x2(hi.x, hi.y), cvt_rn_bf16x2(hi.z, hi.w));
      }
    }
    *reinterpret_cast<uint4*>(B + (size_t)kg * rows * 16 + (size_t)p * 16) = v;
  };
  if constexpr (CIN == 128) {
    const int j = pt & 7, kg = ((pt >> 3) + j) & 15;
#pragma unroll
    for (int u = 0; u < 9; ++u)
      if (8 * u + j < rows) piece(8 * u + j, kg);
  } else {
    const int kg_n = cin / 8;
    const int pieces = (rows + 7) / 8 * 8 * kg_n;
    for (int c = pt; c < pieces; c += 128) {
      const int a = c >> 3, j = c & 7;
      const int p = 8 * (a / kg_n) + j;
      if (p < rows) piece(p, (a + j) % kg_n);
    }
  }
}

// One column's maximum over the rows taken so far, its tie count and first
// kMaxTies tied rows (rows come ascending)
struct ColumnMax {
  float mx = -INFINITY;
  int ct = 0, r0 = 0, r1 = 0, r2 = 0, r3 = 0;

  // the rows row(k) for the set bits k of `bits` (ascending with k), each
  // holding z, which is at least the running maximum
  template <typename Row>
  __device__ __forceinline__ void hits(float z, unsigned bits, Row row) {
    if (z > mx || ct == 0) mx = z, ct = 0;
    for (; bits != 0u; bits &= bits - 1u, ++ct) {
      const int r = row(__ffs(bits) - 1);
      r0 = ct == 0 ? r : r0;
      r1 = ct == 1 ? r : r1;
      r2 = ct == 2 ? r : r2;
      r3 = ct == 3 ? r : r3;
    }
  }

  // the state of both row sets: where the maxima are equal, the counts add
  // and the first rows are the sorted merge of both ascending lists
  __device__ void merge(const ColumnMax& o) {
    if (o.ct == 0 || (ct != 0 && o.mx < mx)) return;
    if (ct == 0 || o.mx > mx) {
      *this = o;
      return;
    }
    const int a[kMaxTies] = {r0, r1, r2, r3}, c[kMaxTies] = {o.r0, o.r1, o.r2, o.r3};
    const int na = min(ct, kMaxTies), nc = min(o.ct, kMaxTies);
    int out[kMaxTies];
    for (int k = 0, i = 0, j = 0; k < kMaxTies; ++k)
      out[k] = i < na && (j >= nc || a[i] < c[j]) ? a[i++] : j < nc ? c[j++] : 0;
    r0 = out[0], r1 = out[1], r2 = out[2], r3 = out[3];
    ct += o.ct;
  }

  // the state of lane (this lane ^ off)
  __device__ __forceinline__ ColumnMax from_lane(int off) const {
    ColumnMax o;
    o.mx = __shfl_xor_sync(GEOA3_FULL_MASK, mx, off);
    o.ct = __shfl_xor_sync(GEOA3_FULL_MASK, ct, off);
    o.r0 = __shfl_xor_sync(GEOA3_FULL_MASK, r0, off);
    o.r1 = __shfl_xor_sync(GEOA3_FULL_MASK, r1, off);
    o.r2 = __shfl_xor_sync(GEOA3_FULL_MASK, r2, off);
    o.r3 = __shfl_xor_sync(GEOA3_FULL_MASK, r3, off);
    return o;
  }
};

// The registers of a launch of NWG consumer warpgroups and the producer's,
// split by setmaxnreg: a block holds (NWG + 1) 128 threads at the launch
// bound's count, and what the producer gives up must cover what the
// consumers take.
template <int NWG>
struct RegSplit {
  static constexpr int kThreads = (NWG + 1) * 128;
  static constexpr int kAtLaunch = 65536 / kThreads / 8 * 8;
  static constexpr int kProducer = NWG == 4 ? 40 : 56;
  static constexpr int kConsumer = NWG == 4 ? 104 : 224;
  static_assert(128 * kProducer + NWG * 128 * kConsumer <= kThreads * kAtLaunch,
                "setmaxnreg.inc would wait for registers the block does not hold");
};

// A block: one cloud, channels c0 .. c0 + 64 NWG - 1, 64 a consumer
// warpgroup (NWG = 4 at taps 1, the T-Nets: more warps to hide the
// epilogue's latency under a tighter register cap; 2 at taps 3, conv5,
// and where the weights of 256 channels do not fit); KS = taps cin / 16 where
// the victim's cin = 128 puts every step's weights in registers, 0 for
// other widths (fragments reloaded each step).
template <typename T, int NWG, int KS>
__global__ void __launch_bounds__(RegSplit<NWG>::kThreads, 1)
pool_fwd_bf16_kernel(const T* __restrict__ x, const uint16_t* __restrict__ w3,
                     const float* __restrict__ bias, int n, int cin, int cout,
                     int taps, float* __restrict__ pooled,
                     int* __restrict__ cnt, int* __restrict__ rows) {
  constexpr int BN = kWgChannels * NWG, kConsumerWarps = 4 * NWG;
  extern __shared__ __align__(16) float smem[];
  uint64_t* full_l = reinterpret_cast<uint64_t*>(smem);  // a tile landed
  uint64_t* full_b = full_l + kStages;                    // its operand is ready
  uint64_t* empty_b = full_b + kStages;                   // its products are done
  char* W = reinterpret_cast<char*>(smem) + kBarBytes;
  char* land = W + (size_t)taps * cin * (2 * BN + 16);
  const int halo = taps == 3 ? 1 : 0;
  const int srows = kTile + 2 * halo;
  const int row_bytes = cin * (int)sizeof(T);
  const size_t lstage = (size_t)srows * row_bytes, bstage = (size_t)srows * cin * 2;
  char* Bs = land + kStages * lstage;
  const int b = blockIdx.y, c0 = blockIdx.x * BN;
  const int tiles = (n + kTile - 1) / kTile;
  // the warp's index as a value ptxas knows to be warp-uniform: a wgmma
  // under a branch it takes for divergent is serialized
  const int warp = __shfl_sync(GEOA3_FULL_MASK, (int)threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  const T* X = x + (size_t)b * n * cin;

  // tile i's rows p0 - halo .. p0 + kTile + halo - 1 that lie in the cloud
  // (contiguous in x) into its landing buffer, one bulk copy
  auto copy = [&](int i) {
    const int slot = i % kStages, first = i * kTile - halo;
    const int lo = max(first, 0), hi = min(first + srows, n);
    mbar_expect_tx(full_l + slot, (unsigned)((hi - lo) * row_bytes));
    bulk_copy(land + slot * lstage + (size_t)(lo - first) * row_bytes,
              X + (size_t)lo * cin, (unsigned)((hi - lo) * row_bytes), full_l + slot);
  };
  if (threadIdx.x == kConsumerWarps * 32) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_l + s, 1);
      mbar_init(full_b + s, 1);
      mbar_init(empty_b + s, kConsumerWarps);
    }
    mbar_fence_init();
    for (int i = 0; i < min(tiles, kStages); ++i) copy(i);
  }
  stage_weights<BN>(W, w3, taps * cin, cout, c0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // barriers and weights ready

  if (warp >= kConsumerWarps) {  // the producer warpgroup
    setmaxnreg_dec<RegSplit<NWG>::kProducer>();
    const int pt = threadIdx.x - kConsumerWarps * 32;
    for (int i = 0; i < tiles; ++i) {
      const int slot = i % kStages;
      const unsigned parity = (i / kStages) & 1;
      mbar_wait(full_l + slot, parity);
      if (i >= kStages) mbar_wait(empty_b + slot, parity ^ 1);
      stage_operand<T, (KS > 0 ? 128 : 0)>(Bs + slot * bstage, land + slot * lstage,
                                          srows, cin, i * kTile - halo, n, pt);
      fence_proxy_async();       // the operand visible to wgmma
      named_bar_sync(1, 128);    // every piece written, the landing buffer read
      if (pt == 0) {
        mbar_arrive(full_b + slot);
        if (i + kStages < tiles) copy(i + kStages);
      }
    }
    return;
  }
  setmaxnreg_inc<RegSplit<NWG>::kConsumer>();

  // a consumer warp: channels cw + 16 w .. + 15 of the block (the rows of
  // wgmma's D), this lane's g (+ 8) of them and points 8 j + 2 q (+ 1) of
  // each tile (D's columns)
  const int wg = warp >> 2, w = warp & 3;
  const int g = lane >> 2, q = lane & 3;
  const int cw = wg * kWgChannels;
  if (c0 + cw >= cout) {  // the last block's warpgroups past cout
    for (int i = 0; i < tiles; ++i) {
      mbar_wait(full_b + i % kStages, (i / kStages) & 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_b + i % kStages);
    }
    return;
  }
  uint32_t wa[KS > 0 ? KS : 1][4];
  if constexpr (KS > 0)
#pragma unroll
    for (int s = 0; s < KS; ++s) w_fragment<BN>(wa[s], W, 16 * s, cw + 16 * w, lane);
  float bj[2];
  ColumnMax col[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) bj[h] = __ldg(bias + c0 + cw + 16 * w + g + 8 * h);
  // step s = t (cin / 16) + kk reads operand k-groups 2 kk, 2 kk + 1 from
  // row t on (output point p reads staged row p + t)
  const unsigned lbo = (unsigned)srows * 16;
  const int kk_n = cin / 16;

  for (int i = 0; i < tiles; ++i) {
    const int slot = i % kStages;
    mbar_wait(full_b + slot, (i / kStages) & 1);
    const unsigned bs = smem_addr(Bs + slot * bstage);
    // the first step without acc's old value: the chain starts from 0
    float acc[32];
    if constexpr (KS > 0) {
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const int t = s / 8, kk = s % 8;  // KS > 0: cin = 128
        wgmma_m64n64k16_bf16(acc, wa[s],
                             gmma_desc(bs + (halo ? 16 * t : 0) + 2 * kk * lbo, lbo, 128),
                             s > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
    } else {
      for (int s = 0, t = 0, kk = 0; s < taps * kk_n; ++s) {
        w_fragment<BN>(wa[0], W, 16 * s, cw + 16 * w, lane);
        wgmma_fence();
        wgmma_m64n64k16_bf16(acc, wa[0],
                             gmma_desc(bs + (halo ? 16 * t : 0) + 2 * kk * lbo, lbo, 128),
                             s > 0);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < 4; ++e) fence_operand(wa[0][e]);
        if (++kk == kk_n) kk = 0, ++t;
      }
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) fence_operand(acc[e]);
    __syncwarp();  // the warp's products are done: the operand buffer is free
    if (lane == 0) mbar_arrive(empty_b + slot);

    // each of this lane's two channels over its 16 points of the tile: the
    // largest (acc's, then + bias: rounding is monotone, so that is the
    // largest z), and only where it reaches the running maximum, the points
    // whose z equals it, in point order (bit 2 j + e is point 8 j + 2 q +
    // e); rows past the cloud read as NaN, which nothing reaches
    const int p0 = i * kTile + 2 * q;
    auto epilogue = [&](auto whole) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          v[k] = acc[4 * (k >> 1) + 2 * h + (k & 1)];
          if (!decltype(whole)::value && p0 + 8 * (k >> 1) + (k & 1) >= n) v[k] = NAN;
        }
        float t8[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) t8[k] = fmaxf(v[2 * k], v[2 * k + 1]);
#pragma unroll
        for (int k = 0; k < 4; ++k) t8[k] = fmaxf(t8[2 * k], t8[2 * k + 1]);
        const float m = __fadd_rn(fmaxf(fmaxf(t8[0], t8[1]), fmaxf(t8[2], t8[3])), bj[h]);
        if (m >= col[h].mx) {
          unsigned bits = 0u;
#pragma unroll
          for (int k = 0; k < 16; ++k) bits |= (__fadd_rn(v[k], bj[h]) == m ? 1u : 0u) << k;
          col[h].hits(m, bits, [&](int k) { return p0 + 8 * (k >> 1) + (k & 1); });
        }
      }
    };
    if (i * kTile + kTile <= n)
      epilogue(std::true_type());
    else
      epilogue(std::false_type());
  }

  // the four lanes of a channel (q = 0 .. 3) hold interleaved points: merge
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    col[h].merge(col[h].from_lane(1));
    col[h].merge(col[h].from_lane(2));
    if (q != 0) continue;
    const ColumnMax& c = col[h];
    const size_t o = (size_t)b * cout + c0 + cw + 16 * w + g + 8 * h;
    pooled[o] = c.mx;
    cnt[o] = c.ct;
    rows[o * kMaxTies] = c.ct > 0 ? c.r0 : 0;
    rows[o * kMaxTies + 1] = c.ct > 1 ? c.r1 : 0;
    rows[o * kMaxTies + 2] = c.ct > 2 ? c.r2 : 0;
    rows[o * kMaxTies + 3] = c.ct > 3 ? c.r3 : 0;
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

template <typename T, int NWG, int KS>
cudaError_t launch_fwd(const void* x, const void* w3, const float* bias,
                       int B, int n, int cin, int cout, int taps,
                       const FwdPlan& p, float* pooled, int* cnt, int* rows,
                       cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      pool_fwd_bf16_kernel<T, NWG, KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)geoa3::kSmemMax);
  if (attr != cudaSuccess) return attr;
  constexpr int bn = kWgChannels * NWG;
  dim3 grid((cout + bn - 1) / bn, B);
  pool_fwd_bf16_kernel<T, NWG, KS><<<grid, RegSplit<NWG>::kThreads, p.smem, s>>>(
      static_cast<const T*>(x), static_cast<const uint16_t*>(w3), bias, n, cin,
      cout, taps, pooled, cnt, rows);
  return cudaGetLastError();
}

// the victim's width (cin = 128: 8 steps at taps 1, 24 at taps 3) keeps
// every step's weights in registers; other widths reload them each step
template <typename T>
cudaError_t launch_fwd(const void* x, const void* w3, const float* bias,
                       int B, int n, int cin, int cout, int taps,
                       const FwdPlan& p, float* pooled, int* cnt, int* rows,
                       cudaStream_t s) {
  if (p.nwg == 4)
    return cin == 128 ? launch_fwd<T, 4, 8>(x, w3, bias, B, n, cin, cout, taps, p,
                                            pooled, cnt, rows, s)
                      : launch_fwd<T, 4, 0>(x, w3, bias, B, n, cin, cout, taps, p,
                                            pooled, cnt, rows, s);
  if (cin == 128)
    return taps == 1 ? launch_fwd<T, 2, 8>(x, w3, bias, B, n, cin, cout, taps, p,
                                           pooled, cnt, rows, s)
                     : launch_fwd<T, 2, 24>(x, w3, bias, B, n, cin, cout, taps, p,
                                            pooled, cnt, rows, s);
  return launch_fwd<T, 2, 0>(x, w3, bias, B, n, cin, cout, taps, p, pooled, cnt,
                             rows, s);
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
// [B, cout, kMaxTies]. cin % 16 == 0, cout % 128 == 0, x and w3 16-byte
// aligned, and a plan (pool_bf16_plan) within the card's 232,448 bytes of
// shared memory.
extern "C" int geoa3_pool_fwd_bf16(const void* x, const void* w3,
                                   const float* bias, int B, int n, int cin,
                                   int cout, int taps, int x_bf16,
                                   float* pooled, int* cnt, int* rows,
                                   void* stream) {
  const FwdPlan p = pool_bf16_plan(cin, cout, taps, x_bf16 ? 2 : 4);
  if (p.nwg == 0 || cin % 16 != 0 || cout % 128 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return (int)launch_fwd<uint16_t>(x, w3, bias, B, n, cin, cout, taps, p,
                                     pooled, cnt, rows, s);
  return (int)launch_fwd<float>(x, w3, bias, B, n, cin, cout, taps, p, pooled,
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
