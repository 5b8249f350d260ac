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
// float32. dx is x's type (float32 sums, bf16 rounded by cvt.rn).
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
// give identical z.
//
// The backward, pool_bwd_bf16_gather<T, TAPS>, is a gather over dx's rows.
// The cotangent m = bf16(g / cnt) on the tied rows is ~0.1% nonzero, so the
// TPU kernel's dense `_mm_t(m, w3[t])` becomes, for each dx row r, a sum
// over its entries (column c, tap t) with z[r - shift(t), c] tied at the
// maximum and g[c] != 0 of bf16(g/cnt) * w3t[t, c, :]. Bound on the H100:
// bytes, dx in x's type written once (8.4 MB bf16, 16.8 MB float32 at the
// victim's [32, 1024, 128]) plus g, cnt, the recorded rows and w3t read
// once: 0.0028 ms (bf16 x), 0.0053-0.0055 (float32 x) at 3.35 TB/s. A block
// takes one cloud and kBwdRows = 128 dx rows (256 blocks of 16 warps at the
// victim's shapes, two an SM) and:
//  1. bulk-copies (TMA) the cloud's g, cnt and recorded rows into shared
//     memory (24 KB at cout = 1024, a pass of 1024 columns at a time) and
//     lists the tile's entries in (column, tap, row) order (a block prefix
//     of the threads' counts; columns with g = 0 give none); a column past
//     kMaxTies ties is recomputed over the tile's rows and the taps' halo
//     alone, a warp a column, by the forward's chain on mma.sync
//     (`tied_rows16`), and its hits join the same list;
//  2. sorts the list stably by row (a warp a segment: per-row counts, then
//     ranks by __match_any_sync);
//  3. splits the sorted entries evenly over its warps, whatever rows they
//     hold, so a critical point that wins hundreds of columns is shared.
//     Each lane keeps 4 of the channels in float32 registers and reads 8
//     bytes of each entry's w3t row (through L2), kBwdDepth rows in flight;
//     a row's run of entries in a warp is summed in order from 0 (each
//     product exact, one __fadd_rn a term), and the runs of a row split
//     across warps are added in warp order from 0 through shared memory;
//  4. writes each row once as float4, or as bf16 by cvt.rn (as
//     `.to(torch.bfloat16)` rounds), zeros where a row has no entry.
// So no memset of dx, no global atomics and no cast remain, and dx is
// bitwise the same from run to run. A tile with more than kBwdCap entries
// (ties over many rows of many columns) keeps the same order and the same
// runs: a warp a row walks the columns again (`gather_rows`), adding its
// run partials where a warp's chunk of the sorted order would begin. Read
// on the H100 along the way (PERF.md): 64-row tiles spent most of
// their time reading every column's record once a tile (16 tiles a cloud),
// and per-thread loads held in registers across the block's barriers
// waited on them; the staged copy and 128-row tiles halved the time.
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
constexpr int kBarBytes = 64;        // 3 kStages mbarriers, 16-byte aligned
constexpr int kBwdRows = 128;        // dx rows a backward block (a tile)
constexpr int kBwdWarps = 16;
constexpr int kBwdBlocksPerSM = 2;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdCols = 1024;       // columns a pass of its scan
constexpr int kBwdJ = kBwdCols / kBwdThreads;  // a thread's columns in a pass
constexpr int kBwdWords = (kBwdRows + 2 + 31) / 32;  // a window of z rows as bits
constexpr int kBwdCap = 6144;        // entries a tile keeps in shared memory
constexpr int kBwdDepth = 4;         // w3t rows a lane has in flight

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

// The backward's block: one cloud and a tile of kBwdRows output rows (dx's
// rows), kBwdWarps warps. Its shared memory (dynamic): the scan's staged
// columns and recomputed masks live where the sorted entries go later, and
// the partials of rows split across warps reuse the spent `list`.
struct BwdScan {
  float g[kBwdCols];                   // the pass's columns, bulk-copied
  int cnt[kBwdCols];
  int4 rows[kBwdCols];
  uint32_t mask[kBwdCols][kBwdWords];  // a recomputed column's tied window rows
  uint16_t rec[kBwdCols];              // the pass's columns to recompute
};
struct BwdSmem {
  uint2 list[kBwdCap];               // the tile's entries (id, coef) in column order
  union {
    uint2 sorted[kBwdCap];           // the same, stably sorted by row
    BwdScan scan;
  };
  uint64_t bar;                      // the pass's bulk copies landed
  int count[kBwdRows];               // entries a row
  int start[kBwdRows + 1];           // a row's first position in `sorted`
  int hist[kBwdWarps][kBwdRows];     // entries a (warp's segment, row), then offsets
  int wsum[kBwdJ][kBwdWarps];        // the scan's warp totals
  int nrec;
};
static_assert(kBwdRows % 32 == 0 && kBwdRows <= 128, "rows: lanes' shares, 7 bits of an id");
static_assert(kBwdCols % kBwdThreads == 0, "whole columns a thread");
static_assert(sizeof(BwdScan) <= sizeof(uint2) * kBwdCap, "the scan fits the sorted list");
static_assert(kBwdWarps * 2 * 128 * sizeof(float) <= sizeof(uint2) * kBwdCap,
              "the partials fit in the spent list");

// a staged column's ties: none where it has no cotangent
__device__ __forceinline__ int staged_ties(const BwdScan& sc, int at, int ncol) {
  return at < ncol && sc.g[at] != 0.0f ? sc.cnt[at] : 0;
}

// bits lo .. hi - 1 of a window mask that lie in its word w
__device__ __forceinline__ uint32_t span_word(int w, int lo, int hi) {
  const int a = max(lo - 32 * w, 0), z = min(hi - 32 * w, 32);
  if (z <= a) return 0u;
  return (z == 32 ? ~0u : (1u << z) - 1u) & ~((1u << a) - 1u);
}

// The forward's chain for column c at rows p0 .. p0 + 15 of the cloud X:
// mma.sync on the same bf16 operands in the same (tap, 16-deep k) order from
// 0, then __fadd_rn of the bias, column c in every column of the B
// fragment. Bit j is set where row p0 + j lies in the cloud and its z
// equals zmax (on the H100 this finds the forward's wgmma ties). Every lane
// of the warp calls it and gets the same bits. Not inlined: the common path
// keeps its registers.
template <typename T>
__device__ __noinline__ uint32_t tied_rows16(const T* X, const uint16_t* w3, int n, int cin,
                                             int cout, int taps, int c, int p0, float bc,
                                             float zmax, int lane) {
  const int gr = lane >> 2, q = lane & 3;
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
  const int p = p0 + gr;
  const bool hit0 = q == 0 && p >= 0 && p < n && __fadd_rn(d[0], bc) == zmax;
  const bool hit1 = q == 0 && p + 8 >= 0 && p + 8 < n && __fadd_rn(d[2], bc) == zmax;
  const uint32_t m0 = __ballot_sync(GEOA3_FULL_MASK, hit0);
  const uint32_t m1 = __ballot_sync(GEOA3_FULL_MASK, hit1);
  uint32_t bits = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    bits |= ((m0 >> (4 * j)) & 1u) << j | ((m1 >> (4 * j)) & 1u) << (j + 8);
  return bits;
}

// the exclusive prefix of v[j] over the block in (j, thread) order into off,
// and the block's total; wsum holds the warps' totals (a barrier inside)
__device__ __forceinline__ int block_scan(const int (&v)[kBwdJ], int (&off)[kBwdJ],
                                          int (*wsum)[kBwdWarps], int warp, int lane) {
  int inc[kBwdJ];
#pragma unroll
  for (int j = 0; j < kBwdJ; ++j) {
    inc[j] = v[j];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(GEOA3_FULL_MASK, inc[j], d);
      if (lane >= d) inc[j] += u;
    }
    if (lane == 31) wsum[j][warp] = inc[j];
  }
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int j = 0; j < kBwdJ; ++j) {
    int before = 0, all = 0;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) {
      before += w < warp ? wsum[j][w] : 0;
      all += wsum[j][w];
    }
    off[j] = total + before + inc[j] - v[j];
    total += all;
  }
  return total;
}

// four channels of a dx row, in dx's type (bf16 rounded by cvt.rn)
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(uint16_t* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(cvt_rn_bf16x2(v.x, v.y), cvt_rn_bf16x2(v.z, v.w));
}

// acc + cf * (the four bf16 weights in w), each product rounded on its own
// (exact: bf16 by bf16) and added in order
__device__ __forceinline__ float4 add_products(float4 acc, float cf, uint2 w) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(cf, __uint_as_float(w.x << 16)));
  acc.y = __fadd_rn(acc.y, __fmul_rn(cf, __uint_as_float(w.x & 0xffff0000u)));
  acc.z = __fadd_rn(acc.z, __fmul_rn(cf, __uint_as_float(w.y << 16)));
  acc.w = __fadd_rn(acc.w, __fmul_rn(cf, __uint_as_float(w.y & 0xffff0000u)));
  return acc;
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// One column's entries in the tile, in (tap, row) order: f(tap, tile row)
// for each tied z row p of the window with tile row p + shift(t) - r0 in
// [0, rv): from its recorded rows (ct <= kMaxTies) or its recomputed window
// mask (bit jj: z row r0 - halo + jj). f takes its state by value and
// returns it (no captured references: the state stays in registers).
template <int TAPS, typename S, typename F>
__device__ __forceinline__ S column_entries(int ct, int4 rw, const uint32_t* mask, int r0,
                                            int rv, S state, F f) {
  if (ct <= 0) return state;
  if (ct <= kMaxTies) {
    const int tied[kMaxTies] = {rw.x, rw.y, rw.z, rw.w};
#pragma unroll
    for (int t = 0; t < TAPS; ++t)
#pragma unroll
      for (int s = 0; s < kMaxTies; ++s) {
        const int i = tied[s] + (TAPS == 3 ? t - 1 : 0) - r0;
        if (s < ct && i >= 0 && i < rv) state = f(state, t, i);
      }
    return state;
  }
#pragma unroll
  for (int t = 0; t < TAPS; ++t) {
    const int lo = TAPS == 3 ? 2 - t : 0;  // window row jj is tile row jj - lo
#pragma unroll
    for (int wi = 0; wi < kBwdWords; ++wi)
      for (uint32_t bits = mask[wi] & span_word(wi, lo, lo + rv); bits != 0u;
           bits &= bits - 1u)
        state = f(state, t, 32 * wi + __ffs(bits) - 1 - lo);
  }
  return state;
}

// More entries than the list keeps (ties over many rows of many columns):
// a warp a dx row, the columns again in order, each row's runs cut where a
// warp's chunk of the sorted order would begin, so the sums are the same.
template <typename T, int TAPS>
__device__ __noinline__ void gather_rows(const BwdSmem& sm, const uint16_t* __restrict__ w3t,
                                         const float* __restrict__ g, const int* __restrict__ cnt,
                                         const int* __restrict__ rows, const T* X,
                                         const float* __restrict__ bias,
                                         const float* __restrict__ pooled,
                                         const uint16_t* __restrict__ w3, size_t o, int n,
                                         int cin, int cout, int r0, int rv, int chunk, T* DX) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int halo = TAPS == 3 ? 1 : 0;
  for (int i = warp; i < rv; i += kBwdWarps) {
    const int r = r0 + i, rs = sm.start[i];
    for (int sl = 0; sl < cin; sl += 128) {
      const int k = sl + 4 * lane;
      float4 tot = make_float4(0.0f, 0.0f, 0.0f, 0.0f), acc = tot;
      int at = rs;
      for (int cb = 0; cb < cout; cb += 32) {
        const int c = cb + lane;
        const float gv = g[o + c];
        const int ctt = gv != 0.0f ? cnt[o + c] : 0;
        unsigned tm = 0u;  // bit t: z row r - shift(t) tied
        if (ctt > 0 && ctt <= kMaxTies)
          tm = column_entries<TAPS>(ctt, *reinterpret_cast<const int4*>(rows + (o + c) * kMaxTies),
                                    nullptr, r, 1, 0u,
                                    [](unsigned m, int t, int) { return m | 1u << t; });
        for (unsigned rec = __ballot_sync(GEOA3_FULL_MASK, ctt > kMaxTies); rec != 0u;
             rec &= rec - 1u) {
          const int l = __ffs(rec) - 1, cl = cb + l;
          const uint32_t bits = tied_rows16(X, w3, n, cin, cout, TAPS, cl, r - halo,
                                            bias[cl], pooled[o + cl], lane);
          if (lane == l)
            for (int t = 0; t < TAPS; ++t)
              tm |= ((bits >> (halo - tap_shift(TAPS, t))) & 1u) << t;
        }
        const float cf = round_bf16(gv / (float)max(ctt, 1));
        for (unsigned hit = __ballot_sync(GEOA3_FULL_MASK, tm != 0u); hit != 0u;
             hit &= hit - 1u) {
          const int l = __ffs(hit) - 1;
          const unsigned tl = __shfl_sync(GEOA3_FULL_MASK, tm, l);
          const float cfl = __shfl_sync(GEOA3_FULL_MASK, cf, l);
          for (int t = 0; t < TAPS; ++t) {
            if (!((tl >> t) & 1u)) continue;
            if (at != rs && at % chunk == 0) {
              tot = add4(tot, acc);
              acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            }
            if (k < cin)
              acc = add_products(acc, cfl, __ldg(reinterpret_cast<const uint2*>(
                                               w3t + ((size_t)t * cout + cb + l) * cin + k)));
            ++at;
          }
        }
      }
      if (k < cin) store4(DX + (size_t)i * cin + k, add4(tot, acc));
    }
  }
}

// A warp's run of row i (sorted positions rs .. re - 1) is done: a row whole
// in the chunk c0 .. c1 - 1 goes to dx, a split one to the partial of the
// chunk's first (0) or last (1) row.
template <typename T>
__device__ __forceinline__ void flush_run(T* DX, float* part, int rs, int re, int i, int c0,
                                          int c1, int cin, int k, int warp, int lane, float4 acc) {
  if (rs >= c0 && re <= c1)
    store4(DX + (size_t)i * cin + k, acc);
  else
    *reinterpret_cast<float4*>(part + (warp * 2 + (rs <= c0 ? 0 : 1)) * 128 + 4 * lane) = acc;
}

// The input cotangent as a gather over dx's rows (see the header): block
// (tile, cloud) writes dx rows r0 .. r0 + kBwdRows - 1 of its cloud once, in
// x's type. An entry (row i of the tile, column c, tap t) is one tied z row
// p = r0 + i - shift(t) of a column with a cotangent: w3t's row t cout + c
// packed above i, and coef = bf16(g / cnt).
template <typename T, int TAPS>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSM)
pool_bwd_bf16_gather(const uint16_t* __restrict__ w3t, const float* __restrict__ g,
                     const int* __restrict__ cnt, const int* __restrict__ rows,
                     const T* __restrict__ x, const float* __restrict__ bias,
                     const float* __restrict__ pooled, const uint16_t* __restrict__ w3,
                     int n, int cin, int cout, T* __restrict__ dx) {
  extern __shared__ __align__(16) float smem[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, r0 = blockIdx.x * kBwdRows;
  const int rv = min(kBwdRows, n - r0);  // the tile's rows in the cloud
  const int halo = TAPS == 3 ? 1 : 0;
  const size_t o = (size_t)b * cout;
  const T* X = x + (size_t)b * n * cin;
  T* DX = dx + ((size_t)b * n + r0) * cin;

  // thread 0: the pass's g, cnt and recorded rows into shared memory
  auto stage = [&](int cb) {
    const int ncol = min(kBwdCols, cout - cb);
    mbar_expect_tx(&sm.bar, (unsigned)ncol * (2 * sizeof(float) + sizeof(int4)));
    bulk_copy(sm.scan.g, g + o + cb, ncol * sizeof(float), &sm.bar);
    bulk_copy(sm.scan.cnt, cnt + o + cb, ncol * sizeof(int), &sm.bar);
    bulk_copy(sm.scan.rows, rows + (o + cb) * kMaxTies, ncol * sizeof(int4), &sm.bar);
  };
  if (tid == 0) {  // the first pass's copy flies while the counts are zeroed
    sm.nrec = 0;
    mbar_init(&sm.bar, 1);
    mbar_fence_init();
    stage(0);
  }
  for (int i = tid; i < kBwdRows; i += kBwdThreads) sm.count[i] = 0;
  for (int i = tid; i < kBwdWarps * kBwdRows; i += kBwdThreads) (&sm.hist[0][0])[i] = 0;
  __syncthreads();

  // 1. the entries, kBwdCols columns a pass: g, cnt and the recorded rows
  // bulk-copied once into shared memory; thread tid takes the pass's
  // columns kBwdThreads j + tid; a column past kMaxTies ties recomputed over
  // the window (z rows r0 - halo .. r0 + kBwdRows + halo - 1); the list in
  // (column, tap, row) order by a block prefix of the threads' counts.
  // Positions past kBwdCap are counted, not kept.
  int total = 0;
  unsigned parity = 0u;
  for (int cb = 0; cb < cout; cb += kBwdCols, parity ^= 1u) {
    const int ncol = min(kBwdCols, cout - cb);
    if (tid == 0 && cb > 0) stage(cb);
    mbar_wait(&sm.bar, parity);
#pragma unroll
    for (int j = 0; j < kBwdJ; ++j)
      if (staged_ties(sm.scan, j * kBwdThreads + tid, ncol) > kMaxTies)
        sm.scan.rec[atomicAdd(&sm.nrec, 1)] = (uint16_t)(j * kBwdThreads + tid);
    __syncthreads();
    const int nrec = sm.nrec;
    if (nrec > 0) {  // the forward's chain over the window, a warp a column
      const int groups = (rv + 2 * halo + 15) / 16;
      for (int k = warp; k < nrec; k += kBwdWarps) {
        const int at = sm.scan.rec[k], c = cb + at;
        for (int gi = 0; gi < groups; gi += 2) {  // 32 window rows a mask word
          uint32_t w = tied_rows16(X, w3, n, cin, cout, TAPS, c, r0 - halo + 16 * gi,
                                   bias[c], pooled[o + c], lane);
          if (gi + 1 < groups)
            w |= tied_rows16(X, w3, n, cin, cout, TAPS, c, r0 - halo + 16 * gi + 16,
                             bias[c], pooled[o + c], lane) << 16;
          if (lane == 0) sm.scan.mask[at][gi >> 1] = w;
        }
        for (int wi = (groups + 1) / 2 + lane; wi < kBwdWords; wi += 32) sm.scan.mask[at][wi] = 0u;
      }
      __syncthreads();
    }
    int v[kBwdJ], off[kBwdJ];
#pragma unroll
    for (int j = 0; j < kBwdJ; ++j) {
      const int at = j * kBwdThreads + tid;
      v[j] = column_entries<TAPS>(staged_ties(sm.scan, at, ncol), sm.scan.rows[at],
                                  sm.scan.mask[at], r0, rv, 0,
                                  [](int m, int, int) { return m + 1; });
    }
    const int pass = block_scan(v, off, sm.wsum, warp, lane);
    if (tid == 0) sm.nrec = 0;  // every thread has read it
#pragma unroll
    for (int j = 0; j < kBwdJ; ++j) {
      const int at = j * kBwdThreads + tid, ct = staged_ties(sm.scan, at, ncol);
      if (ct == 0) continue;
      const unsigned id = (unsigned)(cb + at) << 7, cw = (unsigned)cout << 7;
      // the TPU kernel's `_mm_t` takes the cotangent eq * g / cnt in bf16
      const unsigned coef = __float_as_uint(round_bf16(sm.scan.g[at] / (float)ct));
      BwdSmem* const sp = &sm;
      column_entries<TAPS>(ct, sm.scan.rows[at], sm.scan.mask[at], r0, rv, total + off[j],
                           [=](int e, int t, int i) {
                             atomicAdd(&sp->count[i], 1);
                             if (e < kBwdCap)
                               sp->list[e] = make_uint2((unsigned)t * cw + id + (unsigned)i, coef);
                             return e + 1;
                           });
    }
    total += pass;
    __syncthreads();  // the staged columns and masks are free
  }

  // 2. each row's first position in the sorted order
  if (warp == 0) {
    constexpr int kPer = kBwdRows / 32;
    int a[kPer], inc = 0;
#pragma unroll
    for (int u = 0; u < kPer; ++u) inc += (a[u] = sm.count[kPer * lane + u]);
    const int mine = inc;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(GEOA3_FULL_MASK, inc, d);
      if (lane >= d) inc += u;
    }
    int run = inc - mine;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      sm.start[kPer * lane + u] = run;
      run += a[u];
    }
    if (lane == 31) sm.start[kBwdRows] = inc;
  }
  __syncthreads();
  // warp w sums sorted positions c0 .. c1 - 1: each row's run in order from
  // 0; a row split across warps adds its runs in warp order from 0
  const int chunk = (total + kBwdWarps - 1) / kBwdWarps;
  const int c0 = min(total, warp * chunk), c1 = min(total, c0 + chunk);
  if (total > kBwdCap) {
    gather_rows<T, TAPS>(sm, w3t, g, cnt, rows, X, bias, pooled, w3, o, n, cin, cout, r0, rv,
                         chunk, DX);
    return;
  }

  // 3. the stable sort by row: warp w's segment c0 .. c1 - 1 of the list
  for (int e = c0 + lane; e < c1; e += 32) atomicAdd(&sm.hist[warp][sm.list[e].x & 127], 1);
  __syncthreads();
  for (int i = tid; i < kBwdRows; i += kBwdThreads) {
    int run = sm.start[i];
    for (int w = 0; w < kBwdWarps; ++w) {
      const int h = sm.hist[w][i];
      sm.hist[w][i] = run;
      run += h;
    }
  }
  for (int i = warp; i < rv; i += kBwdWarps)  // rows with no entry: zeros
    if (sm.count[i] == 0)
      for (int k = 4 * lane; k < cin; k += 128)
        store4(DX + (size_t)i * cin + k, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
  __syncthreads();
  for (int base = c0; base < c1; base += 32) {
    const int e = base + lane;
    const uint2 en = e < c1 ? sm.list[e] : make_uint2(0u, 0u);
    const int i = e < c1 ? (int)(en.x & 127) : -1;
    const unsigned peers = __match_any_sync(GEOA3_FULL_MASK, i);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (i >= 0) sm.sorted[sm.hist[warp][i] + rank] = en;
    __syncwarp();
    if (i >= 0 && rank == 0) sm.hist[warp][i] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // 4. the gather: each lane four channels, kBwdDepth w3t rows in flight
  float* part = reinterpret_cast<float*>(sm.list);  // [warp][2][128]
  for (int sl = 0; sl < cin; sl += 128) {
    const int k = sl + 4 * lane;
    const bool act = k < cin;
    int cur = -1;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int base = c0; base < c1; base += kBwdDepth) {
      uint2 wv[kBwdDepth];
#pragma unroll
      for (int u = 0; u < kBwdDepth; ++u)
        wv[u] = act && base + u < c1
                    ? __ldg(reinterpret_cast<const uint2*>(
                          w3t + (size_t)(sm.sorted[base + u].x >> 7) * cin + k))
                    : make_uint2(0u, 0u);
#pragma unroll
      for (int u = 0; u < kBwdDepth; ++u) {
        if (base + u >= c1) break;
        const uint2 en = sm.sorted[base + u];
        const int i = en.x & 127;
        if (i != cur) {
          if (cur >= 0 && act) flush_run(DX, part, sm.start[cur], sm.start[cur + 1], cur, c0, c1,
                                         cin, k, warp, lane, acc);
          cur = i;
          acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        acc = add_products(acc, __uint_as_float(en.y), wv[u]);
      }
    }
    if (cur >= 0 && act)
      flush_run(DX, part, sm.start[cur], sm.start[cur + 1], cur, c0, c1, cin, k, warp, lane, acc);
    __syncthreads();
    // a row split across chunks, by the warp whose chunk it starts in
    if (cur >= 0 && c1 < total && sm.start[cur] >= c0 && sm.start[cur + 1] > c1 && act) {
      const int rs = sm.start[cur], re = sm.start[cur + 1];
      float4 s = add4(make_float4(0.0f, 0.0f, 0.0f, 0.0f),
                      *reinterpret_cast<const float4*>(
                          part + (warp * 2 + (rs == c0 ? 0 : 1)) * 128 + 4 * lane));
      for (int w = warp + 1; w < kBwdWarps && w * chunk < re; ++w)
        s = add4(s, *reinterpret_cast<const float4*>(part + w * 2 * 128 + 4 * lane));
      store4(DX + (size_t)cur * cin + k, s);
    }
    __syncthreads();
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

template <typename T, int TAPS>
cudaError_t launch_bwd(const void* w3t, const float* g, const int* cnt,
                       const int* rows, const void* x, const float* bias,
                       const float* pooled, const void* w3, int B, int n,
                       int cin, int cout, void* dx, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      pool_bwd_bf16_gather<T, TAPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(BwdSmem));
  if (attr != cudaSuccess) return attr;
  dim3 grid((n + kBwdRows - 1) / kBwdRows, B);
  pool_bwd_bf16_gather<T, TAPS><<<grid, kBwdThreads, sizeof(BwdSmem), s>>>(
      static_cast<const uint16_t*>(w3t), g, cnt, rows, static_cast<const T*>(x),
      bias, pooled, static_cast<const uint16_t*>(w3), n, cin, cout, static_cast<T*>(dx));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* w3t, const float* g, const int* cnt,
                       const int* rows, const void* x, const float* bias,
                       const float* pooled, const void* w3, int B, int n,
                       int cin, int cout, int taps, void* dx, cudaStream_t s) {
  return taps == 3 ? launch_bwd<T, 3>(w3t, g, cnt, rows, x, bias, pooled, w3, B, n, cin,
                                      cout, dx, s)
                   : launch_bwd<T, 1>(w3t, g, cnt, rows, x, bias, pooled, w3, B, n, cin,
                                      cout, dx, s);
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
// [B, cout] -> dx [B, n, cin] in x's type, every element written once (no
// memset). w3t is w3 as [taps, cout, cin] bf16; g, cnt, rows and dx 16-byte
// aligned, w3t 8-byte aligned. cin % 16 == 0, cout % 128 == 0, taps 1 or 3.
extern "C" int geoa3_pool_bwd_bf16(const void* w3t, const float* g,
                                   const int* cnt, const int* rows,
                                   const void* x, const float* bias,
                                   const float* pooled, const void* w3, int B,
                                   int n, int cin, int cout, int taps,
                                   int x_bf16, void* dx, void* stream) {
  if (cin % 16 != 0 || cout % 128 != 0 || (taps != 1 && taps != 3) ||
      reinterpret_cast<uintptr_t>(g) % 16 || reinterpret_cast<uintptr_t>(cnt) % 16 ||
      reinterpret_cast<uintptr_t>(rows) % 16 || reinterpret_cast<uintptr_t>(dx) % 16 ||
      reinterpret_cast<uintptr_t>(w3t) % 8)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return (int)launch_bwd<uint16_t>(w3t, g, cnt, rows, x, bias, pooled, w3,
                                     B, n, cin, cout, taps, dx, s);
  return (int)launch_bwd<float>(w3t, g, cnt, rows, x, bias, pooled, w3, B, n,
                                cin, cout, taps, dx, s);
}
