// The input cotangent of the global pool (row 7's backward,
// geoa3_tpu/ops/pallas/pool_matmul_kernel.py:_bwd_kernel) as a gather over
// dx's rows, in one place for both precisions: the float32 pool
// (csrc/pool_matmul.cu) and the single-pass bf16 one
// (csrc/pool_matmul_bf16.cu) each instantiate pool_bwd_gather<P, TAPS> with
// their precision policy P.
//
// The cotangent m = coef(g / cnt) on the rows tied at the maximum is ~0.1%
// nonzero, so the dense product m w3[t]^T becomes, for each dx row r, a sum
// over its entries (column c, tap t) with z[r - shift(t), c] tied at the
// maximum and g[c] != 0 of coef * w3t[t, c, :]. Bound on the H100: bytes,
// dx written once plus g, cnt, the recorded rows and w3t read once. A block
// takes one cloud and kBwdRows = 128 dx rows (256 blocks of 16 warps at the
// victim's [32, 1024, 128], two an SM) and:
//  1. bulk-copies (TMA) the cloud's g, cnt and recorded rows into shared
//     memory (24 KB at cout = 1024, a pass of 1024 columns at a time) and
//     lists the tile's entries in (column, tap, row) order (a block prefix
//     of the threads' counts; columns with g = 0 give none); a column past
//     kMaxTies ties is recomputed over the tile's rows and the taps' halo
//     alone, a warp a column, by the forward's own chain (P::tied_rows), and
//     its hits join the same list;
//  2. sorts the list stably by row (a warp a segment: per-row counts, then
//     ranks by __match_any_sync);
//  3. splits the sorted entries evenly over its warps, whatever rows they
//     hold, so a critical point that wins hundreds of columns is shared.
//     Each lane keeps 4 of the channels in float32 registers and reads their
//     4 weights of each entry's w3t row in one load (through L2), kBwdDepth
//     rows in flight;
//  4. writes each row once (P::X: float32, or bf16 by cvt.rn), zeros where a
//     row has no entry.
// So no memset of dx, no global atomics and no cast remain, and dx is
// bitwise the same from run to run. The sum order, which the emulated tests
// hold bit-equal: each term is __fmul_rn(coef, w) (rounded on its own) added
// by __fadd_rn, never contracted to an FMA; a row's run of entries in a
// warp's chunk of the sorted order is summed from 0; a row's runs are added
// in chunk order from 0. A tile with more than kBwdCap entries (ties over
// many rows of many columns) keeps that order and those runs: a warp a row
// walks the columns again (`gather_rows`), adding its run partials where a
// warp's chunk of the sorted order would begin. Read on the H100 along the
// way (PERF.md): 64-row tiles spent most of their time reading every
// column's record once a tile (16 tiles a cloud), and per-thread loads held
// in registers across the block's barriers waited on them; the staged copy
// and 128-row tiles halved the time.
//
// A precision policy P supplies:
//   X                 x's and dx's element (float, or uint16_t holding bf16)
//   W, W4             w3's and w3t's element, and four channels of a w3t
//                     row as one load (uint2 of bf16, float4 of float32)
//   coef(g, ct)       an entry's coefficient from g and the tie count
//   widen(W4)         the four weights as float32 (exact)
//   tied_rows(...)    bit j set where z row p0 + j (j < nrows <= 32) lies
//                     in the cloud and equals the column's maximum, by the
//                     forward's exact chain; every lane of the warp calls it
//                     and gets the same bits
#pragma once

#include "mma_bf16.cuh"
#include "tma.cuh"

namespace {

constexpr int kMaxTies = 4;          // tied rows the forward records a column
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

// acc + cf * w, each product rounded on its own and added in order
__device__ __forceinline__ float4 add_products(float4 acc, float cf, float4 w) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(cf, w.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(cf, w.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(cf, w.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(cf, w.w));
  return acc;
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// the four weights of w3t's row `row` at channel k (one load)
template <class P>
__device__ __forceinline__ typename P::W4 load_w4(const typename P::W* w3t, size_t row,
                                                   int cin, int k) {
  return __ldg(reinterpret_cast<const typename P::W4*>(w3t + row * cin + k));
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
template <class P, int TAPS>
__device__ __noinline__ void gather_rows(const BwdSmem& sm, const typename P::W* __restrict__ w3t,
                                         const float* __restrict__ g, const int* __restrict__ cnt,
                                         const int* __restrict__ rows, const typename P::X* X,
                                         const float* __restrict__ bias,
                                         const float* __restrict__ pooled,
                                         const typename P::W* __restrict__ w3, size_t o, int n,
                                         int cin, int cout, int r0, int rv, int chunk,
                                         typename P::X* DX) {
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
          const uint32_t bits = P::tied_rows(X, w3, w3t, n, cin, cout, TAPS, cl, r - halo,
                                             1 + 2 * halo, bias[cl], pooled[o + cl], lane);
          if (lane == l)
            for (int t = 0; t < TAPS; ++t)
              tm |= ((bits >> (halo - tap_shift(TAPS, t))) & 1u) << t;
        }
        const float cf = P::coef(gv, max(ctt, 1));
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
              acc = add_products(acc, cfl,
                                 P::widen(load_w4<P>(w3t, (size_t)t * cout + cb + l, cin, k)));
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
// packed above i, and P::coef(g, cnt).
template <class P, int TAPS>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSM)
pool_bwd_gather(const typename P::W* __restrict__ w3t, const float* __restrict__ g,
                const int* __restrict__ cnt, const int* __restrict__ rows,
                const typename P::X* __restrict__ x, const float* __restrict__ bias,
                const float* __restrict__ pooled, const typename P::W* __restrict__ w3, int n,
                int cin, int cout, typename P::X* __restrict__ dx) {
  using T = typename P::X;
  using W4 = typename P::W4;
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
  // the window (z rows r0 - halo .. r0 + rv + halo - 1); the list in
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
      const int wrows = rv + 2 * halo, words = (wrows + 31) / 32;
      for (int k = warp; k < nrec; k += kBwdWarps) {
        const int at = sm.scan.rec[k], c = cb + at;
        for (int wi = 0; wi < words; ++wi) {  // 32 window rows a mask word
          const uint32_t w = P::tied_rows(X, w3, w3t, n, cin, cout, TAPS, c, r0 - halo + 32 * wi,
                                          min(32, wrows - 32 * wi), bias[c], pooled[o + c], lane);
          if (lane == 0) sm.scan.mask[at][wi] = w;
        }
        for (int wi = words + lane; wi < kBwdWords; wi += 32) sm.scan.mask[at][wi] = 0u;
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
      const unsigned coef = __float_as_uint(P::coef(sm.scan.g[at], ct));
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
    gather_rows<P, TAPS>(sm, w3t, g, cnt, rows, X, bias, pooled, w3, o, n, cin, cout, r0, rv,
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
      W4 wv[kBwdDepth];
#pragma unroll
      for (int u = 0; u < kBwdDepth; ++u)
        wv[u] = act && base + u < c1 ? load_w4<P>(w3t, sm.sorted[base + u].x >> 7, cin, k)
                                     : W4{};
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
        acc = add_products(acc, __uint_as_float(en.y), P::widen(wv[u]));
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

}  // namespace
