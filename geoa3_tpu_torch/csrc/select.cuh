// Exact k-smallest selection over a streamed point cloud, one row per warp.
//
// Shared by the self-kNN selection of kappa.cu (kappa_select_kernel, rows
// with themselves excluded) and the kNN of knn.cu (every column competes).
// The block stages the cloud through shared memory in tiles of kTile points
// (x, y, z, |p|^2 as one float4, as csrc/nn1.cu stages its tiles), so the
// cloud's size is bounded by nothing here. Each warp keeps, for each of its
// kRows rows, the row's L best 64-bit (distance bits, index) keys in
// registers, sorted ascending across its lanes: position p sits in slot
// p / 32 of lane p % 32 (kKPL slots a lane, so L <= 32 * kKPL). A lane
// filters each of its tile's keys against the row's current bound; the few
// that pass are merged one ballot at a time (the lowest lane first), each
// insertion a shift of the list by one shuffle, and the bound becomes the
// list's worst key once the list is full. Before the merge, each lane takes
// its smallest distance of the row in the first tile; the L-th smallest of
// those 32 (L <= 32) is a distance that at least L of the row's keys do not
// exceed, so it bounds the merge from the start: about L (1 + ln(m / kTile))
// keys are inserted instead of ~L (1 + ln(m / L)), ~L instead of ~5 L at
// m = 1024, L = 16.
//
// d_ij = max((|q_i|^2 + |p_j|^2) - 2 q_i.p_j, 0) with every product and sum
// rounded on its own (common.cuh), so the keys, and with them the selected
// indices and distances, are bitwise the plain version's; the key orders by
// distance first and then by the lower index, so ties go to the lowest index.
#pragma once

#include "common.cuh"

namespace geoa3 {

constexpr int kTile = 1024;  // points staged a pass: 16 KB of float4

// (distance bits, index) for d >= 0; ~0 is "no key".
__device__ __forceinline__ unsigned long long raw_key(float d, int j) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
         static_cast<unsigned int>(j);
}

// A warp's sorted list of keys (see the header).
template <int kKPL>
struct WarpList {
  unsigned long long v[kKPL];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int s = 0; s < kKPL; ++s) v[s] = ~0ull;
  }

  // The key at position L - 1 (the current worst kept key), on every lane.
  __device__ __forceinline__ unsigned long long worst(int L) const {
    const int p = L - 1;
    unsigned long long x = v[0];
    if (kKPL > 1 && p >= 32) x = v[kKPL - 1];
    return __shfl_sync(GEOA3_FULL_MASK, x, p & 31);
  }

  // Insert key x (not in the list): every position holding a larger key
  // takes its predecessor's, the first of them takes x, the last drops out.
  __device__ __forceinline__ void insert(unsigned long long x, int lane) {
    unsigned long long up[kKPL];
#pragma unroll
    for (int s = 0; s < kKPL; ++s)
      up[s] = __shfl_up_sync(GEOA3_FULL_MASK, v[s], 1);
    if (kKPL > 1) {
      const unsigned long long top = __shfl_sync(GEOA3_FULL_MASK, v[0], 31);
      if (lane == 0) up[kKPL - 1] = top;
    }
#pragma unroll
    for (int s = 0; s < kKPL; ++s) {
      if (v[s] > x) {
        const bool first = (s == 0 && lane == 0) || up[s] < x;
        v[s] = first ? x : up[s];
      }
    }
  }

  // The index held at each of this lane's slots.
  __device__ __forceinline__ int index(int s) const {
    return static_cast<int>(static_cast<unsigned int>(v[s]));
  }
};

// The L-th smallest of the warp's 32 values (one a lane; 1 <= L <= 32), on
// every lane: a bitonic sort across the lanes.
__device__ __forceinline__ float warp_kth(float x, int L, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const float o = __shfl_xor_sync(GEOA3_FULL_MASK, x, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
      x = keep_min ? fminf(x, o) : fmaxf(x, o);
    }
  }
  return __shfl_sync(GEOA3_FULL_MASK, x, L - 1);
}

// Every warp of the block selects, for each of its kRows rows, the L
// smallest keys of its row against the m points P [m, 3] (row r's query is
// q[r] = (x, y, z, |q|^2); row[r] < 0 marks a row past the end, which
// selects nothing). With kSkipSelf, column row[r] is left out of row r.
// Every thread of the block must call this (it stages the tiles).
template <int kKPL, int kRows, bool kSkipSelf>
__device__ __forceinline__ void select_rows(const float* __restrict__ P, int m,
                                            float4* tile,
                                            const float (&q)[kRows][4],
                                            const int (&row)[kRows], int L,
                                            WarpList<kKPL> (&list)[kRows]) {
  const int lane = threadIdx.x & 31;
  unsigned long long thr[kRows];
  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int cnt = min(kTile, m - t0);
    __syncthreads();  // the previous tile is consumed
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
      const size_t o = (size_t)(t0 + j) * 3;
      const float x = P[o], y = P[o + 1], z = P[o + 2];
      tile[j] = make_float4(x, y, z, geoa3_sq3(x, y, z));
    }
    __syncthreads();
    // d of row r against the tile's column jt (and whether it competes)
    auto dist = [&](int r, int jt, const float4& p, bool& ok) {
      ok = jt < cnt && (!kSkipSelf || t0 + jt != row[r]);
      return geoa3_sqdist(q[r][3], p.w,
                          geoa3_dot3(q[r][0], q[r][1], q[r][2], p.x, p.y, p.z));
    };
    if (t0 == 0) {  // the bound, from the first tile
      const float inf = __uint_as_float(0x7f800000u);
      float dmin[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) dmin[r] = inf;
      for (int jt = lane; jt < cnt; jt += 32) {
        const float4 p = tile[jt];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          bool ok;
          const float d = dist(r, jt, p, ok);
          if (ok) dmin[r] = fminf(dmin[r], d);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        list[r].clear();
        unsigned long long bound = ~0ull;
        if (L <= 32) {
          const float kth = warp_kth(dmin[r], max(L, 1), lane);
          if (kth < inf)  // the keys of d <= kth pass
            bound = (static_cast<unsigned long long>(__float_as_uint(kth)) + 1ull) << 32;
        }
        thr[r] = (row[r] >= 0 && L > 0) ? bound : 0ull;
      }
    }
    for (int jb = 0; jb < cnt; jb += 32) {
      const int jt = jb + lane;
      const float4 p = tile[jt < cnt ? jt : 0];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        bool ok;
        const unsigned long long key = raw_key(dist(r, jt, p, ok), t0 + jt);
        const bool cand = ok && key < thr[r];
        unsigned bal = __ballot_sync(GEOA3_FULL_MASK, cand);
        while (bal) {  // warp-uniform
          const int src = __ffs(bal) - 1;
          list[r].insert(__shfl_sync(GEOA3_FULL_MASK, key, src), lane);
          const unsigned long long worst = list[r].worst(L);
          thr[r] = worst < thr[r] ? worst : thr[r];
          // lanes above src whose key still passes the tightened bound
          bal &= __ballot_sync(GEOA3_FULL_MASK, cand && key < thr[r]) &
                 ~((2u << src) - 1u);
        }
      }
    }
  }
}

}  // namespace geoa3
