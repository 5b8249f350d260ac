// Self-kNN selection and the curvature (kappa) statistic.
//
// Replaces five kernels of geoa3_tpu/ops/pallas/kappa_kernel.py (exact
// selection only):
//   _kappa_selmask_kernel      -> kappa_select_kernel<false>
//   _kappa_fwd_kernel          -> kappa_select_kernel<true>
//   _curv_term_frommask_kernel -> curv_term_kernel
//   _kappa_frommask_kernel     -> kappa_frommask_kernel
//   _kappa_bwd_kernel          -> kappa_bwd_kernel<Radius>
//
// Selection (the first two; select.cuh, shared with knn.cu): row i takes
// itself plus the k nearest other points by
// d_ij = max((|p_i|^2 + |p_j|^2) - 2 p_i.p_j, 0), ties to the lowest index.
// The block streams the cloud through shared memory in tiles; each warp
// keeps its rows' k best 64-bit (distance bits, index) keys, self left out,
// sorted across its lanes, so n is bounded by the [b,n,n] output only.
// Products and sums of d are rounded one by one, so the mask is bitwise the
// plain version's. A mask row is written in 16-byte stores: each lane sets
// the bytes of its 16 columns that are among the row's k+1 members, which
// reach it by shuffle; a row whose start is not 16-byte aligned (n % 16 != 0)
// gets a scalar head and tail.
//
// Two forms of the pair term a_ij (kappa_i = sum_j mask_ij a_ij / k):
//   * direct (kappa_fwd, curv_term, kappa_bwd's "direct" radius): with
//     v = p_j - p_i, a = |unit(v) . n_i| with unit(v) = v / max(|v|, 1e-12),
//     what the reference's normalize computes and what the TPU's curvature
//     term builds from per-plane differences; d = |v|^2 is exactly 0 on the
//     self column and on coincident points, where the term is 0;
//   * expansion (kappa_frommask, as the TPU's row 9, and kappa_bwd's
//     "expansion" radius): a = |n_i.p_j - n_i.p_i| / max(r, 1e-12) with
//     r = sqrt(d_ij) from the distance expansion, gated to 0 where d_ij == 0.
// Each backward is the gradient of its own forward: |x|'(0) = 0, and the
// radius carries no gradient at or below the 1e-12 clamp.
//
// The mask consumers (curv_term, kappa_frommask, kappa_bwd) stage the
// instance's cloud as three planes in shared memory, read each mask row once
// in 16-byte loads (the next row's first 1024 bytes in flight while a warp
// works on the current one), compact the row's members into a per-warp list
// and give each member one lane. curv_term computes
// curv = mean_i (kappa_i - ref_i)^2 and its gradient in one pass (the
// cotangent of kappa_i is row-local). The gradients are summed with global
// atomics into an output zeroed on the stream, each pair's three components
// as one float2 and one float atomic (Hopper's vector atomics: a point's
// (x, y) or (y, z) pair is 8-byte aligned by its index's parity). Summing
// in shared memory instead (a cluster of 8 blocks a cloud, with atomics on
// distributed shared memory, or per-block sums reduced across the cluster)
// measured slower on the H100 (PERF.md). Atomic sums vary in the last bits
// between runs.
//
// Bound on the H100: bytes, the [b,n,n] int8 mask written (selection) or read
// (consumers): 32 MB at the main path's [32,1024,1024].
#include "select.cuh"

namespace {

constexpr float kEps = 1e-12f;
constexpr int kMaxK = 64;  // select.cuh's list: two keys a lane
constexpr int kMaxMembers = kMaxK + 1;
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory a block can use

// ---- selection ------------------------------------------------------------

constexpr int kSelWarps = 8;
constexpr int kSelRows = 4;  // rows a warp selects at once
constexpr int kSelRowsPerBlock = kSelWarps * kSelRows;

__device__ __forceinline__ unsigned bit16(int off) {
  return (unsigned)off < 16u ? 1u << off : 0u;
}

// Four mask bits -> four bytes of 0 / 1 (little-endian: bit t -> byte t).
__device__ __forceinline__ unsigned spread4(unsigned x) {
  return (x & 1u) | ((x & 2u) << 7) | ((x & 4u) << 14) | ((x & 8u) << 21);
}

// Bytes of mrow's start before its first 16-byte boundary (at most n).
__device__ __forceinline__ int head_bytes(const int8_t* mrow, int n) {
  return min(n, (int)((16u - (unsigned)(reinterpret_cast<uintptr_t>(mrow) &
                                        15u)) & 15u));
}

// Row i of the mask: columns i and mj (the row's L neighbours, slot s of
// lane t holding position 32 s + t) set, every other column 0.
template <int kKPL>
__device__ __forceinline__ void write_mask_row(int8_t* mrow, int n, int i,
                                               const int (&mj)[kKPL], int L,
                                               int lane) {
  // calls f(j) on every lane for each neighbour j
  auto members = [&](auto f) {
#pragma unroll
    for (int s = 0; s < kKPL; ++s)
      for (int p = 32 * s; p < min(L, 32 * s + 32); ++p)
        f(__shfl_sync(GEOA3_FULL_MASK, mj[s], p & 31));
  };
  const int head = head_bytes(mrow, n);
  const int body = (n - head) & ~15;
  const int tail = n - head - body;
  if (head | tail) {  // warp-uniform
    const int ch = lane < head ? lane : -1;
    const int ct = lane < tail ? head + body + lane : -1;
    bool sh = ch == i, st = ct == i;
    members([&](int j) {
      sh |= j == ch;
      st |= j == ct;
    });
    if (ch >= 0) mrow[ch] = sh ? 1 : 0;
    if (ct >= 0) mrow[ct] = st ? 1 : 0;
  }
  uint4* dst = reinterpret_cast<uint4*>(mrow + head);
  const int chunks = body >> 4;
  for (int g = 0; g < chunks; g += 2 * 32) {  // 1024 columns a pass
    int base[2];
    unsigned bits[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      base[t] = head + 16 * (g + 32 * t + lane);
      bits[t] = bit16(i - base[t]);
    }
    members([&](int j) {
#pragma unroll
      for (int t = 0; t < 2; ++t) bits[t] |= bit16(j - base[t]);
    });
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int c = g + 32 * t + lane;
      if (c < chunks)
        dst[c] = make_uint4(spread4(bits[t]), spread4(bits[t] >> 4),
                            spread4(bits[t] >> 8), spread4(bits[t] >> 12));
    }
  }
}

// a_ij and its pieces for one (row i, column j) pair.
struct PairTerm {
  float s;  // the signed numerator: n_i.p_j - n_i.p_i, or unit(p_j - p_i).n_i
  float r;  // the radius: sqrt(d_ij) where d_ij > 0, else 0; or |p_j - p_i|
  float R;  // max(r, eps)
  float a;  // the pair's term of kappa_i (before the 1/k)
};

// Which form a pair term takes.
enum class Radius { kExpansion, kDirect };

// One row's constants, loaded once by its warp.
struct RowCtx {
  float px, py, pz, p2;  // p_i and |p_i|^2
  float nx, ny, nz;      // n_i
  float sdiag;           // n_i.p_i
};

__device__ __forceinline__ RowCtx load_row(float px, float py, float pz,
                                           const float* __restrict__ N) {
  RowCtx c;
  c.px = px;
  c.py = py;
  c.pz = pz;
  c.p2 = geoa3_sq3(px, py, pz);
  c.nx = N[0];
  c.ny = N[1];
  c.nz = N[2];
  c.sdiag = geoa3_dot3(c.nx, c.ny, c.nz, px, py, pz);
  return c;
}

// The expansion form: a = |s| / max(r, eps), s = n_i.p_j - n_i.p_i.
__device__ __forceinline__ PairTerm pair_term_expansion(const RowCtx& c,
                                                        float qx, float qy,
                                                        float qz) {
  PairTerm t;
  t.s = __fsub_rn(geoa3_dot3(c.nx, c.ny, c.nz, qx, qy, qz), c.sdiag);
  const float d = geoa3_sqdist(c.p2, geoa3_sq3(qx, qy, qz),
                               geoa3_dot3(c.px, c.py, c.pz, qx, qy, qz));
  t.r = d > 0.0f ? sqrtf(d) : 0.0f;
  t.R = fmaxf(t.r, kEps);
  t.a = fabsf(t.s) / t.R;
  return t;
}

// The direct form: a = |unit(p_j - p_i) . n_i|.
__device__ __forceinline__ PairTerm pair_term_direct(const RowCtx& c, float qx,
                                                     float qy, float qz) {
  PairTerm t;
  const float vx = __fsub_rn(qx, c.px), vy = __fsub_rn(qy, c.py),
              vz = __fsub_rn(qz, c.pz);
  t.r = sqrtf(geoa3_sq3(vx, vy, vz));
  t.R = fmaxf(t.r, kEps);
  t.s = geoa3_dot3(vx / t.R, vy / t.R, vz / t.R, c.nx, c.ny, c.nz);
  t.a = fabsf(t.s);
  return t;
}

template <Radius kRadius>
__device__ __forceinline__ PairTerm pair_term(const RowCtx& c, float qx,
                                              float qy, float qz) {
  return kRadius == Radius::kDirect ? pair_term_direct(c, qx, qy, qz)
                                    : pair_term_expansion(c, qx, qy, qz);
}

// The pair's gradient on p_j for the weight w = d loss / d a_ij (its
// negative goes to p_i). da/ds = sign(s)/R (or sign(s) for the direct pair,
// whose s is already divided by R); da/dr = -a/R above the clamp only,
// dr/dp_j = (p_j - p_i)/r: the gradient is c n_i + e (p_j - p_i).
__device__ __forceinline__ float3 pair_grad(const RowCtx& c, const PairTerm& t,
                                            float qx, float qy, float qz,
                                            float w) {
  const float sg = t.s > 0.0f ? 1.0f : (t.s < 0.0f ? -1.0f : 0.0f);
  const float cc = w * sg / t.R;
  const float e = t.r > kEps ? -w * t.a / (t.r * t.r) : 0.0f;
  return make_float3(cc * c.nx + e * (qx - c.px), cc * c.ny + e * (qy - c.py),
                     cc * c.nz + e * (qz - c.pz));
}

// G[J] += v for row J of a [*, 3] float array: one float2 atomic on the
// 8-byte aligned pair of components (x, y for even J, y, z for odd J) and
// one float atomic on the third, chosen by selects so that the lanes of a
// warp do not diverge.
__device__ __forceinline__ void add3(float* __restrict__ G, size_t J, float3 v) {
  const bool odd = J & 1;
  float* row = G + 3 * J;
  atomicAdd(reinterpret_cast<float2*>(row + odd),
            odd ? make_float2(v.y, v.z) : make_float2(v.x, v.y));
  atomicAdd(row + (odd ? 0 : 2), odd ? v.x : v.z);
}

template <bool kWithKappa, int kKPL>
__global__ void __launch_bounds__(kSelWarps * 32)
    kappa_select_kernel(const float* __restrict__ cloud,
                        const float* __restrict__ normal, int n, int k,
                        float* __restrict__ kappa, int8_t* __restrict__ mask) {
  __shared__ float4 tile[geoa3::kTile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const float* P = cloud + (size_t)b * n * 3;
  int row[kSelRows];
  float q[kSelRows][4];
#pragma unroll
  for (int r = 0; r < kSelRows; ++r) {
    const int i = blockIdx.x * kSelRowsPerBlock + warp * kSelRows + r;
    row[r] = i < n ? i : -1;
    const float* Q = P + (size_t)min(i, n - 1) * 3;
    q[r][0] = Q[0];
    q[r][1] = Q[1];
    q[r][2] = Q[2];
    q[r][3] = geoa3_sq3(q[r][0], q[r][1], q[r][2]);
  }
  geoa3::WarpList<kKPL> list[kSelRows];
  geoa3::select_rows<kKPL, kSelRows, true>(P, n, tile, q, row, k, list);

#pragma unroll
  for (int r = 0; r < kSelRows; ++r) {
    const int i = row[r];
    if (i < 0) continue;  // warp-uniform
    int mj[kKPL];
#pragma unroll
    for (int s = 0; s < kKPL; ++s) mj[s] = list[r].index(s);
    write_mask_row<kKPL>(mask + ((size_t)b * n + i) * n, n, i, mj, k, lane);
    if (kWithKappa) {
      const RowCtx c =
          load_row(q[r][0], q[r][1], q[r][2], normal + ((size_t)b * n + i) * 3);
      float acc = 0.0f;
#pragma unroll
      for (int s = 0; s < kKPL; ++s) {
        if (32 * s + lane < k) {
          const float* Qj = P + (size_t)mj[s] * 3;
          acc += pair_term_direct(c, Qj[0], Qj[1], Qj[2]).a;
        }
      }
      acc = geoa3_warp_sum(acc);
      if (lane == 0) kappa[(size_t)b * n + i] = acc / (float)k;
    }
  }
}

// ---- mask consumers -------------------------------------------------------

constexpr int kMaskWarps = 16;
constexpr int kSlots = (kMaxMembers + 31) / 32;  // members a lane

// Four mask bytes -> a bit for each nonzero one (bit t for byte t).
__device__ __forceinline__ unsigned nonzero4(unsigned x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// The first 64 16-byte chunks of mask row mrow [n] after its unaligned
// head, two a lane (zero past the row).
__device__ __forceinline__ void load_lead(const int8_t* __restrict__ mrow,
                                          int n, int lane, uint4 (&lead)[2]) {
  const int head = head_bytes(mrow, n);
  const int chunks = (n - head) >> 4;
  const uint4* src = reinterpret_cast<const uint4*>(mrow + head);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int c = 32 * t + lane;
    lead[t] = c < chunks ? __ldg(src + c) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Read mask row mrow [n] once (16-byte loads, the first 64 of them already in
// `lead`; a scalar head and tail where the row is not 16-byte aligned) and
// write its set columns to the warp's list (at most kMaxMembers of them).
// Returns how many were written.
__device__ int row_members(const int8_t* __restrict__ mrow, int n, int lane,
                           int* list, const uint4 (&lead)[2]) {
  const unsigned below = (1u << lane) - 1u;
  int count = 0;
  auto emit = [&](bool hit, int col) {
    const unsigned bal = __ballot_sync(GEOA3_FULL_MASK, hit);
    if (hit) {
      const int pos = count + __popc(bal & below);
      if (pos < kMaxMembers) list[pos] = col;
    }
    count += __popc(bal);
  };
  const int head = head_bytes(mrow, n);
  const int body = (n - head) & ~15;
  const int tail = n - head - body;
  if (head | tail) {  // warp-uniform
    emit(lane < head && mrow[lane] != 0, lane);
    const int ct = head + body + lane;
    emit(lane < tail && mrow[ct] != 0, ct);
  }
  const uint4* src = reinterpret_cast<const uint4*>(mrow + head);
  const int chunks = body >> 4;
  for (int g = 0; g < chunks; g += 2 * 32) {
    unsigned bits[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int c = g + 32 * t + lane;
      uint4 w = lead[t];
      if (g > 0) w = c < chunks ? __ldg(src + c) : make_uint4(0u, 0u, 0u, 0u);
      bits[t] = nonzero4(w.x) | (nonzero4(w.y) << 4) | (nonzero4(w.z) << 8) |
                (nonzero4(w.w) << 12);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int col0 = head + 16 * (g + 32 * t + lane);
      while (__any_sync(GEOA3_FULL_MASK, bits[t] != 0u)) {
        const bool hit = bits[t] != 0u;
        emit(hit, col0 + __ffs(bits[t]) - 1);
        bits[t] &= bits[t] - 1u;
      }
    }
  }
  __syncwarp();  // the list is complete for every lane
  return min(count, kMaxMembers);
}

// The consumers' shared memory: the instance's cloud as three planes, then
// one member list a warp.
struct Staged {
  const float *sx, *sy, *sz;
  int* lists;
};

__device__ __forceinline__ Staged stage_planes(const float* __restrict__ P,
                                               int n, float* smem) {
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    sx[j] = P[(size_t)j * 3];
    sy[j] = P[(size_t)j * 3 + 1];
    sz[j] = P[(size_t)j * 3 + 2];
  }
  return Staged{sx, sy, sz, reinterpret_cast<int*>(sz + n)};
}

constexpr size_t consumer_smem(int n) {
  return (size_t)3 * n * sizeof(float) +
         (size_t)kMaskWarps * kMaxMembers * sizeof(int);
}

// Rows [r0, r1) of the block: blockIdx.x's share of S rows.
struct RowRange {
  int r0, r1;
};

__device__ __forceinline__ RowRange row_range(int n, int S) {
  const int r0 = min(n, (int)blockIdx.x * S);
  return RowRange{r0, min(n, r0 + S)};
}

// f(i, cnt) for the warp's rows i of instance b in rr (every kMaskWarps-th
// from rr.r0 + warp), row i's cnt members in the warp's list. The next
// row's first 1024 mask bytes are in flight while f works on the current one.
template <typename F>
__device__ __forceinline__ void for_mask_rows(const int8_t* __restrict__ mask,
                                              int b, int n, RowRange rr,
                                              int* list, F&& f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int8_t* base = mask + (size_t)b * n * n;
  uint4 next[2];
  int i = rr.r0 + warp;
  if (i < rr.r1) load_lead(base + (size_t)i * n, n, lane, next);
  for (; i < rr.r1; i += kMaskWarps) {
    const uint4 lead[2] = {next[0], next[1]};
    if (i + kMaskWarps < rr.r1)
      load_lead(base + (size_t)(i + kMaskWarps) * n, n, lane, next);
    f(i, row_members(base + (size_t)i * n, n, lane, list, lead));
    __syncwarp();  // the list is rewritten for the next row
  }
}

// kappa from a cached mask: the expansion form (row 9).
__global__ void __launch_bounds__(kMaskWarps * 32)
    kappa_frommask_kernel(const float* __restrict__ cloud,
                          const float* __restrict__ normal,
                          const int8_t* __restrict__ mask, int n, int k,
                          float* __restrict__ kappa, int S) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const Staged s = stage_planes(cloud + (size_t)b * n * 3, n, smem);
  int* list = s.lists + warp * kMaxMembers;
  __syncthreads();
  for_mask_rows(mask, b, n, row_range(n, S), list, [&](int i, int cnt) {
    const RowCtx c =
        load_row(s.sx[i], s.sy[i], s.sz[i], normal + ((size_t)b * n + i) * 3);
    float acc = 0.0f;
    for (int p = lane; p < cnt; p += 32) {
      const int j = list[p];
      acc += pair_term_expansion(c, s.sx[j], s.sy[j], s.sz[j]).a;
    }
    acc = geoa3_warp_sum(acc);
    if (lane == 0) kappa[(size_t)b * n + i] = acc / (float)k;
  });
}

// grad[b, :, :] += sum_i g[b, i] d kappa_i / d cloud, from the mask; the
// launcher zeroes grad.
template <Radius kRadius>
__global__ void __launch_bounds__(kMaskWarps * 32)
    kappa_bwd_kernel(const float* __restrict__ cloud,
                     const float* __restrict__ normal,
                     const int8_t* __restrict__ mask,
                     const float* __restrict__ g, int n, int k,
                     float* __restrict__ grad, int S) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const Staged s = stage_planes(cloud + (size_t)b * n * 3, n, smem);
  int* list = s.lists + warp * kMaxMembers;
  const size_t row0 = (size_t)b * n;  // the instance's first row of grad
  __syncthreads();
  for_mask_rows(mask, b, n, row_range(n, S), list, [&](int i, int cnt) {
    const RowCtx c =
        load_row(s.sx[i], s.sy[i], s.sz[i], normal + ((size_t)b * n + i) * 3);
    const float w = g[(size_t)b * n + i] / (float)k;
    float cx = 0.0f, cy = 0.0f, cz = 0.0f;
    for (int p = lane; p < cnt; p += 32) {
      const int j = list[p];
      const float qx = s.sx[j], qy = s.sy[j], qz = s.sz[j];
      const float3 v =
          pair_grad(c, pair_term<kRadius>(c, qx, qy, qz), qx, qy, qz, w);
      if (j != i) add3(grad, row0 + j, v);
      cx -= v.x;
      cy -= v.y;
      cz -= v.z;
    }
    cx = geoa3_warp_sum(cx);
    cy = geoa3_warp_sum(cy);
    cz = geoa3_warp_sum(cz);
    if (lane == 0) add3(grad, row0 + i, make_float3(cx, cy, cz));
  });
}

// The curvature term and its gradient (direct form), added into curv and
// grad, which the launcher zeroes.
__global__ void __launch_bounds__(kMaskWarps * 32)
    curv_term_kernel(const float* __restrict__ cloud,
                     const float* __restrict__ normal,
                     const float* __restrict__ ref,
                     const int8_t* __restrict__ mask, int n, int k,
                     float* __restrict__ curv, float* __restrict__ grad, int S) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const Staged s = stage_planes(cloud + (size_t)b * n * 3, n, smem);
  int* list = s.lists + warp * kMaxMembers;
  float* warp_part = reinterpret_cast<float*>(s.lists + kMaskWarps * kMaxMembers);
  const size_t row0 = (size_t)b * n;  // the instance's first row of grad
  __syncthreads();

  float sq = 0.0f;  // this warp's sum of (kappa_i - ref_i)^2 / n
  for_mask_rows(mask, b, n, row_range(n, S), list, [&](int i, int cnt) {
    const RowCtx c =
        load_row(s.sx[i], s.sy[i], s.sz[i], normal + ((size_t)b * n + i) * 3);
    PairTerm t[kSlots];
    int jj[kSlots];
    float acc = 0.0f;
#pragma unroll
    for (int sl = 0; sl < kSlots; ++sl) {
      const int p = 32 * sl + lane;
      jj[sl] = p < cnt ? list[p] : -1;
      if (jj[sl] >= 0) {
        t[sl] = pair_term_direct(c, s.sx[jj[sl]], s.sy[jj[sl]], s.sz[jj[sl]]);
        acc += t[sl].a;
      }
    }
    const float kap = geoa3_warp_sum(acc) / (float)k;
    const float diff = kap - ref[(size_t)b * n + i];
    sq += diff * diff / (float)n;
    // d curv / d kappa_i = 2 diff / n; d kappa_i / d a_ij = 1 / k
    const float w = 2.0f * diff / (float)n / (float)k;
    float cx = 0.0f, cy = 0.0f, cz = 0.0f;
#pragma unroll
    for (int sl = 0; sl < kSlots; ++sl) {
      const int j = jj[sl];
      if (j < 0) continue;
      const float3 v = pair_grad(c, t[sl], s.sx[j], s.sy[j], s.sz[j], w);
      if (j != i) add3(grad, row0 + j, v);
      cx -= v.x;
      cy -= v.y;
      cz -= v.z;
    }
    cx = geoa3_warp_sum(cx);
    cy = geoa3_warp_sum(cy);
    cz = geoa3_warp_sum(cz);
    if (lane == 0) add3(grad, row0 + i, make_float3(cx, cy, cz));
  });
  if (lane == 0) warp_part[warp] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.0f;
    for (int w = 0; w < kMaskWarps; ++w) tot += warp_part[w];
    atomicAdd(curv + b, tot);
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Rows a block of a mask consumer evaluates: about two blocks an SM in all,
// at least 32 rows a block.
int consumer_rows(int b, int n) {
  const int per_cloud = max(1, min((n + 31) / 32, (2 * sm_count() + b - 1) / b));
  return (n + per_cloud - 1) / per_cloud;
}

template <bool kWithKappa>
int launch_select(const float* cloud, const float* normal, int b, int n, int k,
                  float* kappa, int8_t* mask, cudaStream_t s) {
  if (k > kMaxK) return (int)cudaErrorInvalidValue;
  dim3 grid((n + kSelRowsPerBlock - 1) / kSelRowsPerBlock, b);
  if (k <= 32)
    kappa_select_kernel<kWithKappa, 1><<<grid, kSelWarps * 32, 0, s>>>(
        cloud, normal, n, k, kappa, mask);
  else
    kappa_select_kernel<kWithKappa, 2><<<grid, kSelWarps * 32, 0, s>>>(
        cloud, normal, n, k, kappa, mask);
  return (int)cudaGetLastError();
}

// Launch a mask consumer over row ranges of S rows, the instance's cloud
// staged in shared memory.
template <typename Kernel, typename... Args>
int launch_rows(Kernel kernel, int b, int n, size_t smem, cudaStream_t stream,
                Args... args) {
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int S = consumer_rows(b, n);
  dim3 grid((n + S - 1) / S, b);
  kernel<<<grid, kMaskWarps * 32, smem, stream>>>(args..., S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int geoa3_kappa_selmask(const float* cloud, int b, int n, int k,
                                   int8_t* mask, void* stream) {
  return launch_select<false>(cloud, nullptr, b, n, k, nullptr, mask,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int geoa3_kappa_fwd(const float* cloud, const float* normal, int b,
                               int n, int k, float* kappa, int8_t* mask,
                               void* stream) {
  return launch_select<true>(cloud, normal, b, n, k, kappa, mask,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int geoa3_curv_term(const float* cloud, const float* normal,
                               const float* ref, const int8_t* mask, int b,
                               int n, int k, float* curv, float* grad,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k > kMaxK) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(curv, 0, (size_t)b * sizeof(float), s);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(grad, 0, (size_t)b * n * 3 * sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  return launch_rows(curv_term_kernel, b, n,
                     consumer_smem(n) + kMaskWarps * sizeof(float), s, cloud,
                     normal, ref, mask, n, k, curv, grad);
}

extern "C" int geoa3_kappa_frommask(const float* cloud, const float* normal,
                                    const int8_t* mask, int b, int n, int k,
                                    float* kappa, void* stream) {
  return launch_rows(kappa_frommask_kernel, b, n, consumer_smem(n),
                     static_cast<cudaStream_t>(stream), cloud, normal, mask, n,
                     k, kappa);
}

// direct != 0: the gradient of geoa3_kappa_fwd's kappa; else the gradient of
// geoa3_kappa_frommask's. The wrapper zeroes grad.
extern "C" int geoa3_kappa_bwd(const float* cloud, const float* normal,
                               const int8_t* mask, const float* g, int b, int n,
                               int k, int direct, float* grad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (direct)
    return launch_rows(kappa_bwd_kernel<Radius::kDirect>, b, n,
                       consumer_smem(n), s, cloud, normal, mask, g, n, k, grad);
  return launch_rows(kappa_bwd_kernel<Radius::kExpansion>, b, n,
                     consumer_smem(n), s, cloud, normal, mask, g, n, k, grad);
}
