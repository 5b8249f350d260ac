// Self-kNN selection and the curvature (kappa) statistic.
//
// Replaces five kernels of geoa3_tpu/ops/pallas/kappa_kernel.py (exact
// selection only):
//   _kappa_selmask_kernel      -> kappa_select_kernel<false>
//   _kappa_fwd_kernel          -> kappa_select_kernel<true>
//   _curv_term_frommask_kernel -> curv_term_kernel
//   _kappa_frommask_kernel     -> kappa_frommask_stream_kernel<kStaged>
//   _kappa_bwd_kernel          -> kappa_bwd_stream_kernel<Radius, kStaged>
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
// The curvature term (curv_term_kernel) stages the instance's cloud as three
// planes in shared memory, reads each mask row once in 16-byte loads (the
// next row's first 1024 bytes in flight while a warp works on the current
// one), compacts the row's members into a per-warp list and gives each
// member one lane. It computes curv = mean_i (kappa_i - ref_i)^2 and its
// gradient in one pass (the cotangent of kappa_i is row-local).
//
// kappa from a mask and the kappa backward (rows 9 and 8) share one mask
// stream (stream_rows): a block owns a contiguous range of one cloud's rows,
// whose mask bytes are one contiguous span. One thread of a producer warp
// streams the span into a ring of shared-memory stages of whole rows by the
// 1D bulk copy (TMA), each stage completed on an mbarrier, the first stages
// asked for before the block stages anything else, so the mask stream
// overlaps the staging of the cloud (float4 (x, y, z, |p|^2), where it fits
// beside the ring; its points are read through L2 past that), the share's
// normals and cotangents. Sixteen consumer warps take rows two at a time,
// one a half-warp, out of the stages and release each stage on an empty
// mbarrier for the producer to refill. A row then runs from shared memory
// and registers alone: members by a prefix sum of the lanes' nonzero bytes
// over its 16-byte words (its own column left out: its term is exactly 0,
// and k = 16 members then fill the sixteen lanes), one lane a member's pair
// term, half-warp sums, one store (row 9) or the atomics (row 8). Copies
// start and end on 16-byte boundaries, so a share whose rows are not
// 16-byte aligned (n % 16 != 0) is copied from the boundary at or below its
// start; its last < 16 bytes, past the boundary at or below its end, are
// read with plain loads. Row 4's reading (above) leaves each row's chain
// with dependent device loads (its normal, its cotangent) and asks for no
// mask byte before the cloud is staged; the stream alone runs at the byte
// bound on the H100, and the rows' instructions are what remains.
//
// The gradients are summed with global atomics into an output zeroed on the
// stream, each pair's three components as one float2 and one float atomic
// (Hopper's vector atomics: a point's (x, y) or (y, z) pair is 8-byte
// aligned by its index's parity). Summing in shared memory instead (a
// cluster of 8 blocks a cloud, with atomics on distributed shared memory, or
// per-block sums reduced across the cluster) measured slower on the H100
// (PERF.md). Atomic sums vary in the last bits between runs.
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

// ---- rows 9 and 8: one bulk-copied mask stream ----------------------------

constexpr int kStreamWarps = 16;  // consumer warps a block
constexpr int kStreamThreads = (kStreamWarps + 1) * 32;  // and a producer warp
constexpr int kStageTarget = 16384;  // mask bytes a stage, about: whole rows
constexpr int kInFlight = 49152;     // mask bytes a block keeps in flight
constexpr int kMinStages = 4, kMaxStages = 16;
constexpr int kMinRows = 32, kMaxRows = 256;  // rows a block

// mbarriers and the 1D bulk copy (TMA). The CPU emulation of the source
// (tests/cuda_emu/cuda_runtime.h, which defines GEOA3_EMU) supplies a
// synchronous copy and barriers that count arrivals and bytes.
#ifndef GEOA3_EMU
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// the initialised barriers visible to the bulk copies (the async proxy)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// arrive, and expect `bytes` more of the barrier's bulk copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16) from 16-byte aligned device memory into 16-byte
// aligned shared memory, completed on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
#endif

// A launch's plan (stream_plan): each block owns S consecutive rows of one
// cloud, streamed through a ring of `depth` stages of `stage` bytes, R whole
// rows a stage (R and depth powers of two: stages and slots by shifts and
// masks).
struct StreamPlan {
  int S, R, depth, stage, per_cloud;
  size_t smem;
};

// A block's share of the mask: rows [r0, r0 + rows) of one cloud, whose
// bytes [lo, lo + rows n) are contiguous. Stage s holds rows [s R, s R + R)
// of the share, copied from the 16-byte boundary at or below its first byte
// to the boundary at or above its last, but never past `tail`, the share's
// end rounded down to 16 bytes: the bytes from there are read with plain
// loads, so nothing outside the share's 16-byte lines is read.
struct Share {
  uintptr_t lo, tail;
  int n, rows, R;

  __device__ __forceinline__ uintptr_t row_at(int t) const {
    return lo + (size_t)t * n;
  }
  __device__ __forceinline__ uintptr_t copy_from(int s) const {
    return row_at(s * R) & ~(uintptr_t)15;
  }
  __device__ __forceinline__ unsigned copy_bytes(int s) const {
    uintptr_t end = (row_at(min(rows, (s + 1) * R)) + 15) & ~(uintptr_t)15;
    end = end < tail ? end : tail;
    const uintptr_t from = copy_from(s);
    return end > from ? (unsigned)(end - from) : 0u;
  }
  // columns of row t that lie in its stage (the rest from device memory)
  __device__ __forceinline__ int staged_cols(int t) const {
    const uintptr_t at = row_at(t);
    return at >= tail ? 0 : (tail - at < (uintptr_t)n ? (int)(tail - at) : n);
  }
};

constexpr int kScan = 4;  // 16-byte words a lane reads a round of a row's scan

// The nonzero bytes of a 16-byte word as bits, bit 8 b + w for byte b of its
// 32-bit word w: a byte's high bit, or'ed with its low seven bits plus 0x7f
// (no carry leaves the byte), is set iff the byte is nonzero.
__device__ __forceinline__ unsigned nonzero16(uint4 v) {
  auto nz = [](unsigned x) {
    return (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
  };
  return (nz(v.x) >> 7) | (nz(v.y) >> 6) | (nz(v.z) >> 5) | (nz(v.w) >> 4);
}

// The members of a row staged in shared memory (srow [n]), column `self`
// left out (its pair term and gradient are exactly 0), into the half-warp's
// list (at most kMaxMembers; returns how many). Each half of the warp (lane
// hl of half `half`) reads its own row of n columns: a scalar head and tail
// where the row is not 16-byte aligned, placed by ballot, then kScan 16-byte
// words a lane a round, each lane writing its nonzero bytes' columns from
// its place in a prefix sum of the half's counts. Columns from `from` on
// are read from the row in device memory (grow), where the share's last
// bytes were not copied.
__device__ int staged_members(const int8_t* srow, const int8_t* __restrict__ grow,
                              int n, int from, int self, int hl, int half,
                              int* list) {
  int count = 0;
  auto emit = [&](bool hit, int col) {
    const unsigned bal =
        (__ballot_sync(GEOA3_FULL_MASK, hit) >> (16 * half)) & 0xffffu;
    if (hit) {
      const int pos = count + __popc(bal & ((1u << hl) - 1u));
      if (pos < kMaxMembers) list[pos] = col;
    }
    count += __popc(bal);
  };
  auto byte = [&](int c) { return c < from ? srow[c] : __ldg(grow + c); };
  const int head = head_bytes(srow, n);
  const int body = (n - head) & ~15;
  const int tail = n - head - body;
  if (__any_sync(GEOA3_FULL_MASK, (head | tail) != 0)) {  // head, tail < 16
    emit(hl < head && hl != self && byte(hl) != 0, hl);
    const int ct = head + body + hl;
    emit(hl < tail && ct != self && byte(ct) != 0, ct);
  }
  const uint4* src = reinterpret_cast<const uint4*>(srow + head);
  const int chunks = body >> 4;
  const int so = self - head;  // self's byte in the body, and its bit
  const int self_chunk = so >= 0 && so < body ? so >> 4 : -1;
  const unsigned self_bit = 1u << (8 * (so & 3) + ((so >> 2) & 3));
  // rounds counted from n, the same for both halves (chunks <= n / 16)
  for (int g = hl; g < (n >> 4) + hl; g += kScan * 16) {
    unsigned bits[kScan];
    int mine = 0;
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int c = g + 16 * u;
      bits[u] = c < chunks ? nonzero16(src[c]) : 0u;
      if (c == self_chunk) bits[u] &= ~self_bit;
      mine += __popc(bits[u]);
    }
    int upto = mine;  // inclusive prefix sum over the half's lanes
#pragma unroll
    for (int d = 1; d < 16; d <<= 1) {
      const int o = __shfl_up_sync(GEOA3_FULL_MASK, upto, d, 16);
      if (hl >= d) upto += o;
    }
    int pos = count + upto - mine;
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      for (unsigned w = bits[u]; w != 0u; w &= w - 1u, ++pos) {
        const int q = __ffs(w) - 1;
        if (pos < kMaxMembers)
          list[pos] = head + 16 * (g + 16 * u) + 4 * (q & 7) + (q >> 3);
      }
    }
    count += __shfl_sync(GEOA3_FULL_MASK, upto, 15, 16);
  }
  __syncwarp();  // the lists are complete for every lane
  return min(count, kMaxMembers);
}

// The sum of v over the lane's half-warp, on every lane of it.
__device__ __forceinline__ float half_sum(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(GEOA3_FULL_MASK, v, off);
  return v;
}

// (a, b, c) summed over the lane's half-warp in five shuffles (each level
// keeps half the values a lane holds and adds its partner's copy of them):
// half-lane 0 gets a's sum, 4 b's, 8 c's.
__device__ __forceinline__ float half_sum3(float a, float b, float c, int hl) {
  const unsigned all = GEOA3_FULL_MASK;
  const bool lo = (hl & 8) == 0;
  const float k0 = (lo ? a : c) + __shfl_xor_sync(all, lo ? c : a, 8);
  const float k1 = (lo ? b : 0.0f) + __shfl_xor_sync(all, lo ? 0.0f : b, 8);
  const bool lo4 = (hl & 4) == 0;
  float k = (lo4 ? k0 : k1) + __shfl_xor_sync(all, lo4 ? k1 : k0, 4);
  for (int off = 2; off > 0; off >>= 1) k += __shfl_xor_sync(all, k, off);
  return k;
}

// The cloud's points as (x, y, z, |p|^2): staged in shared memory, or read
// from device memory (through L2) where the cloud does not fit beside the
// ring.
template <bool kStaged>
struct Points {
  const float4* staged;
  const float* __restrict__ P;

  __device__ __forceinline__ float4 operator[](int j) const {
    if constexpr (kStaged) {
      return staged[j];
    } else {
      const float x = __ldg(P + (size_t)j * 3), y = __ldg(P + (size_t)j * 3 + 1),
                  z = __ldg(P + (size_t)j * 3 + 2);
      return make_float4(x, y, z, geoa3_sq3(x, y, z));
    }
  }
};

// The stream's shared memory, in this order: the ring, the cloud (where
// staged), the full and empty barriers, the share's normals [S, 3] and
// cotangents [S], one member list a consumer half-warp.
size_t stream_smem(int n, bool staged, int S, int depth, int stage) {
  return (size_t)depth * stage + (staged ? (size_t)n * sizeof(float4) : 0) +
         (size_t)depth * 2 * sizeof(uint64_t) + (size_t)S * 4 * sizeof(float) +
         (size_t)kStreamWarps * 2 * kMaxMembers * sizeof(int);
}

// row(i, t, c, cnt, list, pts, gs, hl, valid) for each row i = r0 + t of the
// block's share, run by a half-warp (hl its lane): c the row's constants,
// its cnt members (itself left out) in the half's list, gs the share's
// staged cotangents; `valid` is false on a half that repeats the share's
// last row (an odd count of rows), which must write nothing. One elected
// thread of the producer warp streams the share's mask bytes through the
// ring by bulk copies, each stage completed on its full barrier, the first
// `depth` stages asked for before anything else; meanwhile every thread
// stages the cloud (float4, where it fits), the share's normals and, for
// row 8, its cotangents. Consumer warp w takes the row pairs (2 q, 2 q + 1)
// with q = w, w + 16, ..., one row a half-warp, from shared memory alone.
// Every consumer warp waits for every stage in order and releases it on its
// empty barrier once it has no row in it left, whether or not it held one
// (where a stage holds fewer rows than there are warps): a warp that skipped
// stages could find a barrier two phases behind its own, which a phase's
// parity does not tell apart. The producer refills a stage once all sixteen
// have released it. A warp holds at most the two stages of its pair, and
// the ring holds at least two, so the slowest warp can always go on.
template <bool kStaged, typename Row>
__device__ __forceinline__ void stream_rows(const float* __restrict__ cloud,
                                            const float* __restrict__ normal,
                                            const float* __restrict__ g,
                                            const int8_t* __restrict__ mask,
                                            int n, const StreamPlan& p,
                                            float* smem, Row&& row) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y, r0 = blockIdx.x * p.S;
  const int rs = __ffs(p.R) - 1, slots = p.depth - 1;  // log2 R; slot mask
  const int rows = min(p.S, n - r0), stages = (rows + p.R - 1) >> rs;
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  float4* staged = reinterpret_cast<float4*>(ring + (size_t)p.depth * p.stage);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(staged + (kStaged ? n : 0));
  uint64_t* empty = full + p.depth;
  float* ns = reinterpret_cast<float*>(empty + p.depth);
  float* gs = ns + 3 * p.S;
  int* lists = reinterpret_cast<int*>(gs + p.S) + warp * 2 * kMaxMembers;
  const uintptr_t lo =
      reinterpret_cast<uintptr_t>(mask + ((size_t)b * n + r0) * n);
  const Share sh{lo, (lo + (size_t)rows * n) & ~(uintptr_t)15, n, rows, p.R};
  auto issue = [&](int s) {
    uint64_t* bar = full + (s & slots);
    const unsigned bytes = sh.copy_bytes(s);
    mbar_expect_tx(bar, bytes);
    if (bytes)
      bulk_copy(ring + (size_t)(s & slots) * p.stage,
                reinterpret_cast<const void*>(sh.copy_from(s)), bytes, bar);
  };
  if (threadIdx.x == kStreamWarps * 32) {
    for (int s = 0; s < p.depth; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kStreamWarps);
    }
    mbar_fence_init();
    for (int s = 0; s < min(stages, p.depth); ++s) issue(s);
  }
  const float* P = cloud + (size_t)b * n * 3;
  if constexpr (kStaged) {
    for (int j = threadIdx.x; j < n; j += kStreamThreads) {
      const float x = __ldg(P + (size_t)j * 3), y = __ldg(P + (size_t)j * 3 + 1),
                  z = __ldg(P + (size_t)j * 3 + 2);
      staged[j] = make_float4(x, y, z, geoa3_sq3(x, y, z));
    }
  }
  const float* N = normal + ((size_t)b * n + r0) * 3;
  for (int e = threadIdx.x; e < 3 * rows; e += kStreamThreads)
    ns[e] = __ldg(N + e);
  if (g != nullptr)
    for (int t = threadIdx.x; t < rows; t += kStreamThreads)
      gs[t] = __ldg(g + (size_t)b * n + r0 + t);
  __syncthreads();  // the block's only barrier: barriers and staging ready

  // stage s sits in ring slot s % depth, its round's phase parity is
  // (s / depth) & 1: both kept as counters
  if (warp == kStreamWarps) {  // the producer: refill released stages
    if (lane == 0)
      for (int s = p.depth, slot = 0, phase = 0; s < stages; ++s) {
        mbar_wait(empty + slot, phase);
        issue(s);
        if (++slot == p.depth) slot = 0, phase ^= 1;
      }
    return;
  }
  int waited = 0, wslot = 0, wphase = 0, released = 0, rslot = 0;
  auto wait_to = [&](int s) {  // every stage up to s has landed
    for (; waited <= s; ++waited) {
      mbar_wait(full + wslot, wphase);
      if (++wslot == p.depth) wslot = 0, wphase ^= 1;
    }
  };
  auto release_to = [&](int s) {  // every stage below s released, in order
    for (; released < s; ++released) {
      wait_to(released);
      __syncwarp();  // every lane is past the wait and done with the stage
      if (lane == 0) mbar_arrive(empty + rslot);
      if (++rslot == p.depth) rslot = 0;
    }
  };
  const int hl = lane & 15, half = lane >> 4;
  int* list = lists + half * kMaxMembers;
  const Points<kStaged> pts{staged, P};
  for (int a = 2 * warp; a < rows; a += 2 * kStreamWarps) {
    const bool valid = a + half < rows;
    const int t = valid ? a + half : a;
    release_to(a >> rs);  // the stages before the pair's, none of its rows
    wait_to(min(a + 1, rows - 1) >> rs);
#ifndef GEOA3_KAPPA_STREAM_ONLY  // a timing variant: the stream alone
    __syncwarp();  // the last pair's lists are read
    const int s = t >> rs;
    const uintptr_t at = sh.row_at(t);
    const int8_t* srow =
        ring + (size_t)(s & slots) * p.stage + (at - sh.copy_from(s));
    const int cnt = staged_members(srow, reinterpret_cast<const int8_t*>(at), n,
                                   sh.staged_cols(t), r0 + t, hl, half, list);
    const float4 q = pts[r0 + t];
    RowCtx c;
    c.px = q.x;
    c.py = q.y;
    c.pz = q.z;
    c.p2 = q.w;
    c.nx = ns[3 * t];
    c.ny = ns[3 * t + 1];
    c.nz = ns[3 * t + 2];
    c.sdiag = geoa3_dot3(c.nx, c.ny, c.nz, q.x, q.y, q.z);
    row(r0 + t, t, c, cnt, list, pts, gs, hl, valid);
#endif
  }
  release_to(stages);
}

// kappa from a cached mask: the expansion form (row 9).
template <bool kStaged>
__global__ void __launch_bounds__(kStreamThreads, 2)
    kappa_frommask_stream_kernel(const float* __restrict__ cloud,
                                 const float* __restrict__ normal,
                                 const int8_t* __restrict__ mask, int n, int k,
                                 float* __restrict__ kappa, StreamPlan p) {
  extern __shared__ float smem[];  // no static shared memory: 16-byte aligned
  float* out = kappa + (size_t)blockIdx.y * n;
  stream_rows<kStaged>(
      cloud, normal, nullptr, mask, n, p, smem,
      [&](int i, int, const RowCtx& c, int cnt, const int* list,
          const Points<kStaged>& pts, const float*, int hl, bool valid) {
        float acc = 0.0f;
        for (int q = hl; q < cnt; q += 16) {
          const float4 pj = pts[list[q]];
          acc += pair_term_expansion(c, pj.x, pj.y, pj.z).a;
        }
        acc = half_sum(acc);
        if (hl == 0 && valid) out[i] = acc / (float)k;
      });
}

// grad[b, :, :] += sum_i g[b, i] d kappa_i / d cloud, from the mask (row 8);
// the C entry zeroes grad. No register cap for two blocks an SM: at 56
// registers the gradient spilled, and one block an SM without spills
// measured faster.
template <Radius kRadius, bool kStaged>
__global__ void __launch_bounds__(kStreamThreads, 1)
    kappa_bwd_stream_kernel(const float* __restrict__ cloud,
                            const float* __restrict__ normal,
                            const int8_t* __restrict__ mask,
                            const float* __restrict__ g, int n, int k,
                            float* __restrict__ grad, StreamPlan p) {
  extern __shared__ float smem[];
  const size_t row0 = (size_t)blockIdx.y * n;  // the cloud's first row of grad
  stream_rows<kStaged>(
      cloud, normal, g, mask, n, p, smem,
      [&](int i, int t, const RowCtx& c, int cnt, const int* list,
          const Points<kStaged>& pts, const float* gs, int hl, bool valid) {
        const float w = gs[t] / (float)k;
        float cx = 0.0f, cy = 0.0f, cz = 0.0f;
        for (int q = hl; q < cnt; q += 16) {
          const int j = list[q];
          const float4 pj = pts[j];
          const float3 v = pair_grad(c, pair_term<kRadius>(c, pj.x, pj.y, pj.z),
                                     pj.x, pj.y, pj.z, w);
          if (valid) add3(grad, row0 + j, v);
          cx -= v.x;
          cy -= v.y;
          cz -= v.z;
        }
        // row i's own term, one component from each of half-lanes 0, 4, 8
        const float own = half_sum3(cx, cy, cz, hl);
        if ((hl & 3) == 0 && hl < 12 && valid)
          atomicAdd(grad + 3 * (row0 + i) + (hl >> 2), own);
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

int pow2_floor(int x) {
  int p = 1;
  while (2 * p <= x) p *= 2;
  return p;
}

int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

// Rows a stage: whole rows, a power of two, at most kStageTarget bytes.
int stage_rows(int n) { return pow2_floor(max(1, kStageTarget / n)); }

// A stage's bytes: R rows and the 16-byte lines around them.
int stage_bytes(int R, int n) {
  return (int)(((size_t)R * n + 32 + 15) & ~(size_t)15);
}

// Stages in the ring: at least kInFlight bytes, and a row for each consumer
// warp (kMinStages to kMaxStages, a power of two).
int stream_depth(int R, int stage) {
  const int bytes = (kInFlight + stage - 1) / stage;
  const int warps = (kStreamWarps + R - 1) / R;
  return min(kMaxStages, pow2_ceil(max(kMinStages, max(bytes, warps))));
}

// The cloud is staged where it fits beside the full ring and the largest
// share's rows (n <= 6,864); past that its points are read through L2, and
// the ring takes the room.
bool stream_staged(int n) {
  const int R = stage_rows(n), stage = stage_bytes(R, n);
  return stream_smem(n, true, kMaxRows, stream_depth(R, stage), stage) <=
         kSmemLimit;
}

// The stream's plan for b clouds of n points, `resident` blocks an SM as
// registers and threads allow: as many blocks as one wave holds (two an SM
// where a block takes at most half an SM's shared memory), kMinRows to
// kMaxRows rows a block, the ring of stream_depth stages (fewer where they
// do not fit, or where the share has fewer).
StreamPlan stream_plan(int b, int n, bool staged, int sms, int resident) {
  const int R0 = stage_rows(n), st0 = stage_bytes(R0, n);
  const size_t largest =
      stream_smem(n, staged, min(n, kMaxRows), stream_depth(R0, st0), st0);
  const int per_sm = max(1, min(resident, largest <= geoa3::kSmemHalf ? 2 : 1));
  const int per_cloud =
      max(1, max((n + kMaxRows - 1) / kMaxRows,
                 min((n + kMinRows - 1) / kMinRows, per_sm * sms / max(b, 1))));
  StreamPlan p;
  p.S = (n + per_cloud - 1) / per_cloud;
  p.per_cloud = (n + p.S - 1) / p.S;
  p.R = min(R0, pow2_floor(p.S));
  p.stage = stage_bytes(p.R, n);
  p.depth = min(pow2_ceil((p.S + p.R - 1) / p.R), stream_depth(p.R, p.stage));
  while (p.depth > 1 &&
         stream_smem(n, staged, p.S, p.depth, p.stage) > kSmemLimit)
    p.depth /= 2;
  p.smem = stream_smem(n, staged, p.S, p.depth, p.stage);
  return p;
}

// Launch a stream kernel on plan p: grid (blocks a cloud, b).
template <typename Kernel, typename... Args>
int run_stream(Kernel kernel, const StreamPlan& p, int b, cudaStream_t stream,
               Args... args) {
  if (p.smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  dim3 grid(p.per_cloud, b);
  kernel<<<grid, kStreamThreads, p.smem, stream>>>(args..., p);
  return (int)cudaGetLastError();
}

// Launch a stream kernel on its plan for b clouds of n points.
template <typename Kernel, typename... Args>
int launch_stream(Kernel kernel, int b, int n, bool staged, cudaStream_t stream,
                  Args... args) {
  cudaError_t e = set_smem(kernel, kSmemLimit);
  int resident = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                      kStreamThreads, 0);
  if (e != cudaSuccess) return (int)e;
  return run_stream(kernel, stream_plan(b, n, staged, sm_count(), resident), b,
                    stream, args...);
}

template <Radius kRadius>
int launch_bwd(const float* cloud, const float* normal, const int8_t* mask,
               const float* g, int b, int n, int k, float* grad, cudaStream_t s) {
  if (stream_staged(n))
    return launch_stream(kappa_bwd_stream_kernel<kRadius, true>, b, n, true, s,
                         cloud, normal, mask, g, n, k, grad);
  return launch_stream(kappa_bwd_stream_kernel<kRadius, false>, b, n, false, s,
                       cloud, normal, mask, g, n, k, grad);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k > kMaxK) return (int)cudaErrorInvalidValue;
  if (stream_staged(n))
    return launch_stream(kappa_frommask_stream_kernel<true>, b, n, true, s,
                         cloud, normal, mask, n, k, kappa);
  return launch_stream(kappa_frommask_stream_kernel<false>, b, n, false, s,
                       cloud, normal, mask, n, k, kappa);
}

// direct != 0: the gradient of geoa3_kappa_fwd's kappa; else the gradient of
// geoa3_kappa_frommask's. grad is zeroed here, on the stream.
extern "C" int geoa3_kappa_bwd(const float* cloud, const float* normal,
                               const int8_t* mask, const float* g, int b, int n,
                               int k, int direct, float* grad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k > kMaxK) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      cudaMemsetAsync(grad, 0, (size_t)b * n * 3 * sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  if (direct)
    return launch_bwd<Radius::kDirect>(cloud, normal, mask, g, b, n, k, grad, s);
  return launch_bwd<Radius::kExpansion>(cloud, normal, mask, g, b, n, k, grad, s);
}
