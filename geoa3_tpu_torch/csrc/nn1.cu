// Dual 1-NN, with or without payload copies, both Chamfer directions, in one
// pass over the distances.
//
// Replaces geoa3_tpu/ops/pallas/nn1_kernel.py:_nn1_payload_kernel and
// :_nn1_dual_kernel (exact selection). For adv [b,n,3] and ori [b,m,3], with
// d_ij = max((|a_i|^2 + |o_j|^2) - 2 a_i.o_j, 0):
//   a2o[b,i]   = argmin_j d_ij   gp[b,p,i] = pay[b,p,a2o[b,i]]   (p < 8)
//   o2a[b,j]   = argmin_i d_ij   op[b,c,j] = adv[b,o2a[b,j],c]   (c < 3; rows 3..7 zero)
// ties to the lowest index in both directions. Every product and sum of d is
// rounded on its own, so d is bitwise the plain version's and so are the
// selected indices.
//
// Bound on the H100: operations (b*n*m distance evaluations, ~10 flops each,
// against a few MB of inputs and outputs). The inner loop is 13 operations a
// pair: 8 float32 operations, the clamp, a compare and two selects for the
// row and one minimum for the column.
//
// One pass. A tile block owns 256 adv rows (8 warps of 32) and a span of ori
// columns, which it stages 128 at a time in shared memory as (x, y, z,
// |o|^2), the next chunk's loads in flight meanwhile. A thread holds 8 rows
// in registers and takes 4 columns of every 32-column step, and computes
// each distance once. d is a non-negative float and never -0 (the clamp
// returns +0), so float order is the order of its bits.
//  - Rows: the thread folds each distance into its rows' running (d, j),
//    visiting columns in ascending index and keeping the first on a strict
//    `<`, the lowest index on ties.
//  - Columns: it keeps only each column's least distance over its 8 rows
//    and stores it in one shared-memory slot per row group. After each
//    chunk, two threads a column find the least value and the lowest row
//    group holding it, then the lowest row of that group at that distance
//    by computing its distances again (the same operations on the same
//    inputs give the same bits). The index costs no select in the loop.
// Across blocks a minimum travels as the 64-bit (distance bits, index) key
// of common.cuh, a total order whose minimum is the lowest-index argmin: one
// global atomicMin per column and block into the o2a keys, and per row and
// block into the a2o keys after warp shuffles. A minimum is commutative and
// associative, so the keys end as the same bits whatever order the blocks
// run in: the fold the TPU kernel made across row blocks in grid order needs
// no order here. Rows and columns past n and m repeat the last point with
// their own (larger) index, so they tie with it at best and lose the tie.
//
// The key buffers (a2o [b,n], then o2a [b,m]) are set to all ones by a
// cudaMemsetAsync in the C entry; the finishing kernel, one thread a row and
// a column, decodes them and writes the payload and coordinate copies. The
// tile kernel is the same for both variants; the finishing kernel compiles
// the copies out for the bare one. The host sizes the span (whole 128-column
// chunks) from the work each SM gets in whole blocks.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;       // warps per tile block
constexpr int kRowGroups = 4;   // lanes along rows in a warp (lane >> 3)
constexpr int kColGroups = 8;   // lanes along columns (lane & 7)
constexpr int kRows = 8;        // adv rows a thread holds
constexpr int kCols = 4;        // ori columns a thread takes per step
constexpr int kStep = kCols * kColGroups;              // 32 columns a step
constexpr int kChunk = 128;                            // columns staged at once
constexpr int kSlots = kWarps * kRowGroups;            // row groups a block
constexpr int kBlockRows = kSlots * kRows;             // 256 adv rows a block
constexpr int kSlotStride = kChunk + 8;  // neighbouring row groups on other banks
constexpr int kThreads = kWarps * 32;
constexpr int kFinishThreads = 256;
constexpr float kChunkFixed = 0.25f;  // a block's own cost, in chunks
// a thread stages one of the block's rows, and two threads reduce a column
static_assert(kThreads == kBlockRows && kThreads == 2 * kChunk, "tile shape");

__device__ __forceinline__ unsigned long long min_u64(unsigned long long a,
                                                      unsigned long long b) {
  return b < a ? b : a;
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return (int)((key - 1ull) & 0xffffffffull);
}

__device__ __forceinline__ void load_point(const float* O, int j, float& x,
                                           float& y, float& z) {
  x = O[(size_t)j * 3];
  y = O[(size_t)j * 3 + 1];
  z = O[(size_t)j * 3 + 2];
}

__global__ void __launch_bounds__(kThreads, 2)
nn1_tile_kernel(const float* __restrict__ adv, const float* __restrict__ ori,
                int n, int m, int span,
                unsigned long long* __restrict__ a2o_key,
                unsigned long long* __restrict__ o2a_key) {
  __shared__ float4 cols[2][kChunk];     // this chunk and the next
  __shared__ float4 rows[kBlockRows];    // the block's rows, for the o2a search
  __shared__ float cmin[kSlots * kSlotStride];  // column minima by row group
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int cg = lane & (kColGroups - 1);
  const int slot = (threadIdx.x >> 5) * kRowGroups + (lane >> 3);
  const int tile0 = blockIdx.x * kBlockRows;
  const int row0 = tile0 + slot * kRows;
  const int j_begin = blockIdx.y * span;
  const int j_end = min(j_begin + span, m);
  const float* A = adv + (size_t)b * n * 3;
  const float* O = ori + (size_t)b * m * 3;
  // threads below kChunk stage one column of each chunk, the next chunk's
  // loads in flight while this one is computed
  const bool stager = threadIdx.x < kChunk;
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (stager) load_point(O, min(j_begin + (int)threadIdx.x, m - 1), px, py, pz);
  {
    float x, y, z;
    load_point(A, min(tile0 + (int)threadIdx.x, n - 1), x, y, z);
    rows[threadIdx.x] = make_float4(x, y, z, geoa3_sq3(x, y, z));
  }

  float ax[kRows], ay[kRows], az[kRows], a2[kRows], rb[kRows];
  int rj[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    load_point(A, min(row0 + r, n - 1), ax[r], ay[r], az[r]);
    a2[r] = geoa3_sq3(ax[r], ay[r], az[r]);
    rb[r] = __int_as_float(0x7f800000);  // +inf: the first column replaces it
    rj[r] = j_begin + cg;                // unless d is +inf there too
  }
  if (stager) {
    cols[0][threadIdx.x] = make_float4(px, py, pz, geoa3_sq3(px, py, pz));
    if (j_begin + kChunk < j_end)
      load_point(O, min(j_begin + kChunk + (int)threadIdx.x, m - 1), px, py, pz);
  }

  int buf = 0;
  for (int c0 = j_begin; c0 < j_end; c0 += kChunk, buf ^= 1) {
    // cols[buf] is staged, and the previous chunk's minima are read
    __syncthreads();
#pragma unroll 1
    for (int s = 0; s < kChunk; s += kStep) {
      float4 p[kCols];
      float cb[kCols];
      int jc[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        p[c] = cols[buf][s + c * kColGroups + cg];
        cb[c] = __int_as_float(0x7f800000);
        jc[c] = c0 + s + c * kColGroups + cg;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float d = geoa3_sqdist(
              a2[r], p[c].w,
              geoa3_dot3(ax[r], ay[r], az[r], p[c].x, p[c].y, p[c].z));
          if (d < rb[r]) {
            rb[r] = d;
            rj[r] = jc[c];
          }
          cb[c] = fminf(cb[c], d);
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        cmin[slot * kSlotStride + s + c * kColGroups + cg] = cb[c];
    }
    // cols[buf ^ 1] was last read before the barrier above
    if (stager && c0 + kChunk < j_end) {
      cols[buf ^ 1][threadIdx.x] = make_float4(px, py, pz, geoa3_sq3(px, py, pz));
      if (c0 + 2 * kChunk < j_end)
        load_point(O, min(c0 + 2 * kChunk + (int)threadIdx.x, m - 1), px, py, pz);
    }
    __syncthreads();
    // Two threads a column, half the row groups each: the least minimum and
    // the lowest row group holding it, then the lowest row of that group at
    // that distance, found by computing its distances again (the same
    // operations give the same bits), and one atomic a column.
    {
      const int c = threadIdx.x >> 1, h = threadIdx.x & 1;
      const int q0 = h * (kSlots / 2);
      float v = cmin[q0 * kSlotStride + c];
      int sl = q0;
#pragma unroll 4
      for (int q = q0 + 1; q < q0 + kSlots / 2; ++q) {
        const float x = cmin[q * kSlotStride + c];
        if (x < v) {
          v = x;
          sl = q;
        }
      }
      const float v2 = __shfl_xor_sync(GEOA3_FULL_MASK, v, 1);
      const int sl2 = __shfl_xor_sync(GEOA3_FULL_MASK, sl, 1);
      if (v2 < v || (v2 == v && sl2 < sl)) {
        v = v2;
        sl = sl2;
      }
      const float4 q = cols[buf][c];
      int hit = kRows;
#pragma unroll
      for (int r = kRows / 2 - 1; r >= 0; --r) {
        const float4 a = rows[sl * kRows + h * (kRows / 2) + r];
        if (geoa3_sqdist(a.w, q.w, geoa3_dot3(a.x, a.y, a.z, q.x, q.y, q.z)) == v)
          hit = h * (kRows / 2) + r;
      }
      hit = min(hit, __shfl_xor_sync(GEOA3_FULL_MASK, hit, 1));
      if (h == 0 && c0 + c < m)
        atomicMin(o2a_key + (size_t)b * m + c0 + c,
                  geoa3_key(v, tile0 + sl * kRows + hit));
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    unsigned long long k = geoa3_key(rb[r], rj[r]);
#pragma unroll
    for (int off = 1; off < kColGroups; off <<= 1)
      k = min_u64(k, __shfl_xor_sync(GEOA3_FULL_MASK, k, off));
    if (cg == 0 && row0 + r < n) atomicMin(a2o_key + (size_t)b * n + row0 + r, k);
  }
}

// keys: a2o [b,n] then o2a [b,m]; thread t < b*n finishes a row, the rest a
// column.
template <bool kPayload>
__global__ void nn1_finish_kernel(const unsigned long long* __restrict__ keys,
                                  const float* __restrict__ adv,
                                  const float* __restrict__ pay, int b, int n,
                                  int m, int* __restrict__ a2o,
                                  int* __restrict__ o2a, float* __restrict__ gp,
                                  float* __restrict__ op) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t rows = (size_t)b * n;
  if (t < rows) {
    const int j = key_index(keys[t]);
    a2o[t] = j;
    if (kPayload) {
      const size_t bi = t / n, i = t % n;
#pragma unroll
      for (int p = 0; p < 8; ++p)
        gp[(bi * 8 + p) * n + i] = pay[(bi * 8 + p) * m + j];
    }
    return;
  }
  const size_t u = t - rows;
  if (u >= (size_t)b * m) return;
  const int i = key_index(keys[t]);
  o2a[u] = i;
  if (kPayload) {
    const size_t bj = u / m, j = u % m;
    float* P = op + bj * 8 * m;
    const float* a = adv + (bj * n + i) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) P[c * m + j] = a[c];
#pragma unroll
    for (int c = 3; c < 8; ++c) P[c * m + j] = 0.0f;
  }
}

// Columns a tile block streams: whole 128-column chunks, as many as leave the
// grid a block an SM or more, chosen by the work the busiest SM gets in whole
// blocks plus a fixed cost a block (the card's SM count is read once).
int span_for(int b, int n, int m) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    sms = v > 0 ? v : 1;
  }
  const long long row_blocks = (long long)b * ((n + kBlockRows - 1) / kBlockRows);
  const int chunks = (m + kChunk - 1) / kChunk;
  int best = 1;
  double best_cost = -1.0;
  for (int cps = 1; cps <= chunks; ++cps) {
    const long long spans = (chunks + cps - 1) / cps;
    if (spans > 65535) continue;
    const long long blocks = row_blocks * spans;
    if (cps > 1 && blocks < sms) break;  // fewer blocks from here on
    const double cost = (double)((blocks + sms - 1) / sms) * (cps + kChunkFixed);
    if (best_cost < 0.0 || cost <= best_cost) {
      best_cost = cost;
      best = cps;
    }
  }
  return best * kChunk;
}

template <bool kPayload>
int launch_nn1(const float* adv, const float* ori, const float* pay, int b,
               int n, int m, unsigned long long* keys, int* a2o, int* o2a,
               float* gp, float* op, cudaStream_t s) {
  if (b <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const size_t nkeys = (size_t)b * ((size_t)n + m);
  cudaError_t e = cudaMemsetAsync(keys, 0xff, nkeys * sizeof(*keys), s);
  if (e != cudaSuccess) return (int)e;
  const int span = span_for(b, n, m);
  dim3 grid((n + kBlockRows - 1) / kBlockRows, (m + span - 1) / span, b);
  nn1_tile_kernel<<<grid, kThreads, 0, s>>>(adv, ori, n, m, span, keys,
                                            keys + (size_t)b * n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t blocks = (nkeys + kFinishThreads - 1) / kFinishThreads;
  nn1_finish_kernel<kPayload><<<(unsigned)blocks, kFinishThreads, 0, s>>>(
      keys, adv, pay, b, n, m, a2o, o2a, gp, op);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int geoa3_nn1_payload(const float* adv, const float* ori,
                                 const float* pay, int b, int n, int m,
                                 unsigned long long* keys, int* a2o, int* o2a,
                                 float* gp, float* op, void* stream) {
  return launch_nn1<true>(adv, ori, pay, b, n, m, keys, a2o, o2a, gp, op,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int geoa3_nn1_dual(const float* adv, const float* ori, int b, int n,
                              int m, unsigned long long* keys, int* a2o,
                              int* o2a, void* stream) {
  return launch_nn1<false>(adv, ori, nullptr, b, n, m, keys, a2o, o2a, nullptr,
                           nullptr, static_cast<cudaStream_t>(stream));
}
