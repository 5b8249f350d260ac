// Three folded-BatchNorm affine+ReLU layers over grouped rows, then the
// maximum over each group's ns rows; and the backward with respect to the
// grouped inputs.
//
// Replaces geoa3_tpu/ops/pallas/group_mlp_kernel.py:_fwd_kernel and
// :_bwd_kernel (group_mlp_maxpool). Rows are the flattened [groups * ns]
// grouped points: gx [rows, 3] (centred coordinates), gf [rows, cf]
// (features, cf >= 0). Layer 1 is gx @ w1[:3] + gf @ w1[3:] + b1 (the two
// parts meet in shared memory, never in device memory), then two more
// affine+ReLU layers, then pooled[g, c] = max over the group's rows.
// The backward recomputes a tile's activations, gives each pooled cotangent
// to the rows that attain the maximum, split evenly among ties (ties are
// routine: an under-full ball repeats its first hit, and repeated rows have
// identical activations), takes ReLU'(0) = 0 at every layer, and returns
// the cotangents of gx and gf only (the victim is frozen).
//
// The TPU kernel keeps thousands of rows in VMEM and splits every float32
// product into three bf16 passes for the MXU. Here a block takes a tile of
// R = 64 or 32 rows through all three layers in float32 (fmaf, k ascending,
// so the forward and the backward's recompute give bitwise the same
// activations): activations sit transposed in shared memory ([channel][row],
// so a thread reads its 4 rows as one float4), weights stream from L2 as
// float4 rows, every thread holds a 4x4 output tile, and layer 3 is produced
// 64 columns at a time and pooled before anything is written. A block owns
// whole groups (or one group larger than its tile, walked tile by tile with
// the running maximum kept in the output), so no atomics are needed and the
// forward also leaves each (group, channel)'s tie count for the backward.
//
// Bound on the H100: operations (2 * rows * (c0*c1 + c1*c2 + c2*c3) for the
// forward, twice that for the backward: the recompute and one dz @ w^T
// product a layer, no weight gradients; against inputs and outputs of a few
// hundred MB at most).
#include "common.cuh"

namespace {

struct Dims {
  long long rows;  // groups * ns
  int ns, cf, c0, c0p, c1, c2, c3;
};

template <int R>
struct Tile {
  static constexpr int kThreads = R * 4;  // 16 column quads x R/4 row quads
  static constexpr int LD = R + 4;        // floats per channel row
  static constexpr int LDC = 65;          // floats per row of a layer-3 chunk
};

// acc[i][j] = sum_k inT[k][ty*4 + i] * W[k][j0 + j], k ascending.
template <int R>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ inT, int K,
                                          const float* __restrict__ W, int ldw,
                                          int j0, float (&acc)[4][4]) {
  constexpr int LD = Tile<R>::LD;
  const float* a = inT + (threadIdx.x >> 4) * 4;
  const float* w = W + j0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + (size_t)k * LD);
    const float4 wv =
        __ldg(reinterpret_cast<const float4*>(w + (size_t)k * ldw));
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], wr[j], acc[i][j]);
  }
}

// Stage rows [row0, row0 + nrows) as a0T[channel][row]; rows past nrows are 0.
template <int R>
__device__ void load_input(float* a0T, const float* __restrict__ gx,
                           const float* __restrict__ gf, long long row0,
                           int nrows, int cf) {
  constexpr int LD = Tile<R>::LD, T = Tile<R>::kThreads;
  const float* px = gx + row0 * 3;
  for (int e = threadIdx.x; e < R * 3; e += T) {
    const int r = e / 3, k = e - r * 3;
    a0T[k * LD + r] = r < nrows ? px[e] : 0.0f;
  }
  if (cf > 0) {
    const float* pf = gf + row0 * cf;
    for (int e = threadIdx.x; e < R * cf; e += T) {
      const int r = e / cf, k = e - r * cf;
      a0T[(3 + k) * LD + r] = r < nrows ? pf[e] : 0.0f;
    }
  }
}

// outT[c][row] = relu(sum_k inT[k][row] W[k][c] + bias[c]) for c < cout.
template <int R>
__device__ void dense_relu(const float* inT, int K, const float* W, int cout,
                           const float* __restrict__ bias, float* outT) {
  constexpr int LD = Tile<R>::LD;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[4][4];
  for (int j0 = tx * 4; j0 < cout; j0 += 64) {
    gemm_tile<R>(inT, K, W, cout, j0, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float bj = bias[j0 + j];
      float4 v;
      v.x = fmaxf(acc[0][j] + bj, 0.0f);
      v.y = fmaxf(acc[1][j] + bj, 0.0f);
      v.z = fmaxf(acc[2][j] + bj, 0.0f);
      v.w = fmaxf(acc[3][j] + bj, 0.0f);
      *reinterpret_cast<float4*>(outT + (size_t)(j0 + j) * LD + ty * 4) = v;
    }
  }
}

// Shared-memory floats of the forward: bufA (the input, later layer 2's
// output), bufB (layer 1's output), one layer-3 chunk.
template <int R>
size_t fwd_smem(const Dims& d) {
  const int wa = d.c0 > d.c2 ? d.c0 : d.c2;
  return ((size_t)(wa + d.c1) * Tile<R>::LD + (size_t)R * Tile<R>::LDC) *
         sizeof(float);
}

template <int R>
__global__ void __launch_bounds__(Tile<R>::kThreads)
    group_mlp_fwd_kernel(const float* __restrict__ gx,
                         const float* __restrict__ gf, const float* w1,
                         const float* b1, const float* w2, const float* b2,
                         const float* w3, const float* b3, Dims d,
                         int rows_per_block, float* pooled, int* cnt) {
  constexpr int LD = Tile<R>::LD, LDC = Tile<R>::LDC;
  extern __shared__ __align__(16) float smem[];
  const int wa = d.c0 > d.c2 ? d.c0 : d.c2;
  float* bufA = smem;
  float* bufB = bufA + (size_t)wa * LD;
  float* chunk = bufB + (size_t)d.c1 * LD;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  const long long row_begin = (long long)blockIdx.x * rows_per_block;
  long long row_end = row_begin + rows_per_block;
  if (row_end > d.rows) row_end = d.rows;
  for (long long row0 = row_begin; row0 < row_end; row0 += R) {
    const int nrows = (int)(row_end - row0 < R ? row_end - row0 : R);
    load_input<R>(bufA, gx, gf, row0, nrows, d.cf);
    __syncthreads();
    dense_relu<R>(bufA, d.c0, w1, d.c1, b1, bufB);
    __syncthreads();
    dense_relu<R>(bufB, d.c1, w2, d.c2, b2, bufA);
    __syncthreads();
    for (int jc = 0; jc < d.c3; jc += 64) {
      const int j0 = jc + tx * 4;
      if (j0 < d.c3) {
        float acc[4][4];
        gemm_tile<R>(bufA, d.c2, w3, d.c3, j0, acc);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float bj = b3[j0 + j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            chunk[(ty * 4 + i) * LDC + tx * 4 + j] =
                fmaxf(acc[i][j] + bj, 0.0f);
        }
      }
      __syncthreads();
      // one thread per column walks the tile's rows in order, keeping each
      // group's running (maximum, tie count); a group that began in an
      // earlier tile of this block resumes from what that tile left
      const int col = jc + (int)threadIdx.x;
      if (threadIdx.x < 64 && col < d.c3) {
        long long g_prev = -1;
        float mx = -1.0f;
        int ties = 0;
        for (int r = 0; r < nrows; ++r) {
          const long long row = row0 + r;
          const long long g = row / d.ns;
          if (g != g_prev) {
            if (g_prev >= 0) {
              pooled[g_prev * d.c3 + col] = mx;
              cnt[g_prev * d.c3 + col] = ties;
            }
            if (row - g * d.ns == 0) {
              mx = -1.0f;  // below every post-ReLU value
              ties = 0;
            } else {
              mx = pooled[g * d.c3 + col];
              ties = cnt[g * d.c3 + col];
            }
            g_prev = g;
          }
          const float v = chunk[r * LDC + threadIdx.x];
          if (v > mx) {
            mx = v;
            ties = 1;
          } else if (v == mx) {
            ++ties;
          }
        }
        if (g_prev >= 0) {
          pooled[g_prev * d.c3 + col] = mx;
          cnt[g_prev * d.c3 + col] = ties;
        }
      }
      __syncthreads();
    }
  }
}

// Shared-memory layout of the backward, in floats from the start.
struct BwdLayout {
  int a0, a1, a2, d2, ch, d1, total;
};

template <int R>
BwdLayout bwd_layout(const Dims& d) {
  constexpr int LD = Tile<R>::LD;
  BwdLayout l;
  l.a0 = 0;
  l.a1 = l.a0 + d.c0p * LD;
  l.a2 = l.a1 + d.c1 * LD;
  l.d2 = l.a2 + d.c2 * LD;
  l.ch = l.d2 + d.c2 * LD;
  l.total = l.ch + 64 * LD;
  if (d.c1 <= d.c2) {
    l.d1 = l.a2;  // layer 2's activations are dead once dz2 is masked
  } else {
    l.d1 = l.total;
    l.total += d.c1 * LD;
  }
  return l;
}

template <int R>
__global__ void __launch_bounds__(Tile<R>::kThreads)
    group_mlp_bwd_kernel(const float* __restrict__ gx,
                         const float* __restrict__ gf, const float* w1,
                         const float* b1, const float* w2, const float* b2,
                         const float* w3, const float* b3, const float* w1t,
                         const float* w2t, const float* w3t,
                         const float* __restrict__ pooled,
                         const int* __restrict__ cnt,
                         const float* __restrict__ gout, Dims d, BwdLayout l,
                         float* __restrict__ dgx, float* __restrict__ dgf) {
  constexpr int LD = Tile<R>::LD, T = Tile<R>::kThreads;
  extern __shared__ __align__(16) float smem[];
  float* a0T = smem + l.a0;
  float* a1T = smem + l.a1;
  float* a2T = smem + l.a2;
  float* d2T = smem + l.d2;
  float* chT = smem + l.ch;
  float* d1T = smem + l.d1;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  const long long row0 = (long long)blockIdx.x * R;
  const int nrows = (int)(d.rows - row0 < R ? d.rows - row0 : R);
  load_input<R>(a0T, gx, gf, row0, nrows, d.cf);
  for (int e = threadIdx.x; e < d.c2 * LD; e += T) d2T[e] = 0.0f;
  __syncthreads();
  dense_relu<R>(a0T, d.c0, w1, d.c1, b1, a1T);
  __syncthreads();
  dense_relu<R>(a1T, d.c1, w2, d.c2, b2, a2T);
  __syncthreads();

  long long grp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    grp[i] = r < nrows ? (row0 + r) / d.ns : -1;
  }
  float acc[4][4];
  for (int jc = 0; jc < d.c3; jc += 64) {
    // dz3 of this chunk of layer-3 columns, transposed into chT
    const int j0 = jc + tx * 4;
    float dz[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dz[i][j] = 0.0f;
    if (j0 < d.c3) {
      gemm_tile<R>(a2T, d.c2, w3, d.c3, j0, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (grp[i] < 0) continue;
        const size_t o = (size_t)grp[i] * d.c3 + j0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float a3 = fmaxf(acc[i][j] + b3[j0 + j], 0.0f);
          if (a3 > 0.0f && a3 == pooled[o + j])
            dz[i][j] = gout[o + j] / (float)cnt[o + j];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(chT + (size_t)(tx * 4 + j) * LD + ty * 4) =
          make_float4(dz[0][j], dz[1][j], dz[2][j], dz[3][j]);
    __syncthreads();
    // da2 += dz3[:, chunk] @ w3t[chunk, :]
    const int kk = d.c3 - jc < 64 ? d.c3 - jc : 64;
    for (int j2 = tx * 4; j2 < d.c2; j2 += 64) {
      gemm_tile<R>(chT, kk, w3t + (size_t)jc * d.c2, d.c2, j2, acc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float4* p =
            reinterpret_cast<float4*>(d2T + (size_t)(j2 + j) * LD + ty * 4);
        float4 v = *p;
        v.x += acc[0][j];
        v.y += acc[1][j];
        v.z += acc[2][j];
        v.w += acc[3][j];
        *p = v;
      }
    }
    __syncthreads();
  }
  // dz2 = da2 where layer 2 was active
  for (int e = threadIdx.x; e < d.c2 * LD; e += T)
    d2T[e] = a2T[e] > 0.0f ? d2T[e] : 0.0f;
  __syncthreads();
  // dz1 = (dz2 @ w2t) where layer 1 was active
  for (int j1 = tx * 4; j1 < d.c1; j1 += 64) {
    gemm_tile<R>(d2T, d.c2, w2t, d.c1, j1, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t o = (size_t)(j1 + j) * LD + ty * 4;
      const float4 a = *reinterpret_cast<const float4*>(a1T + o);
      *reinterpret_cast<float4*>(d1T + o) = make_float4(
          a.x > 0.0f ? acc[0][j] : 0.0f, a.y > 0.0f ? acc[1][j] : 0.0f,
          a.z > 0.0f ? acc[2][j] : 0.0f, a.w > 0.0f ? acc[3][j] : 0.0f);
    }
  }
  __syncthreads();
  // da0 = dz1 @ w1t: columns 0..2 are gx's cotangent, the rest gf's
  for (int jx = tx * 4; jx < d.c0p; jx += 64) {
    gemm_tile<R>(d1T, d.c1, w1t, d.c0p, jx, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      if (r >= nrows) continue;
      const long long row = row0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = jx + j;
        if (c < 3)
          dgx[row * 3 + c] = acc[i][j];
        else if (c < d.c0)
          dgf[row * d.cf + (c - 3)] = acc[i][j];
      }
    }
  }
}

constexpr size_t kSmemMax = 232448;   // what one block may use on Hopper
constexpr size_t kSmemHalf = 113 * 1024;  // two blocks on an SM

bool dims_ok(const Dims& d) {
  return d.ns > 0 && d.cf >= 0 && d.c1 > 0 && d.c2 > 0 && d.c3 > 0 &&
         d.c1 % 4 == 0 && d.c2 % 4 == 0 && d.c3 % 4 == 0;
}

Dims make_dims(int groups, int ns, int cf, int c1, int c2, int c3) {
  Dims d;
  d.rows = (long long)groups * ns;
  d.ns = ns;
  d.cf = cf;
  d.c0 = 3 + cf;
  d.c0p = (d.c0 + 3) / 4 * 4;
  d.c1 = c1;
  d.c2 = c2;
  d.c3 = c3;
  return d;
}

// The tile height: the largest of 64 and 32 whose shared memory leaves room
// for two blocks on an SM, else the largest that fits at all, else 0.
int pick_rows(size_t smem64, size_t smem32) {
  if (smem64 <= kSmemHalf) return 64;
  if (smem32 <= kSmemHalf) return 32;
  if (smem64 <= kSmemMax) return 64;
  if (smem32 <= kSmemMax) return 32;
  return 0;
}

template <int R>
int launch_fwd(const float* gx, const float* gf, const float* w1,
               const float* b1, const float* w2, const float* b2,
               const float* w3, const float* b3, const Dims& d, float* pooled,
               int* cnt, cudaStream_t s) {
  const size_t smem = fwd_smem<R>(d);
  cudaError_t e = cudaFuncSetAttribute(
      group_mlp_fwd_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  // a block owns whole groups: as many as fit its tile, or one larger group
  const int rows_per_block = d.ns <= R ? (R / d.ns) * d.ns : d.ns;
  const long long blocks = (d.rows + rows_per_block - 1) / rows_per_block;
  group_mlp_fwd_kernel<R><<<(unsigned)blocks, Tile<R>::kThreads, smem, s>>>(
      gx, gf, w1, b1, w2, b2, w3, b3, d, rows_per_block, pooled, cnt);
  return (int)cudaGetLastError();
}

template <int R>
int launch_bwd(const float* gx, const float* gf, const float* w1,
               const float* b1, const float* w2, const float* b2,
               const float* w3, const float* b3, const float* w1t,
               const float* w2t, const float* w3t, const float* pooled,
               const int* cnt, const float* gout, const Dims& d, float* dgx,
               float* dgf, cudaStream_t s) {
  const BwdLayout l = bwd_layout<R>(d);
  const size_t smem = (size_t)l.total * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      group_mlp_bwd_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (d.rows + R - 1) / R;
  group_mlp_bwd_kernel<R><<<(unsigned)blocks, Tile<R>::kThreads, smem, s>>>(
      gx, gf, w1, b1, w2, b2, w3, b3, w1t, w2t, w3t, pooled, cnt, gout, d, l,
      dgx, dgf);
  return (int)cudaGetLastError();
}

}  // namespace

// gx [groups*ns, 3], gf [groups*ns, cf] (null when cf == 0); w1 [3+cf, c1],
// w2 [c1, c2], w3 [c2, c3] row-major with their biases; pooled [groups, c3],
// cnt [groups, c3] (each maximum's number of ties). Widths must be multiples
// of 4 and every pointer 16-byte aligned.
extern "C" int geoa3_group_mlp_fwd(const float* gx, const float* gf,
                                   const float* w1, const float* b1,
                                   const float* w2, const float* b2,
                                   const float* w3, const float* b3, int groups,
                                   int ns, int cf, int c1, int c2, int c3,
                                   float* pooled, int* cnt, void* stream) {
  const Dims d = make_dims(groups, ns, cf, c1, c2, c3);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  if (d.rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pick_rows(fwd_smem<64>(d), fwd_smem<32>(d))) {
    case 64:
      return launch_fwd<64>(gx, gf, w1, b1, w2, b2, w3, b3, d, pooled, cnt, s);
    case 32:
      return launch_fwd<32>(gx, gf, w1, b1, w2, b2, w3, b3, d, pooled, cnt, s);
  }
  return (int)cudaErrorInvalidConfiguration;
}

// w1t [c1, c0p] (w1 transposed, its 3+cf columns zero-padded to a multiple
// of 4), w2t [c2, c1], w3t [c3, c2]; pooled and cnt from the forward; gout
// [groups, c3]; dgx [groups*ns, 3], dgf [groups*ns, cf] (null when cf == 0).
extern "C" int geoa3_group_mlp_bwd(const float* gx, const float* gf,
                                   const float* w1, const float* b1,
                                   const float* w2, const float* b2,
                                   const float* w3, const float* b3,
                                   const float* w1t, const float* w2t,
                                   const float* w3t, const float* pooled,
                                   const int* cnt, const float* gout,
                                   int groups, int ns, int cf, int c1, int c2,
                                   int c3, float* dgx, float* dgf,
                                   void* stream) {
  const Dims d = make_dims(groups, ns, cf, c1, c2, c3);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  if (d.rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t s64 = (size_t)bwd_layout<64>(d).total * sizeof(float);
  const size_t s32 = (size_t)bwd_layout<32>(d).total * sizeof(float);
  switch (pick_rows(s64, s32)) {
    case 64:
      return launch_bwd<64>(gx, gf, w1, b1, w2, b2, w3, b3, w1t, w2t, w3t,
                            pooled, cnt, gout, d, dgx, dgf, s);
    case 32:
      return launch_bwd<32>(gx, gf, w1, b1, w2, b2, w3, b3, w1t, w2t, w3t,
                            pooled, cnt, gout, d, dgx, dgf, s);
  }
  return (int)cudaErrorInvalidConfiguration;
}
