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
// R = 64, 32 or 16 rows through all three layers in float32 (fmaf, k
// ascending, so the forward and the backward's recompute give bitwise the
// same activations): activations sit transposed in shared memory
// ([channel][row], so a thread reads its 4 rows as one float4), weights
// stream from L2 as float4 rows, every thread holds a 4x4 output tile, and
// layer 3 is produced 64 columns at a time and pooled before anything is
// written (the tile, the pooling epilogue and the backward's chain to dz1
// live in group_mlp.cuh, which sa_fused.cu shares). 16-row tiles are taken
// only where 32 do not fit a block's shared memory: the backward of a
// 640-feature GroupAll with widths 256/512/1024 needs 159,040 bytes at 16
// rows and 286,272 at 32. A block owns
// whole groups (or one group larger than its tile, walked tile by tile with
// the running maximum kept in the output), so no atomics are needed and the
// forward also leaves each (group, channel)'s tie count for the backward.
//
// Bound on the H100: operations (2 * rows * (c0*c1 + c1*c2 + c2*c3) for the
// forward, twice that for the backward: the recompute and one dz @ w^T
// product a layer, no weight gradients; against inputs and outputs of a few
// hundred MB at most).
#include "group_mlp.cuh"

namespace {

using geoa3::BwdLayout;
using geoa3::Tile;

struct Dims {
  long long rows;  // groups * ns
  int ns, cf, c0, c0p, c1, c2, c3;
};

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
  constexpr int LD = Tile<R>::LD;
  extern __shared__ __align__(16) float smem[];
  const int wa = d.c0 > d.c2 ? d.c0 : d.c2;
  float* bufA = smem;
  float* bufB = bufA + (size_t)wa * LD;
  float* chunk = bufB + (size_t)d.c1 * LD;

  const long long row_begin = (long long)blockIdx.x * rows_per_block;
  long long row_end = row_begin + rows_per_block;
  if (row_end > d.rows) row_end = d.rows;
  for (long long row0 = row_begin; row0 < row_end; row0 += R) {
    const int nrows = (int)(row_end - row0 < R ? row_end - row0 : R);
    geoa3::load_input<R>(bufA, gx, gf, row0, nrows, d.cf);
    __syncthreads();
    geoa3::dense_relu<R>(bufA, d.c0, w1, d.c1, b1, bufB);
    __syncthreads();
    geoa3::dense_relu<R>(bufB, d.c1, w2, d.c2, b2, bufA);
    __syncthreads();
    geoa3::layer3_pool<R>(bufA, d.c2, w3, b3, d.c3, chunk, row0, nrows, d.ns,
                          pooled, cnt);
  }
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
  extern __shared__ __align__(16) float smem[];
  float* a0T = smem + l.a0;
  float* a1T = smem + l.a1;
  float* a2T = smem + l.a2;
  float* d1T = smem + l.d1;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  const long long row0 = (long long)blockIdx.x * R;
  const int nrows = (int)(d.rows - row0 < R ? d.rows - row0 : R);
  geoa3::load_input<R>(a0T, gx, gf, row0, nrows, d.cf);
  __syncthreads();
  geoa3::dense_relu<R>(a0T, d.c0, w1, d.c1, b1, a1T);
  __syncthreads();
  geoa3::dense_relu<R>(a1T, d.c1, w2, d.c2, b2, a2T);
  __syncthreads();
  geoa3::backward_to_dz1<R>(a1T, a2T, smem + l.d2, smem + l.ch, d1T, w2t, w3,
                            b3, w3t, d.c1, d.c2, d.c3, pooled, cnt, gout, row0,
                            nrows, d.ns);
  // da0 = dz1 @ w1t: columns 0..2 are gx's cotangent, the rest gf's
  float acc[4][4];
  for (int jx = tx * 4; jx < d.c0p; jx += 64) {
    geoa3::gemm_tile<R>(d1T, d.c1, w1t, d.c0p, jx, acc);
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
  const BwdLayout l = geoa3::bwd_layout<R>(d.c0p, d.c1, d.c2);
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

size_t bwd_smem(int R, const Dims& d) {
  const BwdLayout l = R == 64   ? geoa3::bwd_layout<64>(d.c0p, d.c1, d.c2)
                      : R == 32 ? geoa3::bwd_layout<32>(d.c0p, d.c1, d.c2)
                                : geoa3::bwd_layout<16>(d.c0p, d.c1, d.c2);
  return (size_t)l.total * sizeof(float);
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
  switch (geoa3::pick_rows(fwd_smem<64>(d), fwd_smem<32>(d),
                           fwd_smem<16>(d))) {
    case 64:
      return launch_fwd<64>(gx, gf, w1, b1, w2, b2, w3, b3, d, pooled, cnt, s);
    case 32:
      return launch_fwd<32>(gx, gf, w1, b1, w2, b2, w3, b3, d, pooled, cnt, s);
    case 16:
      return launch_fwd<16>(gx, gf, w1, b1, w2, b2, w3, b3, d, pooled, cnt, s);
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
  switch (geoa3::pick_rows(bwd_smem(64, d), bwd_smem(32, d), bwd_smem(16, d))) {
    case 64:
      return launch_bwd<64>(gx, gf, w1, b1, w2, b2, w3, b3, w1t, w2t, w3t,
                            pooled, cnt, gout, d, dgx, dgf, s);
    case 32:
      return launch_bwd<32>(gx, gf, w1, b1, w2, b2, w3, b3, w1t, w2t, w3t,
                            pooled, cnt, gout, d, dgx, dgf, s);
    case 16:
      return launch_bwd<16>(gx, gf, w1, b1, w2, b2, w3, b3, w1t, w2t, w3t,
                            pooled, cnt, gout, d, dgx, dgf, s);
  }
  return (int)cudaErrorInvalidConfiguration;
}
