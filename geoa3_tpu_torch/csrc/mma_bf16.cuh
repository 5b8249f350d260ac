// The tensor-core, conversion and asynchronous-copy instructions of the
// port's bf16 kernels (csrc/pool_matmul_bf16.cu, csrc/group_mlp_bf16.cu), in
// one place. The CPU emulation of a source (tests/cuda_emu/cuda_runtime.h,
// which defines GEOA3_EMU) supplies ldmatrix, mma.sync and the bf16
// conversions with the PTX ISA's fragment layouts, and cp.async as a
// synchronous copy.
#pragma once

#include "common.cuh"

#include <string.h>

#ifndef GEOA3_EMU
// 16 bytes, or 16 zero bytes where src_bytes is 0
__device__ __forceinline__ void cp_async16z(void* smem, const void* gmem,
                                            int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// bf16(lo) in the low half, bf16(hi) in the high half, round to nearest even
__device__ __forceinline__ uint32_t cvt_rn_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulators
__device__ __forceinline__ void mma_m16n8k16_bf16(float (&d)[4],
                                                  const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
#else
__device__ __forceinline__ void cp_async16z(void* smem, const void* gmem,
                                            int src_bytes) {
  if (src_bytes)
    cp_async16(smem, gmem);
  else
    memset(smem, 0, 16);
}
#endif

__device__ __forceinline__ float bf16_to_float(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __uint_as_float(cvt_rn_bf16x2(v, 0.0f) << 16);
}

