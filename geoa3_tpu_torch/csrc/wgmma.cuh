// Hopper's warpgroup matrix multiply (wgmma) with A from registers and B
// from shared memory, and the register and barrier controls of a
// warp-specialised kernel (csrc/pool_matmul_bf16.cu). The CPU emulation of a
// source (tests/cuda_emu/cuda_runtime.h, which defines GEOA3_EMU) supplies
// the same names: its wgmma reads A and B and writes D when the group
// retires (wgmma_wait), by the PTX ISA's fragment and canonical layouts.
#pragma once

#include "common.cuh"

// A shared-memory matrix descriptor for the no-swizzle canonical layout
// (core matrices of 8 rows x 16 bytes, each 128 contiguous bytes): start
// address, leading byte offset `lbo` and stride byte offset `sbo`. For a
// K-major B (cute's make_gmma_desc<Major::K>, LayoutType::INTERLEAVE:
// ((8,n),(T,2)):((1T,SBO),(1,LBO))), sbo steps 8 columns of N and lbo the
// 8-deep halves of k.
__device__ __forceinline__ uint64_t gmma_desc(unsigned addr, unsigned lbo,
                                              unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

#ifndef GEOA3_EMU
// the accumulators and A fragments written by other instructions made
// visible to the next wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of a register operand of
// an asynchronous wgmma across this point (or from reusing its register)
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// a barrier among `count` threads (whole warps) of the block
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// d (64 x 64, float32) = a (64 x 16 bf16, registers: each warp of the
// warpgroup holds rows 16 w .. 16 w + 15 as mma.sync's A fragment) * B (16 x
// 64 bf16, K-major in shared memory at desc), plus d where scale_d != 0.
// d's layout, a warp and an n8 chunk j at a time, is mma.sync's D:
// d[4 j + 2 h + e] = D[16 w + g + 8 h][8 j + 2 q + e] with g = lane / 4,
// q = lane % 4.
__device__ __forceinline__ void wgmma_m64n64k16_bf16(float (&d)[32],
                                                     const uint32_t (&a)[4],
                                                     uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

#endif
