// Warp-level bf16 helpers: mma.sync m16n8k16 with fp32 accumulators and its
// fragment loads (the bf16 MaxSim kernels), and the bf16 packing, quad
// reductions and strides that the attention kernels share (hopper.cuh).
//
// Fragment layout of m16n8k16, with g = lane / 4 and tg = lane % 4:
//   A (16 x 16, row): a0 = (g, 2tg..2tg+1), a1 = (g+8, same), a2 = (g, 2tg+8..), a3 = (g+8, 2tg+8..)
//   B (16 x 8, col):  b0 = (k = 2tg..2tg+1, n = g), b1 = (k = 2tg+8.., n = g)
//   C (16 x 8):       c0, c1 = (g, 2tg..2tg+1), c2, c3 = (g+8, same)
// so the C fragments of two neighbouring n-tiles are the A fragment of a
// following product over those 16 columns.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Element strides of the batch, sequence and head axes of a (B, S, H, D)
// tensor whose head dim is contiguous.
struct Strides {
  int64_t b, s, h;
};
