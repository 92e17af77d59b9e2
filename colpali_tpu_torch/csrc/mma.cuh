// Warp-level helpers that the kernels share (hopper.cuh includes them): bf16
// packing, quad reductions and the strides of a (B, S, H, D) tensor.
//
// Fragment layout of mma.sync m16n8k16, which wgmma's accumulators follow per
// 8 columns (hopper.cuh), with g = lane / 4 and tg = lane % 4:
//   A (16 x 16, row): a0 = (g, 2tg..2tg+1), a1 = (g+8, same), a2 = (g, 2tg+8..), a3 = (g+8, 2tg+8..)
//   C (16 x 8):       c0, c1 = (g, 2tg..2tg+1), c2, c3 = (g+8, same)
// so the C fragments of two neighbouring n-tiles are the A fragment of a
// following product over those 16 columns.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

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
