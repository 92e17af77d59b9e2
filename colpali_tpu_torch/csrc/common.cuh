// Shared helpers for the port's kernels: a plain C interface loaded with
// ctypes, so every entry point returns the launch's cudaError_t as an int.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define DOC_TILE 128  // docs per tile: the tile-major layout's lane axis

// Kernels above 48 KB of dynamic shared memory must opt in first.
template <typename Kernel>
static inline cudaError_t colpali_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
