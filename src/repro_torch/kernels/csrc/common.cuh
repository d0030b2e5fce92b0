// Device helpers shared by the port's kernels.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

constexpr unsigned kFullMask = 0xffffffffu;

// silu(x) = x * sigmoid(x), in full float32 (expf, not the __expf
// approximation: the parity tolerance is 2e-5).
__device__ __forceinline__ float silu(float x) {
  return x / (1.0f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

constexpr int kMaxDevices = 64;

// Opt a kernel into more than 48 KB of dynamic shared memory when it
// needs it; returns the CUDA error of the attribute call. `opted` keeps,
// per device, the size already granted, so steady-state launches (and
// launches captured into a CUDA graph) make no attribute call.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel k, size_t bytes,
                              size_t (&opted)[kMaxDevices]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && opted[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kMaxDevices) opted[dev] = bytes;
  return err;
}

}  // namespace repro_torch
