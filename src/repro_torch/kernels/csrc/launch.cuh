// Launch helpers shared by the kernel sources of this directory.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

// The dynamic shared memory a kernel may use without opting in (less the
// static reduction scratch the kernels declare).
constexpr size_t kDefaultSmem = 48 * 1024 - 2 * 32 * sizeof(float);

// Raises a kernel's dynamic shared-memory limit to `smem` when it is
// above `*allowed`, the limit already set for it (one card per process);
// refuses what the card cannot give.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, size_t* allowed) {
  if (smem <= *allowed) return cudaSuccess;
  static int max_smem = -1;
  cudaError_t err;
  if (max_smem < 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
  }
  if (smem + 2 * 32 * sizeof(float) > static_cast<size_t>(max_smem))
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  *allowed = smem;
  return cudaSuccess;
}

}  // namespace repro_torch
