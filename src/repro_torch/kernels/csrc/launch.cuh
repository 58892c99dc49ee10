// Launch helpers shared by the kernel sources of this directory.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

// The dynamic shared memory a kernel may use without opting in (less the
// static reduction scratch the kernels declare).
constexpr size_t kDefaultSmem = 48 * 1024 - 2 * 32 * sizeof(float);

// The most dynamic shared memory a kernel may opt in to on the current
// card (one card per process), less the static reduction scratch.
inline cudaError_t smem_limit(size_t* limit) {
  static int max_smem = -1;
  if (max_smem < 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
  }
  *limit = static_cast<size_t>(max_smem) - 2 * 32 * sizeof(float);
  return cudaSuccess;
}

// Raises a kernel's dynamic shared-memory limit to `smem` when it is
// above `*allowed`, the limit already set for it; refuses what the card
// cannot give.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, size_t* allowed) {
  if (smem <= *allowed) return cudaSuccess;
  size_t limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  if (smem > limit) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  *allowed = smem;
  return cudaSuccess;
}

}  // namespace repro_torch
