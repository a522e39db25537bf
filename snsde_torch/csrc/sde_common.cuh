// What the first-generation solver kernels (fused_cde.cu, fused_rnn.cu)
// share: the block size, the odd row stride that keeps a row walk and a
// column walk of a shared-memory tile free of bank conflicts, the sigmoid,
// and the device's shared-memory limit. The SDE pairs run on sde_hopper.cuh.
//
// Everything here has internal linkage: each source that includes it
// builds into its own library.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;  // threads per block

__host__ __device__ inline int odd(int n) { return n | 1; }

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// The most dynamic shared memory one block may opt in to on this device.
inline int max_optin_smem() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return v;
}

}  // namespace
