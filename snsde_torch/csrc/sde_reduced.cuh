// What the reduced-precision kernels of the SRK and CDE pairs
// (fused_srk_red.cu, fused_cde_red.cu) share, on the operand modes of
// operand_modes.cuh (MM_*, parts, fma3, ld_stream, st_stream) and
// sde_hopper.cuh's one_hot: a block of RT threads runs the whole
// time loop for R batch rows of one member (blockIdx.x the rows,
// blockIdx.y the member), with every tile in shared memory and the weights
// read from device memory; the products are one output a thread, each an
// FMA chain in ascending k (three FMAs a term in a reduced mode). A simple
// design, not yet made fast: the main paths' fp32 instances stay in their
// own sources, which hold none of this code.
//
// Everything here has internal linkage: each source that includes it
// builds into its own library.

#pragma once

#include "sde_hopper.cuh"

namespace {

constexpr int RT = 256;     // threads a block
constexpr int RED_ROWS = 8;  // the most batch rows a block

// out[r * ldo + n] = sum_k X[r * ldx + k] W(k, n) for r < nr, n < N, in
// operand mode `mode`: W(k, n) = W[k N + n] (a [Kd][N] weight), or with wt
// W[n Kd + k] (the transpose of a [N][Kd] weight); W in device memory. X
// in shared memory. No barrier.
__device__ __noinline__ void red_prod(const float* X, int ldx, int Kd,
                                      const float* __restrict__ W, bool wt,
                                      int nr, int N, float* out, int ldo,
                                      int mode) {
  const bool x3 = mode == MM_X3;
  for (int i = threadIdx.x; i < nr * N; i += RT) {
    const int r = i / N, n = i - r * N;
    const float* x = X + r * ldx;
    const float* w = wt ? W + (size_t)n * Kd : W + n;
    const size_t sk = wt ? 1 : (size_t)N;
    float acc = 0.f;
    if (mode == MM_F32) {
      for (int k = 0; k < Kd; ++k) acc = fmaf(x[k], __ldg(w + k * sk), acc);
    } else {
      for (int k = 0; k < Kd; ++k)
        acc = fma3(parts(x[k], x3), parts(__ldg(w + k * sk), x3), acc);
    }
    out[r * ldo + n] = acc;
  }
}

// The block's sum of one value a thread, in a fixed order (red: RT floats
// of shared memory); every thread gets it
__device__ __forceinline__ float red_block_sum(float v, float* red) {
  __syncthreads();
  red[threadIdx.x] = v;
  __syncthreads();
  float s = 0.f;
  for (int k = 0; k < RT; ++k) s += red[k];
  __syncthreads();
  return s;
}

// rows a block of a launch whose block takes `bytes(R)` of shared memory:
// the most, a power of 2 up to RED_ROWS, that fit the device, else 0 (a
// function of the shapes alone: a packed member's blocks are its solo
// launch's)
template <class Bytes>
inline int red_rows(Bytes bytes) {
  const long long limit = max_optin_smem();
  for (int R = RED_ROWS; R >= 1; R >>= 1)
    if (bytes(R) <= limit) return R;
  return 0;
}

// Launch kernel k on blocks x members blocks of RT threads with `bytes` of
// dynamic shared memory; the launch's error
template <class... Exp, class... Act>
int red_launch(void (*k)(Exp...), int blocks, int members, long long bytes,
               cudaStream_t s, Act... args) {
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  k<<<dim3((unsigned)blocks, (unsigned)members), RT, (size_t)bytes, s>>>(
      args...);
  return (int)cudaGetLastError();
}

}  // namespace
