// The reduced precisions' device helpers that every kernel source shares
// (sde_hopper.cuh and the SDE sources on it, fused_rnn.cu): the operand
// modes of the in-kernel products, the split of an operand into bf16
// parts, and the bf16 streams' loads and stores.
//
// Everything here has internal linkage: each source that includes it
// builds into its own library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// The operand modes of the in-kernel products (the JAX package's
// SNSDE_FUSED_MATMUL, snsde/kernels/fused_em.py:_dot): exact fp32; bf16x3,
// each operand split into hi = bf16(v) and lo = bf16(v - hi), the product
// xh wh + xh wl + xl wh; bf16, one pass over operands rounded to bf16. All
// accumulate in fp32. A product of two bf16 values is exact in fp32, so an
// fp32 FMA chain over the rounded or split operands computes what a bf16
// mma with fp32 accumulation computes, up to the order of the sums.
enum { MM_F32 = 0, MM_X3 = 1, MM_BF16 = 2 };

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// an operand's parts in a reduced mode: hi, and lo (0 unless bf16x3)
struct Parts {
  float h, l;
};

__device__ __forceinline__ Parts parts(float v, bool x3) {
  const float h = bf16r(v);
  return Parts{h, x3 ? bf16r(v - h) : 0.f};
}

// acc + a b in a reduced mode: ah bh, then ah bl, then al bh (the bf16
// mode's two lo terms add exact zeros)
__device__ __forceinline__ float fma3(Parts a, Parts b, float acc) {
  acc = fmaf(a.h, b.h, acc);
  acc = fmaf(a.h, b.l, acc);
  return fmaf(a.l, b.h, acc);
}

// entry i of a stream in device memory: bf16 (bs) or fp32, widened
__device__ __forceinline__ float ld_stream(const void* p, size_t i,
                                           bool bs) {
  return bs ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
            : reinterpret_cast<const float*>(p)[i];
}

// entry i of a stream written in bf16 (bs, rounded to nearest) or fp32
__device__ __forceinline__ void st_stream(void* p, size_t i, float v,
                                          bool bs) {
  if (bs)
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    reinterpret_cast<float*>(p)[i] = v;
}

}  // namespace
