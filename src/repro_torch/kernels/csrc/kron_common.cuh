// Pieces of the Kron-row kernel kron_contrib.cu, for sm_90a: operand loads
// and the per-term rounding of the precision axis.
//
// Precision. Under bf16_fp32acc a and b arrive as bf16; each product a*b is
// rounded to bf16 (the TPU kernels multiply in bf16), then scaled by the
// f32 value and summed in f32. Products and sums use __fmul_rn and
// __fadd_rn so the per-term rounding is that of the plain versions. (The
// walk kernels, kernels 1 and 5 and the chain kernel, run their bf16 routes
// on the tensor cores and give that rounding up: kron_walk.cuh,
// kron_chain_scatter.cu.)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace kron {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <bool kBf16>
__device__ __forceinline__ float kron_term(float a, float b, float v) {
  float p = __fmul_rn(a, b);
  if (kBf16) p = __bfloat162float(__float2bfloat16_rn(p));
  return __fmul_rn(p, v);
}

}  // namespace kron
