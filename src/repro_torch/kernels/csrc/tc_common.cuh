// Tensor-core pieces shared by the kernels that run on mma.sync, for sm_90a
// (kron_walk.cuh, kron_scatter_ttm.cu, ttm.cu, and through ssd_common.cuh
// ssd_chunk.cu and ssd_chunk_bwd.cu): the 3xTF32 operand split, the m16n8k8
// TF32 product, and the m16n8k8 f64 product (DMMA).
//
// 3xTF32. An f32 operand x is split into hi, x rounded to TF32, and lo, the
// exact rest; a product a*b is taken as al*bh + ah*bl + ah*bh (al*bl, about
// 2^-22 of it, is dropped), each on the tensor cores, which carries the
// product to about 2^-21 of itself. A single TF32 pass (ah*bh alone) keeps
// about 2^-11.
#pragma once

#include <cstdint>

namespace tc {

// x = hi + lo: hi is x rounded to TF32 (half away from zero, by integer
// ops), lo the exact rest (|lo| <= 2^-12 |x|), of which the tensor core
// reads the top 11 bits, so hi + lo carries x to 2^-22 |x|
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b, m16n8k8, TF32 operands, f32 accumulator (fragments as in the
// PTX ISA: lane (g, t) = (lane / 4, lane % 4) holds a (g, t), (g+8, t),
// (g, t+4), (g+8, t+4); b (t, g), (t+4, g); d (g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1))
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b, m16n8k8 on the f64 tensor cores (DMMA, sm_90): f64 operands
// and accumulator, each lane holding one double where mma_tf32 holds one
// word, in the same fragment positions. (sm_80's DMMA shape m8n8k4 takes
// the same fragments as four products, rows g and g + 8 by k = t and t + 4;
// on an H100 kernel 1 ran 5-8% slower on it, PERF.md.)
__device__ __forceinline__ void mma_f64(double* d, const double* a, const double* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

}  // namespace tc
