// Tensor-core pieces shared by the kernels that run on mma.sync, for sm_90a
// (kron_walk.cuh, kron_scatter_ttm.cu, ttm.cu, kron_chain_scatter.cu, and
// through ssd_common.cuh ssd_chunk.cu and ssd_chunk_bwd.cu): the 3xTF32
// operand split, the m16n8k8 TF32 product, the m16n8k8 f64 product (DMMA),
// and for bf16 operands the hi + lo bf16 split, the m16n8k16 bf16 product
// and ldmatrix.
//
// 3xTF32. An f32 operand x is split into hi, x rounded to TF32, and lo, the
// exact rest; a product a*b is taken as al*bh + ah*bl + ah*bh (al*bl, about
// 2^-22 of it, is dropped), each on the tensor cores, which carries the
// product to about 2^-21 of itself. A single TF32 pass (ah*bh alone) keeps
// about 2^-11.
#pragma once

#include <cuda_bf16.h>

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

// d += a b, m16n8k16, bf16 operands, f32 accumulator: each product of two
// bf16 values is exact in f32. Lane (g, t) holds a (g, 2t..2t+1), (g+8,
// 2t..2t+1), (g, 2t+8..2t+9), (g+8, 2t+8..2t+9) and b (2t..2t+1, g), (2t+8..
// 2t+9, g), two bf16 a register, the lower k in the low half; d as mma_tf32's.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// (x0, x1) = hi + lo as two bf16 pairs (x0 in the low halves): hi the pair
// rounded to bf16, lo the exact rest rounded to bf16, so hi + lo carries
// each value to 2^-16 of itself
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(x0, __low2float(h)), __fsub_rn(x1, __high2float(h)));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The two bf16 of a register as f32 (exact): the low half, then the high.
__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// Four 8 x 8 b16 matrices from shared memory, transposed: lane l gives the
// 16-byte row address of row l % 8 of matrix l / 8, and r[j] holds matrix
// j's rows 2t and 2t + 1 at column g (the lower row in the low half), the
// fragment of mma_bf16's a or b register whose k are the stored rows.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

}  // namespace tc
