// Pieces shared by the SSD chunk kernels, forward (ssd_chunk.cu) and
// backward (ssd_chunk_bwd.cu), for sm_90a: the staged B and C tiles' row
// stride, a cp.async (or ordinary-load) tile stager, and the m16n8k16 bf16
// and 3xTF32 products on mma.sync.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "tc_common.cuh"

namespace {

__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

// row stride (elements) of the staged B and C tiles: N rounded up to 16,
// plus 16 bytes
template <typename T>
__host__ __device__ inline int bc_stride(int n) {
  return round16(n) + 16 / (int)sizeof(T);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// dst[r * ld + c] = src[r * src_ld + c] for r < rows_in and c < cols_in,
// else 0, over r < rows and c < width. With vec, whole 16-byte pieces by
// cp.async (a piece outside rows_in or cols_in is zero-filled: cols_in and
// width are multiples of the piece there); without, ordinary loads. All
// kThreads threads of the CTA take part.
template <int kThreads, typename T>
__device__ __forceinline__ void stage_tile(T* dst, int ld, const T* src, long long src_ld,
                                           int rows_in, int cols_in, int rows, int width,
                                           bool vec) {
  if (vec) {
    constexpr int kPiece = 16 / sizeof(T);
    const int pieces = width / kPiece;
    // e / pieces as (e * inv) >> 20: exact for e < 2048 and pieces < 512
    const unsigned inv = (1u << 20) / pieces + 1;
    for (int e = threadIdx.x; e < rows * pieces; e += kThreads) {
      const int r = (int)(((unsigned)e * inv) >> 20), c = (e - r * pieces) * kPiece;
      const bool in = r < rows_in && c < cols_in;
      cp_async16(dst + r * ld + c, in ? src + r * src_ld + c : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < rows * width; e += kThreads) {
      const int r = e / width, c = e - r * width;
      dst[r * ld + c] = r < rows_in && c < cols_in ? src[r * src_ld + c] : T(0.f);
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a b, m16n8k16, bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += a b in 3xTF32, a and b split: the two small products first
__device__ __forceinline__ void mma_3xtf32(float* acc, const uint32_t* ah, const uint32_t* al,
                                           const uint32_t* bh, const uint32_t* bl) {
  tc::mma_tf32(acc, al, bh);
  tc::mma_tf32(acc, ah, bl);
  tc::mma_tf32(acc, ah, bh);
}

}  // namespace
