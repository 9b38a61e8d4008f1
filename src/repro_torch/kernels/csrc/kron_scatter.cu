// Fused Kron-scatter unfolding of one HOOI mode, for sm_90a.
//
// Replaces: src/repro/kernels/kron_kernel.py :: fused_kron_scatter_pallas
// (_fused_kernel via _fused_call), the TPU kernel that computes
//     Y_(n)[row(t)] += v[t] * (a[t] (x) b[t])      (Rb fastest, K = Ra*Rb)
// over the schedule-ordered nonzeros of sparse/layout.py.
//
// What bounds it on this card: bytes. Each nonzero slot brings
// (Ra + Rb) operand values, its value and its row (about 136 B at
// Ra = Rb = 16 in f32) and does 3*K = 768 flops of CUDA-core f32 work, so at
// 3.35 TB/s against 67 TFLOP/s the reads of a and b set the floor.
//
// Design. The TPU kernel's one-hot MXU matmul and its grid that revisits a
// resident output block in order are TPU workarounds; here the schedule's
// rows are already sorted within each row-block group, so the unfolding is
// a deterministic segmented sum with no atomics:
//   * the wrapper cuts the slots into row-aligned ranges of about equal
//     size (sparse/layout.py::row_parts), one per CTA (blockIdx.x), so a
//     row never crosses two CTAs and the 132 SMs are balanced however the
//     nonzeros spread over the BI = 128 row groups;
//   * the CTA walks its range with kron_common.cuh's walk_rows (a thread
//     sums four output columns of the current row in registers); when the
//     row ends it stores the finished row with plain stores (the CTA is
//     the row's only writer). K is tiled over blockIdx.y when it exceeds
//     one CTA;
//   * rows no slot reaches stay as the wrapper's zero fill.
// Precision as in kron_common.cuh.
#include "kron_common.cuh"

namespace {

using kron::kQI;

template <typename T, bool kBf16>
__global__ void kron_scatter_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                    const float* __restrict__ v, const int* __restrict__ rel,
                                    const int* __restrict__ blkmap,
                                    const long long* __restrict__ parts,
                                    float* __restrict__ out, int ra, int rb, int bn, int bi,
                                    int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ra4 = (ra + kQI - 1) / kQI * kQI;
  const long long k_cols = (long long)ra * rb;
  const int n_items = (ra4 / kQI) * rb;
  const int item = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = item < n_items;
  const int j = active ? item % rb : 0;
  const int i0 = active ? (item / rb) * kQI : 0;
  kron::walk_rows<T, kBf16>(
      a, b, v, rel, blkmap, parts[blockIdx.x], parts[blockIdx.x + 1], ra, rb, bn, bi, chunk,
      smem_raw, active, i0, j, [&](int row, const float* acc) {
        float* o = out + (long long)row * k_cols + j;
#pragma unroll
        for (int c = 0; c < kQI; ++c)
          if (i0 + c < ra) o[(long long)(i0 + c) * rb] = acc[c];
      });
}

}  // namespace

// Y (n_rows, ra*rb) f32, zero-filled by the caller; a (nnzp, ra) and
// b (nnzp, rb) contiguous f32 (bf16 = 0) or bf16 (bf16 = 1); v (nnzp,) f32;
// rel (nnzp,) and blkmap (nnzp/bn,) int32; parts (n_parts + 1,) int64 slot
// boundaries, each range starting at a row's first slot. The CTA shape is
// kron::staging_shape's. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue when the ranks do not fit the staging.
extern "C" int kron_scatter_launch(const void* a, const void* b, const void* v,
                                   const void* rel, const void* blkmap, const void* parts,
                                   void* out, int n_parts, int ra, int rb, int bn, int bi,
                                   int bf16, void* stream) {
  int threads, chunk;
  if (n_parts < 1 || bn < 1 || bi < 1 || !kron::staging_shape(ra, rb, &threads, &chunk))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_parts, (kron::n_items(ra, rb) + threads - 1) / threads);
  const size_t smem = kron::staging_bytes(ra, rb, chunk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* vf = static_cast<const float*>(v);
  const int* relp = static_cast<const int*>(rel);
  const int* blk = static_cast<const int*>(blkmap);
  const long long* pp = static_cast<const long long*>(parts);
  float* o = static_cast<float*>(out);
  if (bf16) {
    kron_scatter_kernel<__nv_bfloat16, true><<<grid, threads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), vf, relp,
        blk, pp, o, ra, rb, bn, bi, chunk);
  } else {
    kron_scatter_kernel<float, false><<<grid, threads, smem, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), vf, relp, blk, pp, o, ra,
        rb, bn, bi, chunk);
  }
  return (int)cudaGetLastError();
}
