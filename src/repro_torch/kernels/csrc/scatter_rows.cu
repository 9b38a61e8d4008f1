// Row scatter-accumulation of schedule-ordered Kron rows, for sm_90a.
//
// Replaces: src/repro/kernels/kron_kernel.py :: scatter_rows_pallas
// (_scatter_kernel via _scatter_call), the TPU kernel that sums the rows of
// contrib (nnzp, K), already in the schedule's slot order with padding rows
// zeroed, into their rows of Y_(n) (n_rows, K) through a one-hot MXU matmul
// per nnz block, then zeroes the row blocks no nnz block reaches.
//
// What bounds it on this card: bytes. Every contrib element is read once
// and added once: at K = 4,096 (a 4-way sweep at ranks 16) that is 16 KB
// read per nonzero for 4 K adds.
//
// Design. The one-hot matmul is a TPU workaround for a scatter; here it is
// the deterministic segmented sum of csrc/kron_scatter.cu without the Kron
// product:
//   * blockIdx.x takes one row-aligned slot range of
//     sparse/layout.py::row_parts, so a row never crosses two CTAs and no
//     atomics are needed; the result does not depend on the split;
//   * blockIdx.y takes a tile of 4 * blockDim.x columns, so a tensor with
//     few, long rows (17 rows of ~182 K slots in the last mode of NIPS)
//     still spreads over K / 256 times as many CTAs;
//   * a thread owns four consecutive columns, walks the range's slots in
//     order with float4 loads (a warp reads 512 contiguous bytes of one
//     contrib row), sums in registers while the row stays the same and
//     stores the finished row once. kU slots are loaded before any is
//     summed, to keep that many loads in flight per thread;
//   * a slot's row is blkmap[t / bn] * bi + rel[t]; the block index is
//     carried from slot to slot instead of divided out each time;
//   * padding slots sit at the end of their group with row offset 0 and a
//     zero contrib row: their row is never above the current one, so they
//     add an exact 0 and trigger no store. Rows no slot reaches stay as the
//     wrapper's zero fill, which is the reference's row mask.
//   * float64 (E = double): the same walk over f64 rows summed in f64, a
//     thread's four columns read as two 16-byte loads.
#include <cuda_runtime.h>

namespace {

constexpr int kU = 8;  // slots loaded ahead per thread

__device__ __forceinline__ void ld4(const float* p, float (&x)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void ld4(const double* p, double (&x)[4]) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
}
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename E, bool kVec>
__global__ void scatter_rows_kernel(const E* __restrict__ contrib, const int* __restrict__ rel,
                                    const int* __restrict__ blkmap,
                                    const long long* __restrict__ parts, E* __restrict__ out,
                                    int k_cols, int bn, int bi) {
  const long long t_begin = parts[blockIdx.x];
  const long long t_end = parts[blockIdx.x + 1];
  const int col = (blockIdx.y * blockDim.x + threadIdx.x) * 4;
  if (col >= k_cols || t_begin >= t_end) return;
  const int nc = min(4, k_cols - col);

  long long blk = t_begin / bn;
  long long next = (blk + 1) * bn;
  int base = blkmap[blk] * bi;
  E acc[4] = {E(0), E(0), E(0), E(0)};
  int cur = base + rel[t_begin];  // a range starts at a row's first slot
  for (long long t0 = t_begin; t0 < t_end; t0 += kU) {
    E x[kU][4];
    int row[kU];
#pragma unroll
    for (int q = 0; q < kU; ++q) {
      const long long t = t0 + q;
      row[q] = -1;
      if (t < t_end) {
        if (t == next) {
          ++blk;
          next += bn;
          base = blkmap[blk] * bi;
        }
        row[q] = base + rel[t];
        const E* src = contrib + t * k_cols + col;
        if (kVec) {
          ld4(src, x[q]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) x[q][c] = c < nc ? src[c] : E(0);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kU; ++q) {
      if (row[q] < 0) continue;
      if (row[q] > cur) {
        E* o = out + (long long)cur * k_cols + col;
        for (int c = 0; c < nc; ++c) o[c] = acc[c];
        acc[0] = acc[1] = acc[2] = acc[3] = E(0);
        cur = row[q];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = add_rn(acc[c], x[q][c]);
    }
  }
  E* o = out + (long long)cur * k_cols + col;
  for (int c = 0; c < nc; ++c) o[c] = acc[c];
}

}  // namespace

// out (n_rows, k_cols), zero-filled by the caller; contrib (nnzp, k_cols)
// contiguous in slot order, padding rows zero, both f32 (f64 = 0) or f64
// (f64 = 1); rel (nnzp,) and
// blkmap (nnzp/bn,) int32; parts (n_parts + 1,) int64 slot boundaries, each
// range starting at a row's first slot. vec = 1 when k_cols is a multiple of
// four and contrib is 16-byte aligned. threads is a multiple of 32, at most
// 1024. Returns cudaGetLastError() after the launch.
extern "C" int scatter_rows_launch(const void* contrib, const void* rel, const void* blkmap,
                                   const void* parts, void* out, int n_parts, int k_cols, int bn,
                                   int bi, int vec, int threads, int f64, void* stream) {
  if (n_parts < 1 || k_cols < 1 || bn < 1 || bi < 1 || threads < 32 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  const int groups = (k_cols + 3) / 4;
  const dim3 grid(n_parts, (groups + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rel);
  const int* m = static_cast<const int*>(blkmap);
  const long long* p = static_cast<const long long*>(parts);
  if (f64) {
    const double* c = static_cast<const double*>(contrib);
    double* o = static_cast<double*>(out);
    if (vec)
      scatter_rows_kernel<double, true><<<grid, threads, 0, st>>>(c, r, m, p, o, k_cols, bn, bi);
    else
      scatter_rows_kernel<double, false><<<grid, threads, 0, st>>>(c, r, m, p, o, k_cols, bn, bi);
  } else {
    const float* c = static_cast<const float*>(contrib);
    float* o = static_cast<float*>(out);
    if (vec)
      scatter_rows_kernel<float, true><<<grid, threads, 0, st>>>(c, r, m, p, o, k_cols, bn, bi);
    else
      scatter_rows_kernel<float, false><<<grid, threads, 0, st>>>(c, r, m, p, o, k_cols, bn, bi);
  }
  return (int)cudaGetLastError();
}
