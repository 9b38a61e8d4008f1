// Per-nonzero Kronecker rows, for sm_90a.
//
// Replaces: src/repro/kernels/kron_kernel.py :: kron_contrib_pallas
// (_kron_kernel), the TPU kernel that computes
//     contrib[t] = v[t] * (a[t] (x) b[t])      (Rb fastest, K = Ra*Rb)
// for every nonzero t; order >= 4 tensors chain it (kernels/ops.py), each
// link widening the row by one more factor.
//
// What bounds it on this card: bytes, and almost all of them written. At
// Ra*Rb = 256*16 (the second link of a 4-way sweep at ranks 16) a nonzero
// reads 1.1 KB of operands and writes 16 KB of output for 8 K flops, three
// orders of magnitude below the f32 ridge point.
//
// Design. A pure write-bound outer product: each thread owns four
// consecutive output columns k..k+3 of one row and stores them as one
// float4, so a warp writes 512 contiguous bytes. The column decomposition
// (i, j) = (k / Rb, k % Rb) of a thread's four columns is fixed for the
// whole launch, so it is computed once and the thread then walks rows in a
// grid-stride loop; its a, b and v loads repeat across the warp's lanes and
// hit L1. A CTA covers 256 / (K / 4) rows at once when a row has fewer than
// 256 float4s, and K is tiled over blockIdx.y when it has more. Rows whose
// width is not a multiple of four fall back to scalar stores.
// Precision as in kron_common.cuh: under bf16_fp32acc each a*b is rounded
// to bf16 and then scaled by the f32 value in f32, as the plain version does.
#include "kron_common.cuh"

namespace {

using kron::kron_term;
using kron::to_f32;

constexpr int kThreads = 256;

template <typename T, bool kBf16>
__global__ void __launch_bounds__(kThreads)
    kron_contrib_kernel(const T* __restrict__ a, const T* __restrict__ b,
                        const float* __restrict__ v, float* __restrict__ out, long long nnz,
                        int ra, int rb, int groups, int rows_per_cta) {
  const int k_cols = ra * rb;
  const int g_local = rows_per_cta > 1 ? threadIdx.x % groups : threadIdx.x;
  const int r_off = rows_per_cta > 1 ? threadIdx.x / groups : 0;
  const int g = blockIdx.y * kThreads + g_local;
  if (r_off >= rows_per_cta || g >= groups) return;
  const int k0 = g * 4;
  int ia[4], jb[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int k = min(k0 + c, k_cols - 1);  // columns past K are never stored
    ia[c] = k / rb;
    jb[c] = k - ia[c] * rb;
  }
  const bool vec = (k_cols & 3) == 0;
  const long long stride = (long long)gridDim.x * rows_per_cta;
  for (long long t = (long long)blockIdx.x * rows_per_cta + r_off; t < nnz; t += stride) {
    const T* at = a + t * ra;
    const T* bt = b + t * rb;
    const float vt = v[t];
    float o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = kron_term<kBf16>(to_f32(at[ia[c]]), to_f32(bt[jb[c]]), vt);
    float* dst = out + t * k_cols + k0;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (k0 + c < k_cols) dst[c] = o[c];
    }
  }
}

}  // namespace

// out (nnz, ra*rb) f32 contiguous = v[t] * (a[t] (x) b[t]); a (nnz, ra) and
// b (nnz, rb) contiguous f32 (bf16 = 0) or bf16 (bf16 = 1), v (nnz,) f32.
// out must be 16-byte aligned. n_ctas bounds the grid-stride loop's CTAs
// per column tile. Returns cudaGetLastError() after the launch.
extern "C" int kron_contrib_launch(const void* a, const void* b, const void* v, void* out,
                                   long long nnz, int ra, int rb, int bf16, int n_ctas,
                                   void* stream) {
  if (nnz < 1 || ra < 1 || rb < 1 || n_ctas < 1 || (long long)ra * rb > (1 << 30))
    return (int)cudaErrorInvalidValue;
  const int k_cols = ra * rb;
  const int groups = (k_cols + 3) / 4;
  const int rows_per_cta = groups >= kThreads ? 1 : kThreads / groups;
  const long long row_tiles = (nnz + rows_per_cta - 1) / rows_per_cta;
  const dim3 grid((unsigned)(row_tiles < n_ctas ? row_tiles : n_ctas),
                  (groups + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* vf = static_cast<const float*>(v);
  float* o = static_cast<float*>(out);
  if (bf16) {
    kron_contrib_kernel<__nv_bfloat16, true><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), vf, o, nnz,
        ra, rb, groups, rows_per_cta);
  } else {
    kron_contrib_kernel<float, false><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), vf, o, nnz, ra, rb, groups,
        rows_per_cta);
  }
  return (int)cudaGetLastError();
}
