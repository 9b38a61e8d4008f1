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
// float64: f64 operands, values and output (O = double), each term
// round(round(a*b)*v) in f64; a thread's four columns go out as two 16-byte
// stores.
#include "kron_common.cuh"

namespace {

using kron::kron_term;
using kron::to_f32;

constexpr int kThreads = 256;

template <bool kBf16, typename T>
__device__ __forceinline__ float term(T a, T b, float v) {
  return kron_term<kBf16>(to_f32(a), to_f32(b), v);
}
template <bool kBf16>
__device__ __forceinline__ double term(double a, double b, double v) {
  return __dmul_rn(__dmul_rn(a, b), v);
}
__device__ __forceinline__ void store4(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store4(double* p, const double (&o)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(o[0], o[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(o[2], o[3]);
}

template <typename T, typename O, bool kBf16>
__global__ void __launch_bounds__(kThreads)
    kron_contrib_kernel(const T* __restrict__ a, const T* __restrict__ b,
                        const O* __restrict__ v, O* __restrict__ out, long long nnz,
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
    const O vt = v[t];
    O o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = term<kBf16>(at[ia[c]], bt[jb[c]], vt);
    O* dst = out + t * k_cols + k0;
    if (vec) {
      store4(dst, o);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (k0 + c < k_cols) dst[c] = o[c];
    }
  }
}

}  // namespace

// out (nnz, ra*rb) contiguous = v[t] * (a[t] (x) b[t]); a (nnz, ra) and
// b (nnz, rb) contiguous f32 (kind = 0), bf16 (kind = 1) or f64 (kind = 2);
// v (nnz,) and out f64 for kind = 2, else f32. out must be 16-byte aligned.
// n_ctas bounds the grid-stride loop's CTAs per column tile. Returns
// cudaGetLastError() after the launch.
extern "C" int kron_contrib_launch(const void* a, const void* b, const void* v, void* out,
                                   long long nnz, int ra, int rb, int kind, int n_ctas,
                                   void* stream) {
  if (kind < 0 || kind > 2 || nnz < 1 || ra < 1 || rb < 1 || n_ctas < 1 ||
      (long long)ra * rb > (1 << 30))
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
  if (kind == 1) {
    kron_contrib_kernel<__nv_bfloat16, float, true><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), vf, o, nnz,
        ra, rb, groups, rows_per_cta);
  } else if (kind == 2) {
    kron_contrib_kernel<double, double, false><<<grid, kThreads, 0, st>>>(
        static_cast<const double*>(a), static_cast<const double*>(b),
        static_cast<const double*>(v), static_cast<double*>(out), nnz, ra, rb, groups,
        rows_per_cta);
  } else {
    kron_contrib_kernel<float, float, false><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), vf, o, nnz, ra, rb, groups,
        rows_per_cta);
  }
  return (int)cudaGetLastError();
}
