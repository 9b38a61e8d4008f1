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
//   * a thread owns one column j of b and four consecutive columns i of a,
//     i.e. four output columns k = i*Rb + j, and walks the CTA's slots in
//     order, summing v*a[i]*b[j] in registers; when the row grows it stores
//     the finished row with plain stores (the CTA is the row's only
//     writer). K is tiled over blockIdx.y when it exceeds one CTA;
//   * each chunk of slots is staged in shared memory first (a padded to a
//     multiple of four so a thread reads its four a values as one float4);
//   * padding slots sit at the end of their group with row offset 0 and
//     value 0; their row is never above the current one, so they add an
//     exact 0 and trigger no store. Rows no slot reaches stay as the
//     wrapper's zero fill.
// Under bf16_fp32acc a and b arrive as bf16; each product a*b is rounded to
// bf16 (the TPU kernel multiplies in bf16), then scaled by the f32 value
// and summed in f32. Products and sums use __fmul_rn/__fadd_rn so the
// per-term rounding is that of the plain version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kQI = 4;  // a columns per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <bool kBf16>
__device__ __forceinline__ float kron_term(float a, float b, float v) {
  float p = __fmul_rn(a, b);
  if (kBf16) p = __bfloat162float(__float2bfloat16_rn(p));
  return __fmul_rn(p, v);
}

template <typename T, bool kBf16>
__global__ void kron_scatter_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                    const float* __restrict__ v, const int* __restrict__ rel,
                                    const int* __restrict__ blkmap,
                                    const long long* __restrict__ parts,
                                    float* __restrict__ out, int ra, int rb, int bn, int bi,
                                    int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ra4 = (ra + kQI - 1) / kQI * kQI;
  float* sa = reinterpret_cast<float*>(smem_raw);  // [chunk][ra4]
  float* sb = sa + (size_t)chunk * ra4;            // [chunk][rb]
  float* sv = sb + (size_t)chunk * rb;             // [chunk]
  int* srow = reinterpret_cast<int*>(sv + chunk);  // [chunk]

  const long long t_begin = parts[blockIdx.x];
  const long long t_end = parts[blockIdx.x + 1];
  const long long k_cols = (long long)ra * rb;
  const int n_items = (ra4 / kQI) * rb;
  const int item = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = item < n_items;
  const int j = active ? item % rb : 0;
  const int i0 = active ? (item / rb) * kQI : 0;

  float acc[kQI] = {0.f, 0.f, 0.f, 0.f};
  int cur = -1;
  for (long long t0 = t_begin; t0 < t_end; t0 += chunk) {
    const int n = (int)min((long long)chunk, t_end - t0);
    for (int e = threadIdx.x; e < n * ra4; e += blockDim.x) {
      const int s = e / ra4, i = e - s * ra4;
      sa[e] = i < ra ? to_f32(a[(t0 + s) * ra + i]) : 0.f;
    }
    for (int e = threadIdx.x; e < n * rb; e += blockDim.x) sb[e] = to_f32(b[t0 * rb + e]);
    for (int s = threadIdx.x; s < n; s += blockDim.x) {
      const long long t = t0 + s;
      sv[s] = v[t];
      srow[s] = blkmap[t / bn] * bi + rel[t];
    }
    __syncthreads();
    if (active) {
      if (cur < 0) cur = srow[0];  // a range starts at a row's first slot
      for (int s = 0; s < n; ++s) {
        const int row = srow[s];
        if (row > cur) {
          float* o = out + (long long)cur * k_cols + j;
#pragma unroll
          for (int c = 0; c < kQI; ++c) {
            if (i0 + c < ra) o[(long long)(i0 + c) * rb] = acc[c];
            acc[c] = 0.f;
          }
          cur = row;
        }
        const float bj = sb[s * rb + j];
        const float vs = sv[s];
        const float4 a4 = *reinterpret_cast<const float4*>(&sa[s * ra4 + i0]);
        acc[0] = __fadd_rn(acc[0], kron_term<kBf16>(a4.x, bj, vs));
        acc[1] = __fadd_rn(acc[1], kron_term<kBf16>(a4.y, bj, vs));
        acc[2] = __fadd_rn(acc[2], kron_term<kBf16>(a4.z, bj, vs));
        acc[3] = __fadd_rn(acc[3], kron_term<kBf16>(a4.w, bj, vs));
      }
    }
    __syncthreads();
  }
  if (active && cur >= 0) {
    float* o = out + (long long)cur * k_cols + j;
#pragma unroll
    for (int c = 0; c < kQI; ++c)
      if (i0 + c < ra) o[(long long)(i0 + c) * rb] = acc[c];
  }
}

}  // namespace

// Y (n_rows, ra*rb) f32, zero-filled by the caller; a (nnzp, ra) and
// b (nnzp, rb) contiguous f32 (bf16 = 0) or bf16 (bf16 = 1); v (nnzp,) f32;
// rel (nnzp,) and blkmap (nnzp/bn,) int32; parts (n_parts + 1,) int64 slot
// boundaries, each range starting at a row's first slot. threads is a
// multiple of 32, at most 1024; chunk slots of shared memory per CTA.
// Returns cudaGetLastError() after the launch.
extern "C" int kron_scatter_launch(const void* a, const void* b, const void* v,
                                   const void* rel, const void* blkmap, const void* parts,
                                   void* out, int n_parts, int ra, int rb, int bn, int bi,
                                   int bf16, int threads, int chunk, void* stream) {
  if (n_parts < 1 || ra < 1 || rb < 1 || bn < 1 || bi < 1 || threads < 32 ||
      threads > 1024 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const int ra4 = (ra + kQI - 1) / kQI * kQI;
  const int n_items = (ra4 / kQI) * rb;
  const dim3 grid(n_parts, (n_items + threads - 1) / threads);
  const size_t smem = (size_t)chunk * (ra4 + rb + 2) * 4;
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
