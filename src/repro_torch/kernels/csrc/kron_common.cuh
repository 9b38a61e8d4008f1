// Pieces shared by the Kron-row kernels, for sm_90a: operand loads and the
// per-term rounding of the precision axis (kron_scatter.cu, kron_contrib.cu,
// kron_scatter_ttm.cu), and for kron_scatter_ttm.cu the launch shape of the
// slot staging and the segmented walk over a range of schedule slots that
// builds each row of
//     Y_(n)[row(t)] += v[t] * (a[t] (x) b[t])      (Rb fastest, K = Ra*Rb).
//
// The walk. A thread owns one column j of b and four consecutive columns
// i0..i0+3 of a, i.e. four output columns k = i*Rb + j, and walks its CTA's
// slots in order, summing v*a[i]*b[j] in registers. Each chunk of slots is
// staged in shared memory first (a padded to a multiple of four so a thread
// reads its four a values as one float4). When the row grows, the caller's
// row_end(row, acc) receives the finished row's four sums. A range starts
// at a row's first slot, so a row never straddles two walks. Padding slots
// sit at the end of their row group with row offset 0 and value 0: their
// row is never above the current one, so they add an exact 0 to it and
// never end a row.
//
// Precision. Under bf16_fp32acc a and b arrive as bf16; each product a*b
// is rounded to bf16 (the TPU kernels multiply in bf16), then scaled by
// the f32 value and summed in f32. Products and sums use __fmul_rn and
// __fadd_rn so the per-term rounding is that of the plain versions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace kron {

constexpr int kQI = 4;                    // a columns per thread
constexpr int kMaxChunk = 64;             // staged slots per step, at most
constexpr int kStagingLimit = 48 * 1024;  // static launch limit, no opt-in
constexpr int kMaxThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <bool kBf16>
__device__ __forceinline__ float kron_term(float a, float b, float v) {
  float p = __fmul_rn(a, b);
  if (kBf16) p = __bfloat162float(__float2bfloat16_rn(p));
  return __fmul_rn(p, v);
}

inline int pad4(int ra) { return (ra + kQI - 1) / kQI * kQI; }

// Threads (one per item: four a columns and one b column) of the walk.
inline int n_items(int ra, int rb) { return (pad4(ra) / kQI) * rb; }

// Shared memory of `chunk` staged slots: a (padded), b, v and row.
inline size_t staging_bytes(int ra, int rb, int chunk) {
  return (size_t)chunk * (pad4(ra) + rb + 2) * 4;
}

// The walk's launch shape at these ranks: threads per CTA (a multiple of
// 32, at most 256) and staged slots per chunk (as many as the static 48 KB
// hold, at most 64). Returns false when not one slot fits.
inline bool staging_shape(int ra, int rb, int* threads, int* chunk) {
  if (ra < 1 || rb < 1) return false;
  const size_t per_slot = staging_bytes(ra, rb, 1);
  const size_t fit = kStagingLimit / per_slot;
  *chunk = (int)(fit < (size_t)kMaxChunk ? fit : kMaxChunk);
  const int warps = (n_items(ra, rb) + 31) / 32 * 32;
  *threads = warps < kMaxThreads ? warps : kMaxThreads;
  return *chunk >= 1;
}

// Walks slots [t_begin, t_end) as the header describes; `smem` holds
// staging_bytes(ra, rb, chunk). Every thread of the CTA calls it (it
// synchronises the CTA); only `active` threads accumulate and call
// row_end(row, acc) with acc the row's sums for columns i0..i0+3 of a.
template <typename T, bool kBf16, typename RowEnd>
__device__ __forceinline__ void walk_rows(const T* __restrict__ a, const T* __restrict__ b,
                                          const float* __restrict__ v,
                                          const int* __restrict__ rel,
                                          const int* __restrict__ blkmap, long long t_begin,
                                          long long t_end, int ra, int rb, int bn, int bi,
                                          int chunk, unsigned char* smem, bool active, int i0,
                                          int j, RowEnd row_end) {
  const int ra4 = (ra + kQI - 1) / kQI * kQI;
  float* sa = reinterpret_cast<float*>(smem);      // [chunk][ra4]
  float* sb = sa + (size_t)chunk * ra4;            // [chunk][rb]
  float* sv = sb + (size_t)chunk * rb;             // [chunk]
  int* srow = reinterpret_cast<int*>(sv + chunk);  // [chunk]

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
          row_end(cur, acc);
#pragma unroll
          for (int c = 0; c < kQI; ++c) acc[c] = 0.f;
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
  if (active && cur >= 0) row_end(cur, acc);
}

}  // namespace kron
