// Split-K core TTM, G = Y U^T, for sm_90a.
//
// Replaces: src/repro/kernels/ttm_kernel.py :: ttm_pallas (_ttm_kernel), the
// TPU kernel that computes G = Y @ U^T for y (L, I) and u (R, I) with an f32
// accumulator, tiled BL x BK over the contraction.
//
// What bounds it on this card: bytes. On the HOOI path L = prod R_t = 256,
// R = 16 and I = I_N is up to ~29 K: one pass over a 29.5 MB unfolding for
// 2*L*R*I = 0.24 GFLOP, about 9 us of reads against 4 us of f32 math.
//
// Design. The product is skinny (4,096 outputs) with a long contraction, so
// one CTA per output tile would leave most SMs idle. The contraction is
// split instead: CTA (x, y, z) reduces slice y of I for a BL x BR output
// tile into its own slot of a partial buffer, and a second small kernel sums
// the slots in slice order. No atomics, so the result is the same bit for
// bit on every run. Operands are read through their strides, so the
// transposed views the sweep passes (y = Y_(N)^T, u = U_N^T) need no copy;
// each staging loop walks the operand along its unit-stride axis so global
// reads coalesce, and the shared tiles are padded by one column against
// bank conflicts. bf16 operands are widened to f32 on load; accumulation is
// f32 under both precisions.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBL = 64;   // output rows per CTA
constexpr int kBR = 16;   // output columns per CTA
constexpr int kBT = 32;   // contraction step staged in shared memory
constexpr int kThreads = 256;  // = kBL * kBR / 4: four outputs per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ttm_partial_kernel(const T* __restrict__ y, long long sy0, long long sy1,
                       const T* __restrict__ u, long long su0, long long su1,
                       float* __restrict__ part, int L, int I, int R, int chunk) {
  __shared__ float ys[kBT][kBL + 1];
  __shared__ float us[kBT][kBR + 1];
  const int l0 = blockIdx.x * kBL, r0 = blockIdx.z * kBR;
  const int tid = threadIdx.x;
  const int l = tid % kBL, rq = (tid / kBL) * 4;
  const long long t_begin = (long long)blockIdx.y * chunk;
  const long long t_end = min((long long)I, t_begin + chunk);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (long long tb = t_begin; tb < t_end; tb += kBT) {
    const int nt = (int)min((long long)kBT, t_end - tb);
    for (int e = tid; e < kBT * kBL; e += kThreads) {
      int tt, ll;
      if (sy0 <= sy1) { ll = e % kBL; tt = e / kBL; } else { tt = e % kBT; ll = e / kBT; }
      float val = 0.f;
      if (tt < nt && l0 + ll < L) val = to_f32(y[(l0 + ll) * sy0 + (tb + tt) * sy1]);
      ys[tt][ll] = val;
    }
    for (int e = tid; e < kBT * kBR; e += kThreads) {
      int tt, rr;
      if (su0 <= su1) { rr = e % kBR; tt = e / kBR; } else { tt = e % kBT; rr = e / kBT; }
      float val = 0.f;
      if (tt < nt && r0 + rr < R) val = to_f32(u[(r0 + rr) * su0 + (tb + tt) * su1]);
      us[tt][rr] = val;
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float yv = ys[tt][l];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = fmaf(yv, us[tt][rq + q], acc[q]);
    }
    __syncthreads();
  }
  if (l0 + l < L) {
    float* p = part + ((long long)blockIdx.y * L + l0 + l) * R;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (r0 + rq + q < R) p[r0 + rq + q] = acc[q];
  }
}

__global__ void ttm_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  int n_chunks, long long lr) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= lr) return;
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) s += part[c * lr + idx];
  out[idx] = s;
}

}  // namespace

// out (L, R) f32 contiguous = y (L, I) @ u (R, I)^T, y and u read through
// their element strides, f32 (bf16 = 0) or bf16 (bf16 = 1). part is an
// (n_chunks, L, R) f32 scratch buffer; slice c covers contraction indices
// [c*chunk, min(I, (c+1)*chunk)). Returns cudaGetLastError() after the two
// launches.
extern "C" int ttm_launch(const void* y, long long sy0, long long sy1, const void* u,
                          long long su0, long long su1, void* part, void* out, int L, int I,
                          int R, int chunk, int n_chunks, int bf16, void* stream) {
  if (L < 1 || I < 1 || R < 1 || chunk < 1 || n_chunks < 1 || n_chunks > 65535 ||
      (long long)(n_chunks - 1) * chunk >= I)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((L + kBL - 1) / kBL, n_chunks, (R + kBR - 1) / kBR);
  float* pp = static_cast<float*>(part);
  if (bf16) {
    ttm_partial_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(y), sy0, sy1, static_cast<const __nv_bfloat16*>(u),
        su0, su1, pp, L, I, R, chunk);
  } else {
    ttm_partial_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(y), sy0, sy1, static_cast<const float*>(u), su0, su1, pp, L,
        I, R, chunk);
  }
  const long long lr = (long long)L * R;
  ttm_reduce_kernel<<<(unsigned)((lr + 255) / 256), 256, 0, st>>>(pp, static_cast<float*>(out),
                                                                  n_chunks, lr);
  return (int)cudaGetLastError();
}
