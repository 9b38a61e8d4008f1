// Mamba-2 SSD within-chunk block and chunk state, for sm_90a.
//
// Replaces: src/repro/kernels/ssd_scan.py :: ssd_chunk_pallas (_ssd_kernel),
// the TPU kernel that, per (batch*head, chunk) of length L, builds the
// (L, L) masked decay in VMEM and computes
//   y = ((C B^T) * exp(A_i - A_j) [i >= j]) X      (L, P)
//   S = (B * exp(A_{L-1} - A))^T X                 (N, P)
// in f32, never writing the (L, L) tile to HBM. B and C may come in as bf16
// (the TPU kernel widens its operands to f32 inside) or f32; x, A and both
// outputs are f32.
//
// What bounds it on this card: operations. On the serving path of
// Zamba2-2.7B (BH 320, C 16, L 256, N = P 64) one call moves ~1.1 GB with
// bf16 B and C (0.33 ms at 3.35 TB/s; 1.43 GB in f32) and does ~5.4e10 f32
// operations on and below the diagonal (0.81 ms on the f32 CUDA cores).
//
// Why the CUDA cores and not the tensor cores (yet). Every sum here is a
// chain of f32 FMAs in the order of the plain version's matrix products (n
// ascending for the scores, keys ascending for y and S). At the Zamba2-2.7B
// serving shape the f32 GEMMs that cuBLAS picks for the plain version sum
// in that order too, so there the kernel gives the plain version's bits
// (chip_smoke.py phase 9 checks it); at other shapes cuBLAS may block its
// sums otherwise and the two differ in their last bits. Zamba2-2.7B with
// random weights carries a one-ulp change of y or S through 54 layers into
// the logits, to about the 5% of max|logit| that phase 9's logit gate
// allows (`chip_smoke.py --logit-sensitivity` measures it); a tensor-core
// version (mma.sync, 3xTF32), within the fp32 gate of its plain version,
// moved the logits past that gate. A tensor-core kernel 7 waits on a logit
// gate that a correctly rounded kernel passes.
//
// Design. One CTA of 256 threads per (bh, chunk), at most 85 registers a
// thread so that three fit an SM. The rows are walked in tiles of 64; for
// each row tile the key tiles on and below it are walked in order, and the
// 64 x 64 score tile is built in registers (thread (ty, tx) owns rows
// 4ty..4ty+3 and keys 4tx..4tx+3, with C and B staged transposed in shared
// memory for 16-byte loads), scaled by exp(A_i - A_j) where i >= j
// and set to 0 elsewhere (exp is not taken above the diagonal, where it can
// overflow to inf and inf * 0 would be NaN), passed through shared memory
// and multiplied into the thread's (4, P/16) slice of y. The tiles above the
// diagonal are skipped: they are all zero. The last row tile's walk visits
// every key tile, so the chunk state is accumulated there from the B and X
// tiles already staged (no second pass over the chunk). B and C are widened
// from bf16 as they are staged. Nothing of the (L, L) tile reaches device
// memory. All arithmetic is f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;         // rows (and keys) per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLd = 68;        // row stride of the transposed tiles: 16-byte aligned

size_t smem_bytes(int L, int N, int P) {
  return sizeof(float) * ((size_t)2 * N * kLd + (size_t)kT * kLd + (size_t)kT * P + kT + L);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// TBC: the type of B and C (float or bf16, widened exactly as they are
// staged). NC, PC: 16-wide groups of N and P owned per thread (N <= 16 NC,
// P <= 16 PC)
template <typename TBC, int NC, int PC>
__global__ void __launch_bounds__(kThreads, 3)
    ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ acum,
                     const TBC* __restrict__ bm, const TBC* __restrict__ cm,
                     float* __restrict__ y, float* __restrict__ st, int L, int N, int P) {
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;           // [N][kLd]: C rows of the row tile, transposed
  float* bs = cs + N * kLd;   // [N][kLd]: B rows of the key tile, transposed
  float* gs = bs + N * kLd;   // [kT][kLd]: the masked score tile, transposed
  float* xs = gs + kT * kLd;  // [kT][P]: X rows of the key tile
  float* ws = xs + kT * P;    // [kT]: exp(A_{L-1} - A_j) of the key tile (state)
  float* acs = ws + kT;       // [L]: cumulative log decays of the chunk

  const long long blk = blockIdx.x;
  const float* xg = x + blk * L * P;
  const TBC* bg = bm + blk * L * N;
  const TBC* cg = cm + blk * L * N;
  float* yg = y + blk * L * P;
  float* sg = st + blk * N * P;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int i = tid; i < L; i += kThreads) acs[i] = acum[blk * L + i];

  // chunk state: thread (ty, tx) owns S[ty + 16a][tx + 16c]
  float sacc[NC][PC];
#pragma unroll
  for (int a = 0; a < NC; ++a)
#pragma unroll
    for (int c = 0; c < PC; ++c) sacc[a][c] = 0.f;
  __syncthreads();  // acs is loaded
  const float a_last = acs[L - 1];

  const int nt = (L + kT - 1) / kT;
  for (int it = 0; it < nt; ++it) {
    const int i0 = it * kT;
    const bool last = it == nt - 1;  // its walk visits every key tile
    __syncthreads();  // the last row tile's reads of cs are done
    for (int e = tid; e < kT * N; e += kThreads) {
      const int i = e / N, n = e % N;
      cs[n * kLd + i] = i0 + i < L ? to_f32(cg[(long long)(i0 + i) * N + n]) : 0.f;
    }
    float acc[4][PC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < PC; ++c) acc[r][c] = 0.f;

    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kT;
      __syncthreads();  // the last key tile's reads of bs, xs and gs are done
      for (int e = tid; e < kT * N; e += kThreads) {
        const int j = e / N, n = e % N;
        bs[n * kLd + j] = j0 + j < L ? to_f32(bg[(long long)(j0 + j) * N + n]) : 0.f;
      }
      if (last && tid < kT) ws[tid] = j0 + tid < L ? expf(a_last - acs[j0 + tid]) : 0.f;
      for (int e = tid; e < kT * P; e += kThreads) {
        const int j = e / P, p = e % P;
        xs[j * P + p] = j0 + j < L ? xg[(long long)(j0 + j) * P + p] : 0.f;
      }
      __syncthreads();

      float g[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) g[r][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float4 a = *reinterpret_cast<const float4*>(&cs[n * kLd + ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&bs[n * kLd + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) g[r][c] = fmaf(av[r], bv[c], g[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + tx * 4 + c;
          g[r][c] = (i >= j && i < L) ? g[r][c] * expf(acs[i] - acs[j]) : 0.f;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<float4*>(&gs[(tx * 4 + c) * kLd + ty * 4]) =
            make_float4(g[0][c], g[1][c], g[2][c], g[3][c]);
      __syncthreads();

      const int nj = min(kT, L - j0);
      for (int j = 0; j < nj; ++j) {
        const float4 gv4 = *reinterpret_cast<const float4*>(&gs[j * kLd + ty * 4]);
        const float gv[4] = {gv4.x, gv4.y, gv4.z, gv4.w};
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          const int p = tx + 16 * c;
          const float xv = p < P ? xs[j * P + p] : 0.f;
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(gv[r], xv, acc[r][c]);
        }
      }
      if (last) {  // S += (B * exp(A_{L-1} - A))^T X over this key tile, keys in order
        for (int j = 0; j < nj; ++j) {
          float xv[PC];
#pragma unroll
          for (int c = 0; c < PC; ++c) {
            const int p = tx + 16 * c;
            xv[c] = p < P ? xs[j * P + p] : 0.f;
          }
#pragma unroll
          for (int a = 0; a < NC; ++a) {
            const int n = ty + 16 * a;
            const float bv = n < N ? bs[n * kLd + j] * ws[j] : 0.f;
#pragma unroll
            for (int c = 0; c < PC; ++c) sacc[a][c] = fmaf(bv, xv[c], sacc[a][c]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
      if (i >= L) continue;
#pragma unroll
      for (int c = 0; c < PC; ++c) {
        const int p = tx + 16 * c;
        if (p < P) yg[(long long)i * P + p] = acc[r][c];
      }
    }
  }

#pragma unroll
  for (int a = 0; a < NC; ++a) {
    const int n = ty + 16 * a;
    if (n >= N) continue;
#pragma unroll
    for (int c = 0; c < PC; ++c) {
      const int p = tx + 16 * c;
      if (p < P) sg[(long long)n * P + p] = sacc[a][c];
    }
  }
}

template <typename TBC, int NC, int PC>
int launch(const float* x, const float* a, const void* b, const void* c, float* y, float* s,
           long long n_blocks, int L, int N, int P, cudaStream_t st) {
  auto kernel = ssd_chunk_kernel<TBC, NC, PC>;
  const size_t smem = smem_bytes(L, N, P);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)n_blocks, kThreads, smem, st>>>(x, a, static_cast<const TBC*>(b),
                                                     static_cast<const TBC*>(c), y, s, L, N, P);
  return (int)cudaGetLastError();
}

// 16-wide groups rounded up to a power of two: 1, 2, 4 or 8
int groups(int width) {
  int g = 1;
  while (16 * g < width) g *= 2;
  return g;
}

template <typename TBC, int NC>
int dispatch_p(const float* x, const float* a, const void* b, const void* c, float* y,
               float* s, long long n_blocks, int L, int N, int P, cudaStream_t st) {
  switch (groups(P)) {
    case 1: return launch<TBC, NC, 1>(x, a, b, c, y, s, n_blocks, L, N, P, st);
    case 2: return launch<TBC, NC, 2>(x, a, b, c, y, s, n_blocks, L, N, P, st);
    case 4: return launch<TBC, NC, 4>(x, a, b, c, y, s, n_blocks, L, N, P, st);
    case 8: return launch<TBC, NC, 8>(x, a, b, c, y, s, n_blocks, L, N, P, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename TBC>
int dispatch(const float* x, const float* a, const void* b, const void* c, float* y, float* s,
             long long n_blocks, int L, int N, int P, cudaStream_t st) {
  switch (groups(N)) {
    case 1: return dispatch_p<TBC, 1>(x, a, b, c, y, s, n_blocks, L, N, P, st);
    case 2: return dispatch_p<TBC, 2>(x, a, b, c, y, s, n_blocks, L, N, P, st);
    case 4: return dispatch_p<TBC, 4>(x, a, b, c, y, s, n_blocks, L, N, P, st);
    case 8: return dispatch_p<TBC, 8>(x, a, b, c, y, s, n_blocks, L, N, P, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// y (n_blocks, L, P) and s (n_blocks, N, P) f32, from x (n_blocks, L, P) and
// a_cumsum (n_blocks, L) f32 and b, c (n_blocks, L, N), f32 (bc_bf16 = 0) or
// bf16 (bc_bf16 = 1), all contiguous; n_blocks = BH * C chunks. Returns
// cudaGetLastError() after the launch.
extern "C" int ssd_chunk_launch(const void* x, const void* a, const void* b, const void* c,
                                void* y, void* s, long long n_blocks, int L, int N, int P,
                                int bc_bf16, void* stream) {
  if (n_blocks < 1 || n_blocks > 0x7fffffffLL || L < 1 || L > 1024 || N < 1 || N > 128 ||
      P < 1 || P > 128)
    return (int)cudaErrorInvalidValue;
  const float *xp = static_cast<const float*>(x), *ap = static_cast<const float*>(a);
  float *yp = static_cast<float*>(y), *sp = static_cast<float*>(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bc_bf16) return dispatch<__nv_bfloat16>(xp, ap, b, c, yp, sp, n_blocks, L, N, P, st);
  return dispatch<float>(xp, ap, b, c, yp, sp, n_blocks, L, N, P, st);
}
